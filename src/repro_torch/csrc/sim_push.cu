// Deterministic float64 push of the K-PID simulator for Hopper (sm_90a),
// plain C interface: two kernels, the messages and their sum.
//
// K7 sim_messages expands a diffusion's nodes into its messages: for the
// e-th out-edge (in node order, then CSR order) of node sel[i], pushed by PID
// pid[i], the message msg[e] = sent[i] * w (rounded once, __dmul_rn: the
// reference computes the product first and sums it after), its key (the
// destination d when PID pid[i] owns d, else PID pid[i]'s outbox entry
// N + 1 + pid[i]*N + d) and rabs[e] = |msg[e]| for a remote message, 0 for a
// local one.  It replaces the reference's np.repeat and product
// (src/repro/core/simulator.py, _diffuse_batch, lines 295-302) and the torch
// gathers that would do them in some twenty launches.  One thread per
// message finds its node by a binary search over the exclusive prefix of the
// nodes' out-degrees; every output is written once, so the bits do not
// depend on the launch.
//
// K7 sim_push adds each message msg[e] into state[key[e]], in message order
// for every key.  The simulator keeps the fluid and the K outboxes in one
// float64 buffer (node d's fluid at d, PID k's outbox entry for d at
// N + 1 + k*N + d), so one launch does both scatters of a diffusion, for
// every PID that diffuses in it.  It has no Pallas source: it replaces the numpy
// scatters of the simulator's two schedules in the JAX package
//   src/repro/core/simulator.py : _diffuse_node (np.add.at, lines 274, 279)
//                                 _diffuse_batch (np.add.at, lines 304, 309)
// np.add.at adds into each destination in the order the messages come, and
// torch's index_add_ would scatter with float64 atomics on the card, whose sum
// order changes from run to run: the replay would not be bit-exact, and the
// bits would not be np.add.at's.
//
// What bounds both on an H100: bytes and latency.  sim_push reads its
// messages (a 4-byte key and an 8-byte position in message order, in sorted
// order, and the 8-byte message) and reads and writes one float64 per
// distinct key; one add per 20 bytes.  sim_messages reads an edge (8-byte
// destination, 8-byte weight, 4-byte owner) and writes 20 bytes a message.
// The pushes are small (some thousand to some million messages), so a launch
// is mostly latency; in the simulator's round the host's launches cost more
// than both kernels.
//
// What the design does about it: the wrapper sorts the keys with a stable sort
// on the card, so that the messages of one key form a run that keeps their
// order.  One thread per sorted position; the thread at the head of a run
// loads its target once, adds the run's messages in order with __dadd_rn (no
// contraction, no atomics) and stores it once.  The others return at once.
// No two threads write one address, so every launch gives the same bits:
// np.add.at's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sim_push_kernel(const int32_t* __restrict__ key_sorted, const int64_t* __restrict__ order,
                const double* __restrict__ msg, double* __restrict__ state, int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int32_t d = __ldg(key_sorted + e);
  if (e > 0 && __ldg(key_sorted + e - 1) == d) return;  // not the head of its run
  double acc = state[d];
  for (int64_t j = e; j < n && __ldg(key_sorted + j) == d; ++j)
    acc = __dadd_rn(acc, __ldg(msg + __ldg(order + j)));
  state[d] = acc;
}

__global__ void __launch_bounds__(kThreads)
sim_messages_kernel(const int64_t* __restrict__ sel, const int64_t* __restrict__ pid,
                    const double* __restrict__ sent, const int64_t* __restrict__ base,
                    int64_t n_sel, const int64_t* __restrict__ indptr,
                    const int64_t* __restrict__ indices, const double* __restrict__ wgt,
                    const int32_t* __restrict__ owner, int64_t n_nodes,
                    int32_t* __restrict__ key, double* __restrict__ msg,
                    double* __restrict__ rabs, int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  // the last node whose first message is at or before e: its range holds e
  int64_t lo = 0, hi = n_sel;  // base[lo] <= e < base[hi]
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(base + mid) <= e) lo = mid; else hi = mid;
  }
  const int64_t j = __ldg(indptr + __ldg(sel + lo)) + (e - __ldg(base + lo));
  const int64_t d = __ldg(indices + j);
  const int64_t p = __ldg(pid + lo);
  const double m = __dmul_rn(__ldg(sent + lo), __ldg(wgt + j));
  const bool local = __ldg(owner + d) == p;
  key[e] = (int32_t)(local ? d : d + n_nodes + 1 + p * n_nodes);
  msg[e] = m;
  rabs[e] = local ? 0.0 : fabs(m);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// key_sorted: [n] int32, the keys sorted stably; order: [n] int64, each one's
// position in message order; msg: [n] float64 in message order; state:
// float64, updated in place.
int sim_push(const void* key_sorted, const void* order, const void* msg, void* state,
             int64_t n, void* stream) {
  if (n == 0) return cudaSuccess;
  const int64_t grid = (n + kThreads - 1) / kThreads;
  sim_push_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)key_sorted, (const int64_t*)order, (const double*)msg, (double*)state, n);
  return cudaGetLastError();
}

// sel, pid, sent: [n_sel] the diffusing nodes, each one's PID and fluid;
// base: [n_sel + 1] exclusive prefix of their out-degrees (base[n_sel] = n);
// indptr, indices, wgt: the CSR (int64, int64, float64); owner: [n_nodes]
// int32; key, msg, rabs: [n] outputs (int32, float64, float64).
int sim_messages(const void* sel, const void* pid, const void* sent, const void* base,
                 int64_t n_sel, const void* indptr, const void* indices, const void* wgt,
                 const void* owner, int64_t n_nodes, void* key, void* msg, void* rabs,
                 int64_t n, void* stream) {
  if (n == 0) return cudaSuccess;
  const int64_t grid = (n + kThreads - 1) / kThreads;
  sim_messages_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)sel, (const int64_t*)pid, (const double*)sent, (const int64_t*)base,
      n_sel, (const int64_t*)indptr, (const int64_t*)indices, (const double*)wgt,
      (const int32_t*)owner, n_nodes, (int32_t*)key, (double*)msg, (double*)rabs, n);
  return cudaGetLastError();
}

}  // extern "C"
