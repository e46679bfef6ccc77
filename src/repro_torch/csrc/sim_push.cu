// Deterministic float64 push of the K-PID simulator for Hopper (sm_90a),
// plain C interface: two kernels, the messages and their sum, each one
// cooperative launch (a persistent grid with grid-wide barriers between its
// phases), so a push costs the host two launches.
//
// K7 sim_messages expands a diffusion's nodes into its messages: for the
// e-th out-edge (in node order, then CSR order) of node sel[i], pushed by PID
// pid[i], the message msg[e] = sent[i] * w (rounded once, __dmul_rn: the
// reference computes the product first and sums it after), its key (the
// destination d when PID pid[i] owns d, else PID pid[i]'s outbox entry
// N + 1 + pid[i]*N + d) and rabs[e] = |msg[e]| for a remote message, 0 for a
// local one.  It replaces the reference's np.repeat and product
// (src/repro/core/simulator.py, _diffuse_batch, lines 295-302).
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
// What bounds both on an H100: latency, then bytes.  sim_push must read 12
// bytes a message and read and write 16 a distinct key; sim_messages reads an
// edge (8-byte destination, 8-byte weight, 4-byte owner) and writes 20 bytes a
// message.  The pushes are small (a few to some million messages, most of them
// thousands), the reads random, and the host issues every launch.
//
// What the design does about it.
// sim_messages, phases split by grid barriers: (1) each CTA reads the
// out-degrees of its slice of the nodes (kept for phase 2) and sums them;
// (2) each scans its slice into the messages' exclusive prefix `base`, after
// the sums of the CTAs before it, and notes the node of each tile's first
// message (`tile_node`); (3) the messages in tiles of kTile: the CTA stages
// the tile's nodes' prefix and first CSR row in shared memory (up to kStage
// nodes), each thread finds each of its kTile / kThreads messages' node by a
// binary search there and issues their loads together, reading each edge
// along its node's CSR range (neighbouring threads, neighbouring edges).
// Every output is written once, so the bits do not depend on the launch.
// sim_push, ordered buckets in place of a sort.  Each key has a count (an
// int32 array of its own, 4 bytes a key, so the counts of a push's keys stay
// in L2) and a row of kRow int32 (16 bytes) that keeps the indices of its
// messages of rank 1 to kRow.  (A) each message takes a rank r =
// atomicAdd(&count, 1) and, for 1 <= r <= kRow, leaves its index in the row;
// (B) the message with r == 0 reads its key's count n: when n <= kHeld, all
// the key's message indices are in hand (its own and the row's, read only
// when n > 1): it sorts them ascending in registers (a sorting network), adds
// the messages in that order onto the state (__dadd_rn), stores once and
// resets the count.  Keys of more messages (rare: the longest at the
// simulator's largest push has 8) claim a bucket of slots (warp-wide sums,
// then one atomicAdd a warp on a cursor: where a bucket lands does not
// matter), fill its first kHeld slots and leave the list index in the count;
// (C) their other messages write their indices into the bucket at slot r;
// (D) each kChunk-slot chunk of a bucket is put in message order, each entry
// placed by counting the smaller indices of its chunk; (M) a bucket longer
// than kChunk is merge-sorted from there: runs of 32, 64, ... merged in
// passes split by grid barriers, each entry placed by a binary search of the
// run it merges with (log2(longest / 32) passes: m log m work for a bucket of
// m); (E) one warp a bucket adds its messages in that order, its lanes
// loading kAhead chunks of 32 ahead of the adds.  The integer atomics decide
// only where an index is stored, never the order of a float add, and every
// add is __dadd_rn in message order: the bits are np.add.at's and do not
// depend on the launch.  Every push leaves each count zero.  A key's adds are
// one dependent chain, as np.add.at's are: a hub of m messages costs at least
// m float64 add latencies.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Hooks for tools/k7_probe.py's `phases` build, which defines them to time
// each phase; empty in the library.
#ifndef K7_START
#define K7_START(slot)
#define K7_STAMP
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 4;
constexpr int kMaxCtas = 4096;  // bound on any card's grid: sim_messages' partials
constexpr int kMaxDevices = 64;
constexpr int kRow = 4;     // a key's row: the indices of its messages of rank 1..kRow
constexpr int kHeld = kRow + 1;  // the most messages a key settles in phase B with
constexpr int kUnroll = 4;  // messages a thread has in flight in phases A and B
constexpr int kChunk = 32;      // a bucket's entries put in order by counting
constexpr int kAhead = 8;       // chunks of 32 messages a warp loads ahead of its adds
constexpr int kTile = 1024;     // messages a CTA expands at a time
constexpr int kPerThread = kTile / kThreads;
constexpr int kStage = 2048;    // nodes of a tile staged in shared memory
// sim_push's scratch counters: buckets, their slots, the longest bucket
constexpr int kKeys = 0, kSlots = 1, kLongest = 2, kCounters = 3;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v, to every thread; red: kWarps entries of shared memory.
__device__ int64_t block_sum(int64_t v, int64_t* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// The exclusive prefix of v in thread order; *total: the block's sum.
__device__ int64_t block_exclusive(int64_t v, int64_t* red, int64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int64_t before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? red[w] : 0;
    all += red[w];
  }
  *total = all;
  return before + x - v;
}

// The last i in [lo, hi) with base[i] <= target (base nondecreasing,
// base[lo] <= target), by one thread.
__device__ __forceinline__ int64_t thread_search(const int64_t* base, int64_t lo, int64_t hi,
                                                 int64_t target) {
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) >> 1;
    if (base[mid] <= target) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
sim_messages_kernel(const int64_t* __restrict__ sel, const int64_t* __restrict__ pid,
                    const double* __restrict__ sent, const int64_t* __restrict__ deg,
                    int64_t n_sel, const int64_t* __restrict__ indptr,
                    const int64_t* __restrict__ indices, const double* __restrict__ wgt,
                    const int32_t* __restrict__ owner, int64_t n_nodes,
                    int32_t* __restrict__ key, double* __restrict__ msg,
                    double* __restrict__ rabs, int64_t n, int64_t* base, int64_t* partial,
                    int64_t* tile_node) {
  __shared__ int64_t s_base[kStage];   // a tile's nodes: first message
  __shared__ int64_t s_first[kStage];  //                 CSR row of message 0
  __shared__ int64_t red[kWarps];
  const cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int64_t n_ctas = gridDim.x, cta = blockIdx.x;
  K7_START(8);

  // (1) each CTA's slice of the nodes: their out-degrees, kept, and their sum
  const int64_t chunk = (n_sel + n_ctas - 1) / n_ctas;
  const int64_t a = min64(cta * chunk, n_sel), z = min64(a + chunk, n_sel);
  int64_t v = 0;
  for (int64_t i0 = a + tid; i0 < z; i0 += kPerThread * kThreads) {
    int64_t s[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int64_t i = i0 + u * kThreads;
      s[u] = i < z ? __ldg(sel + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < z) {
        const int64_t d = __ldg(deg + s[u]);
        base[i] = d;
        v += d;
      }
    }
  }
  v = block_sum(v, red);
  if (tid == 0) partial[cta] = v;
  grid.sync();
  K7_STAMP;

  // (2) the slice's exclusive prefix, after the CTAs before it, and the node
  // of each tile's first message
  v = 0;
  for (int64_t u = tid; u < cta; u += kThreads) v += partial[u];
  int64_t run = block_sum(v, red);
  for (int64_t i0 = a; i0 < z; i0 += kThreads) {
    const int64_t i = i0 + tid;
    const int64_t d = i < z ? base[i] : 0;
    int64_t total;
    const int64_t b = run + block_exclusive(d, red, &total);
    if (i < z) {
      base[i] = b;
      const int64_t end = min64(b + d, n);  // n: the messages the caller counted
      for (int64_t t = (b + kTile - 1) / kTile; t * kTile < end; ++t) tile_node[t] = i;
    }
    run += total;
  }
  if (cta == n_ctas - 1 && tid == 0) base[n_sel] = run;
  grid.sync();
  K7_STAMP;

  // (3) the messages, a tile at a time
  const int64_t lim = min64(n, base[n_sel]);
  const int64_t n_tiles = (lim + kTile - 1) / kTile;
  for (int64_t t = cta; t < n_tiles; t += n_ctas) {
    const int64_t m0 = t * kTile, m1 = min64(m0 + kTile, lim);
    const int64_t lo = tile_node[t];
    const int64_t c = (t + 1 < n_tiles ? tile_node[t + 1] : n_sel - 1) - lo + 1;
    const bool staged = c <= kStage;  // else zero-degree nodes crowd the tile
    if (staged) {
      for (int64_t u0 = tid; u0 < c; u0 += kPerThread * kThreads) {
        int64_t row[kPerThread];
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          const int64_t u = u0 + q * kThreads;
          row[q] = u < c ? __ldg(sel + lo + u) : 0;
        }
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          const int64_t u = u0 + q * kThreads;
          if (u >= c) continue;
          const int64_t b = base[lo + u];
          s_base[u] = b;
          s_first[u] = __ldg(indptr + row[q]) - b;
        }
      }
    }
    __syncthreads();
    int64_t node[kPerThread], edge[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int64_t m = m0 + tid + u * kThreads;
      node[u] = lo;
      edge[u] = 0;
      if (m >= m1) continue;
      if (staged) {
        const int64_t w = thread_search(s_base, 0, c, m);
        node[u] = lo + w;
        edge[u] = s_first[w] + m;
      } else {
        node[u] = thread_search(base, lo, lo + c, m);
        edge[u] = __ldg(indptr + __ldg(sel + node[u])) - base[node[u]] + m;
      }
    }
    int64_t dst[kPerThread], p[kPerThread];
    double val[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      if (m0 + tid + u * kThreads >= m1) continue;
      dst[u] = __ldg(indices + edge[u]);
      p[u] = __ldg(pid + node[u]);
      val[u] = __dmul_rn(__ldg(sent + node[u]), __ldg(wgt + edge[u]));
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int64_t m = m0 + tid + u * kThreads;
      if (m >= m1) continue;
      const bool local = __ldg(owner + dst[u]) == p[u];
      key[m] = (int32_t)(local ? dst[u] : dst[u] + n_nodes + 1 + p[u] * n_nodes);
      msg[m] = val[u];
      rabs[m] = local ? 0.0 : fabs(val[u]);
    }
    __syncthreads();  // the stage is rewritten by the next tile
  }
}

// Sorts x ascending (odd-even transposition, in registers).
template <int N>
__device__ __forceinline__ void sort_net(int32_t (&x)[N]) {
#pragma unroll
  for (int round = 0; round < N; ++round) {
#pragma unroll
    for (int u = round & 1; u + 1 < N; u += 2) {
      const int32_t lo = min(x[u], x[u + 1]), hi = max(x[u], x[u + 1]);
      x[u] = lo;
      x[u + 1] = hi;
    }
  }
}

// The number of entries of a[lo, hi) below y (a ascending, entries distinct).
__device__ __forceinline__ int32_t count_below(const int32_t* a, int32_t lo, int32_t hi,
                                               int32_t y) {
  const int32_t lo0 = lo;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (a[mid] < y) lo = mid + 1; else hi = mid;
  }
  return lo - lo0;
}

// Arrays written by this kernel are read with plain loads (never __ldg): the
// grid barriers order them, the read-only path would not.
__global__ void __launch_bounds__(kThreads)
sim_push_kernel(const int32_t* __restrict__ key, const double* __restrict__ msg, double* state,
                int64_t n_state, int32_t e, int32_t* count, int32_t* rows, int32_t* ctr,
                int32_t* rank, int32_t* slot, int32_t* ordered, int4* list) {
  const cg::grid_group grid = cg::this_grid();
  const int32_t t0 = blockIdx.x * kThreads + threadIdx.x;
  const int32_t stride = gridDim.x * kThreads;
  const int32_t lane = threadIdx.x & 31;
  __shared__ double chunk_stage[kWarps][32];  // phase E: a warp's chunk
  K7_START(0);

  // (A) ranks; the indices of ranks 1..kRow into the key's row
  if (t0 < kCounters) ctr[t0] = 0;
  for (int32_t i0 = t0; i0 < e; i0 += kUnroll * stride) {
    int32_t d[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t i = i0 + u * stride;
      d[u] = i < e ? __ldg(key + i) : 0;
      if (d[u] < 0 || d[u] >= n_state) __trap();  // a key outside the state
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * stride < e) r[u] = atomicAdd(count + d[u], 1);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t i = i0 + u * stride;
      if (i >= e) continue;
      rank[i] = r[u];
      if (r[u] >= 1 && r[u] <= kRow) rows[(int64_t)d[u] * kRow + r[u] - 1] = i;
    }
  }
  grid.sync();
  K7_STAMP;

  // (B) each key settled by its first-ranked message when its row holds all
  // its messages; the others claim buckets: a warp's claims of list entries
  // and slots are one atomicAdd a cursor (warp-wide sums place each lane's)
  const unsigned below = (1u << lane) - 1;
  for (int32_t w0 = t0 - lane; w0 < e; w0 += kUnroll * stride) {  // whole warps
    int32_t d[kUnroll], n[kUnroll], x[kUnroll][kHeld];  // x: indices by rank
    double s0[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t i = w0 + u * stride + lane;
      n[u] = i < e ? rank[i] : 1;  // 0 marks a key's first-ranked message
      d[u] = i < e ? __ldg(key + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (n[u] != 0) {
        n[u] = 0;
        continue;
      }
      n[u] = count[d[u]];
      s0[u] = state[d[u]];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (n[u] == 0) continue;
      x[u][0] = w0 + u * stride + lane;
      if (n[u] > 1) {  // a single message needs no row
        const int4* row = (const int4*)(rows + (int64_t)d[u] * kRow);
#pragma unroll
        for (int q = 0; q < kRow / 4; ++q) {
          const int4 v = row[q];
          x[u][4 * q + 1] = v.x;
          x[u][4 * q + 2] = v.y;
          x[u][4 * q + 3] = v.z;
          x[u][4 * q + 4] = v.w;
        }
      }
      if (n[u] > kHeld) continue;  // a bucket, below
      // all the key's messages in hand: add them in order
#pragma unroll
      for (int q = 1; q < kHeld; ++q) x[u][q] = q < n[u] ? x[u][q] : INT32_MAX;
      sort_net(x[u]);
      double acc = s0[u];
#pragma unroll
      for (int q = 0; q < kHeld; ++q)
        if (q < n[u]) acc = __dadd_rn(acc, __ldg(msg + x[u][q]));
      state[d[u]] = acc;
      count[d[u]] = 0;
      n[u] = 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool open = n[u] > 0;
      const unsigned opening = __ballot_sync(0xffffffffu, open);
      if (opening == 0) continue;
      int32_t slots = open ? n[u] : 0;  // inclusive sum over the lanes
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, slots, o);
        if (lane >= o) slots += y;
      }
      const unsigned most = __reduce_max_sync(0xffffffffu, (unsigned)n[u]);
      int32_t at_key = 0, at_slot = 0;  // the cursors before this warp's claims
      if (lane == 31) {
        at_key = atomicAdd(ctr + kKeys, __popc(opening));
        at_slot = atomicAdd(ctr + kSlots, slots);
        if (most > kChunk) atomicMax(ctr + kLongest, (int32_t)most);
      }
      at_key = __shfl_sync(0xffffffffu, at_key, 31);
      at_slot = __shfl_sync(0xffffffffu, at_slot, 31);
      if (!open) continue;
      const int32_t j = at_key + __popc(opening & below);
      const int32_t off = at_slot + slots - n[u];
      list[j] = make_int4(d[u], off, n[u], 0);
      count[d[u]] = -1 - j;
#pragma unroll
      for (int q = 0; q < kHeld; ++q) slot[off + q] = x[u][q];  // ranks 0..kRow
    }
  }
  grid.sync();
  K7_STAMP;

  // (C) the other messages of those keys into their buckets
  for (int32_t i = t0; i < e; i += stride) {
    const int32_t r = rank[i];
    if (r < kHeld) continue;
    slot[list[-1 - count[__ldg(key + i)]].y + r] = i;
  }
  grid.sync();
  K7_STAMP;

  // (D) each bucket's chunks of kChunk slots in message order (rank, no
  // longer read, now keeps each slot's bucket)
  const int32_t n_slots = ctr[kSlots];
  for (int32_t s = t0; s < n_slots; s += stride) {
    const int32_t y = slot[s];
    const int32_t j = -1 - count[__ldg(key + y)];
    const int4 b = list[j];
    const int32_t c0 = (s - b.y) & ~(kChunk - 1), c1 = min(c0 + kChunk, b.z);
    int32_t r = 0;
    for (int32_t u = c0; u < c1; ++u) r += slot[b.y + u] < y;
    ordered[b.y + c0 + r] = y;
    rank[s] = j;
  }
  grid.sync();
  K7_STAMP;

  // (M) longer buckets merge-sorted: runs of w merged into runs of 2w
  int32_t* src = ordered;
  int32_t* dst = slot;
  const int32_t longest = ctr[kLongest];
  for (int32_t w = kChunk; w < longest; w <<= 1) {
    for (int32_t s = t0; s < n_slots; s += stride) {
      const int4 b = list[rank[s]];
      const int32_t y = src[s], p = s - b.y, pair = p & ~(2 * w - 1);
      const int32_t* run = src + b.y;
      const int32_t at = p - pair < w
          ? p + count_below(run, min(pair + w, b.z), min(pair + 2 * w, b.z), y)
          : p - w + count_below(run, pair, pair + w, y);
      dst[b.y + at] = y;
    }
    int32_t* t = src;
    src = dst;
    dst = t;
    grid.sync();
  }
  K7_STAMP;

  // (E) each bucket summed in message order, a warp each: the lanes load
  // kAhead chunks of 32 ahead of the adds (a ring in registers) and stage
  // each chunk in shared memory, where the loads of the adds' operands do
  // not wait on the adds; so a long bucket's sum waits on its chain of adds
  double* stage = chunk_stage[threadIdx.x >> 5];
  const int32_t n_keys = ctr[kKeys];
  for (int32_t w = t0 >> 5; w < n_keys; w += stride >> 5) {
    const int4 b = list[w];
    double acc = state[b.x];
    double val[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int32_t u = 32 * q + lane;
      val[q] = u < b.z ? __ldg(msg + src[b.y + u]) : 0.0;
    }
    for (int32_t u0 = 0; u0 < b.z; u0 += 32 * kAhead) {
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int32_t c = u0 + 32 * q;  // this chunk's first entry
        if (c >= b.z) break;
        __syncwarp();  // the last chunk's adds have read the stage
        stage[lane] = val[q];
        __syncwarp();
        const int32_t u = c + 32 * kAhead + lane;
        val[q] = u < b.z ? __ldg(msg + src[b.y + u]) : 0.0;
        if (b.z - c >= 32) {
#pragma unroll
          for (int l = 0; l < 32; ++l) acc = __dadd_rn(acc, stage[l]);
        } else {
          for (int32_t l = 0; l < b.z - c; ++l) acc = __dadd_rn(acc, stage[l]);
        }
      }
    }
    if (lane == 0) {
      state[b.x] = acc;
      count[b.x] = 0;
    }
  }
}

// CTAs of a cooperative launch of `kernel` for `work` CTAs' worth of work:
// at most kCtasPerSm an SM, all resident at once.  The card's capacity is
// asked once a kernel and device (`cache`), not on every launch.
template <typename Kernel>
cudaError_t cooperative_grid(Kernel kernel, int* cache, int64_t work, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    const int64_t ctas = (int64_t)(per_sm < kCtasPerSm ? per_sm : kCtasPerSm) * n_sm;
    cache[dev] = (int)(ctas < kMaxCtas ? ctas : kMaxCtas);
  }
  *grid = (int)(work < 1 ? 1 : work < cache[dev] ? work : cache[dev]);
  return cudaSuccess;
}

int push_ctas[kMaxDevices], messages_ctas[kMaxDevices];

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// int32 entries of sim_push's rows for a state of n_state entries: kRow a
// key, the indices of its messages of rank 1..kRow.
int64_t sim_push_rows(int64_t n_state) { return kRow * n_state; }

// int32 entries of sim_push's scratch for e messages: the bucket list
// (16-byte entries, first; a bucket holds more than kHeld messages), the
// counters, then a rank, a bucket slot and an ordered slot a message.
int64_t sim_push_scratch(int64_t e) { return 4 * (e / (kHeld + 1) + 1) + kCounters + 3 * e; }

// int64 entries of sim_messages' scratch for n_sel nodes and n messages: the
// prefix, one partial a CTA, the first node of each tile.
int64_t sim_messages_scratch(int64_t n_sel, int64_t n) {
  return n_sel + 1 + kMaxCtas + n / kTile + 2;
}

// key: [e] int32 in [0, n_state); msg: [e] float64; state: [n_state]
// float64, updated in place; count: [n_state] int32, all zero, left so;
// rows: sim_push_rows(n_state) int32, any values; scratch:
// sim_push_scratch(e) int32; rows and scratch 16-byte aligned.
int sim_push(const void* key, const void* msg, void* state, int64_t n_state, int64_t e,
             void* count, void* rows, void* scratch, void* stream) {
  if (e == 0) return cudaSuccess;
  if (e >= (int64_t)1 << 30) return cudaErrorInvalidValue;  // int32 slots
  int grid = 0;
  cudaError_t err =
      cooperative_grid(sim_push_kernel, push_ctas, (e + kThreads - 1) / kThreads, &grid);
  if (err != cudaSuccess) return err;
  int32_t e32 = (int32_t)e;
  int4* list = (int4*)scratch;
  int32_t* ctr = (int32_t*)scratch + 4 * (e / (kHeld + 1) + 1);
  int32_t* rank = ctr + kCounters;
  int32_t* slot = rank + e;
  int32_t* ordered = slot + e;
  const int32_t* k = (const int32_t*)key;
  const double* m = (const double*)msg;
  double* s = (double*)state;
  int32_t* c = (int32_t*)count;
  int32_t* r = (int32_t*)rows;
  void* args[] = {&k, &m, &s, &n_state, &e32, &c, &r, &ctr, &rank, &slot, &ordered, &list};
  err = cudaLaunchCooperativeKernel((const void*)sim_push_kernel, grid, kThreads, args, 0,
                                    (cudaStream_t)stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// sel, pid, sent: [n_sel] the diffusing nodes, each one's PID and fluid;
// deg: [n_nodes] out-degrees; indptr, indices, wgt: the CSR (int64, int64,
// float64); owner: [n_nodes] int32; key, msg, rabs: [n] outputs (int32,
// float64, float64), n the sum of deg[sel]; scratch:
// sim_messages_scratch(n_sel, n) int64.
int sim_messages(const void* sel, const void* pid, const void* sent, const void* deg,
                 int64_t n_sel, const void* indptr, const void* indices, const void* wgt,
                 const void* owner, int64_t n_nodes, void* key, void* msg, void* rabs,
                 int64_t n, void* scratch, void* stream) {
  if (n == 0) return cudaSuccess;
  const int64_t work = (n > n_sel ? n : n_sel) / kTile + 1;
  int grid = 0;
  cudaError_t err = cooperative_grid(sim_messages_kernel, messages_ctas, work, &grid);
  if (err != cudaSuccess) return err;
  const int64_t* a_sel = (const int64_t*)sel;
  const int64_t* a_pid = (const int64_t*)pid;
  const double* a_sent = (const double*)sent;
  const int64_t* a_deg = (const int64_t*)deg;
  const int64_t* a_indptr = (const int64_t*)indptr;
  const int64_t* a_indices = (const int64_t*)indices;
  const double* a_wgt = (const double*)wgt;
  const int32_t* a_owner = (const int32_t*)owner;
  int32_t* a_key = (int32_t*)key;
  double* a_msg = (double*)msg;
  double* a_rabs = (double*)rabs;
  int64_t* base = (int64_t*)scratch;
  int64_t* partial = base + n_sel + 1;
  int64_t* tile_node = partial + kMaxCtas;
  void* args[] = {&a_sel, &a_pid, &a_sent, &a_deg, &n_sel, &a_indptr, &a_indices, &a_wgt,
                  &a_owner, &n_nodes, &a_key, &a_msg, &a_rabs, &n, &base, &partial,
                  &tile_node};
  err = cudaLaunchCooperativeKernel((const void*)sim_messages_kernel, grid, kThreads, args, 0,
                                    (cudaStream_t)stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
