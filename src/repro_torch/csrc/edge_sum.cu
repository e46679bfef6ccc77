// Deterministic per-destination edge reduction for Hopper (sm_90a), plain C
// interface.
//
// K3 edge_sum computes out[j] = sum over in-edges e of j of x[src[e]] * wgt[e].
// It has no Pallas source: it replaces the XLA segment_sum of the per-edge
// frontier round and of the warm-start product P.H in the JAX package
//   src/repro/core/diteration.py : frontier_step (jax.ops.segment_sum)
//   src/repro/api/session.py     : _SegmentSumDriver.warm_seed,
//                                  _BsrFrontierDriver.warm_seed
// torch's index_add_ would scatter with atomics on the card, whose float sum
// order changes from run to run; the stream soak's bit-exact replay forbids it.
//
// What bounds it on an H100: the edge bytes.  Each edge is read once (4-byte
// source id + 4-byte weight) plus a 4-byte gather of x[src]; one multiply-add
// per 12 bytes is far below the card's flop/byte balance, so only HBM matters.
//
// What the design does about it: the edges arrive sorted by destination (a CSC
// order built once on the host).  One thread owns one destination and walks its
// in-edges in that fixed order, so every sum runs in the same order on every
// launch and no two threads write the same output: no atomics.  The product is
// rounded before the add (__fmul_rn, __fadd_rn), as the reference computes the
// message first and sums it after.  A warp reads neighbouring destinations'
// edge ranges, which are contiguous in the CSC order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
edge_sum_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ src,
                const float* __restrict__ wgt, const float* __restrict__ x,
                float* __restrict__ out, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int64_t lo = indptr[j], hi = indptr[j + 1];
  float acc = 0.0f;
  for (int64_t e = lo; e < hi; ++e)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(x + __ldg(src + e)), __ldg(wgt + e)));
  out[j] = acc;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// indptr: [n + 1] over the destination-sorted edges; src, wgt: [n_edges];
// x, out: [n].
int edge_sum(const void* indptr, const void* src, const void* wgt, const void* x, void* out,
             int64_t n, void* stream) {
  if (n == 0) return cudaSuccess;
  const int64_t grid = (n + kThreads - 1) / kThreads;
  edge_sum_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int32_t*)src, (const float*)wgt, (const float*)x,
      (float*)out, n);
  return cudaGetLastError();
}

}  // extern "C"
