// Sorted, optionally weighted segment sum for Hopper (sm_90a), plain C
// interface.
//
// K5 segment_sum computes, for data: [E, D] float32 and ids sorted ascending,
//   out[s] = sum over rows e with seg[e] == s of w[e] * data[e]     (s < n)
// with w optional (absent: 1).  Segments that receive no row are 0; rows whose
// id lies outside [0, n) contribute nothing (the 2**30 sentinel of padded
// edges).  The wrapper turns the sorted ids into row ranges ptr[s]..ptr[s+1]
// (a binary search on the card), so the kernel sees only the ranges.
// It replaces the TPU kernel and its epilogue
//   src/repro/kernels/segment/kernel.py : segment_sum_tiles (stage 1)
//   src/repro/kernels/segment/ops.py    : segment_sum_sorted (stage 2)
// whose one-hot matmul exists because the TPU has no scatter; it is not
// carried over.
//
// What bounds it on an H100: the bytes of data.  Each row is read once and
// takes one multiply-add per element, far below the card's flop/byte
// balance.  For GIN at the ogb_products cell (E=61,859,328, D=64) a layer's
// messages are 15.8 GB: about 5 ms at 3.35 TB/s.
//
// What the design does about it (K3's made D wide): one warp owns one
// segment, its lanes over D (D=64: two column groups of 32), and walks the
// segment's rows in order, so each row is read as coalesced 128-byte lines,
// no two warps write the same output and no atomics are needed: relaunches
// are bit-identical.  The product is rounded before the add (__fmul_rn,
// __fadd_rn), as the reference multiplies the messages by the mask first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int64_t* __restrict__ ptr, const float* __restrict__ data,
                   const float* __restrict__ w, float* __restrict__ out, int64_t n, int d) {
  const int64_t s = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= n) return;
  const int64_t lo = __ldg(ptr + s), hi = __ldg(ptr + s + 1);
  for (int c = lane; c < d; c += 32) {
    float acc = 0.0f;
    if (w != nullptr) {
#pragma unroll 4
      for (int64_t e = lo; e < hi; ++e)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(w + e), __ldg(data + e * d + c)));
    } else {
#pragma unroll 4
      for (int64_t e = lo; e < hi; ++e) acc = __fadd_rn(acc, __ldg(data + e * d + c));
    }
    out[s * d + c] = acc;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// ptr: [n + 1] int64 row ranges over the sorted rows; data: [E, d] float32;
// w: [E] float32 or null; out: [n, d] float32.
int segment_sum(const void* ptr, const void* data, const void* w, void* out, int64_t n, int d,
                void* stream) {
  if (n == 0 || d == 0) return cudaSuccess;
  const int64_t grid = (n + kWarps - 1) / kWarps;
  segment_sum_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)ptr, (const float*)data, (const float*)w, (float*)out, n, d);
  return cudaGetLastError();
}

}  // extern "C"
