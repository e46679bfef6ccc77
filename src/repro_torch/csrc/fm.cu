// Factorization-machine pairwise term for Hopper (sm_90a), plain C interface.
//
// K4 fm_interaction computes, for v: [B, F, D] float32,
//   y[b] = 0.5 * sum_d [ (sum_f v[b,f,d])^2 - sum_f v[b,f,d]^2 ]
// (Rendle's O(F.D) sum-square trick).  It replaces the TPU kernel
//   src/repro/kernels/fm/kernel.py : fm_interaction_pallas (_kernel)
// which reduces a tile of 256 samples per grid step in VMEM.
//
// What bounds it on an H100: the bytes of v.  Each element is read once and
// takes three flops (an add, a multiply and an add), far below the card's
// flop/byte balance, so only HBM matters: at the serve_bulk cell
// (B=262,144, F=39, D=10) that is 409 MB, about 0.12 ms at 3.35 TB/s.
//
// What the design does about it: one warp owns one sample, its lanes over D
// (D > 32 loops over column groups of 32), so no padding of B to a tile is
// needed and every warp works on its own contiguous F.D block.  Each lane sums
// its column over f in the fixed order 0..F-1, rounding the square before the
// add (__fmul_rn, __fadd_rn); the per-column terms are reduced across the
// lanes by a fixed shuffle tree.  No atomics: relaunches are bit-identical.
// At D=10 two thirds of each warp's lanes idle; a wider mapping is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fm_interaction_kernel(const float* __restrict__ v, float* __restrict__ out, int64_t b,
                      int f, int d) {
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= b) return;  // i is the same for the whole warp
  const float* vi = v + i * (int64_t)f * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < f; ++k) {
      const float x = __ldg(vi + (int64_t)k * d + c);
      s1 = __fadd_rn(s1, x);
      s2 = __fadd_rn(s2, __fmul_rn(x, x));
    }
    acc = __fadd_rn(acc, __fsub_rn(__fmul_rn(s1, s1), s2));
  }
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (lane == 0) out[i] = __fmul_rn(0.5f, acc);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// v: [b, f, d] float32 contiguous; out: [b] float32.
int fm_interaction(const void* v, void* out, int64_t b, int f, int d, void* stream) {
  if (b == 0) return cudaSuccess;
  const int64_t grid = (b + kWarps - 1) / kWarps;
  fm_interaction_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (float*)out, b, f, d);
  return cudaGetLastError();
}

}  // extern "C"
