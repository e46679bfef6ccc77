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
//
// fm_interaction_bwd is K4's backward (training): for dy = dL/dy [B],
//   grad_v[b,f,d] = dy[b] * (sum_g v[b,g,d] - v[b,f,d]).
// The TPU has no kernel for it (XLA differentiates the reference's jnp
// expression, src/repro/models/recsys.py : forward_logits).  What bounds it:
// v read and grad_v written once: at the train_batch cell (B=65,536, F=39,
// D=10) 2 x 102 MB, about 0.061 ms at 3.35 TB/s.  The design is the
// forward's: one warp a sample, its lanes over D; each lane sums its column
// over f in the same fixed order, then writes the column's F gradients
// from a second read of the sample's block (an L1 hit).  Every element is
// written by one lane, so no atomics: relaunches are bit-identical.
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

__global__ void __launch_bounds__(kThreads)
fm_interaction_bwd_kernel(const float* __restrict__ v, const float* __restrict__ dy,
                          float* __restrict__ grad_v, int64_t b, int f, int d) {
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= b) return;
  const int64_t base = i * (int64_t)f * d;
  const float* vi = v + base;
  float* gi = grad_v + base;
  const float g = __ldg(dy + i);
  for (int c = lane; c < d; c += 32) {
    float s1 = 0.0f;
    for (int k = 0; k < f; ++k) s1 = __fadd_rn(s1, __ldg(vi + (int64_t)k * d + c));
    for (int k = 0; k < f; ++k) {
      const int64_t at = (int64_t)k * d + c;
      gi[at] = __fmul_rn(g, __fsub_rn(s1, __ldg(vi + at)));
    }
  }
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

// v: [b, f, d] float32 contiguous; dy: [b] float32; grad_v: [b, f, d] float32.
int fm_interaction_bwd(const void* v, const void* dy, void* grad_v, int64_t b, int f, int d,
                       void* stream) {
  if (b == 0) return cudaSuccess;
  const int64_t grid = (b + kWarps - 1) / kWarps;
  fm_interaction_bwd_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)dy, (float*)grad_v, b, f, d);
  return cudaGetLastError();
}

}  // extern "C"
