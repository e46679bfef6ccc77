// The backward of K5's gather form as the MoE combine uses it, for Hopper
// (sm_90a), plain C interface.
//
// K5's combine computes out[t] = sum over slots s with seg[s] == t of
// w[s] * eo[rows[s]] (float32 sums of eo's rows, bf16 or float32).  Given
// g = dL/d out ([T, D] float32), moe_combine_bwd computes
//   grad_w[s]  = <eo[rows[s]], g[seg[s]]>                    (float32)
//   grad_eo[r] = w[slot[r]] * g[seg[slot[r]]]  (slot[r] < n_slots; else 0)
// with grad_eo in eo's dtype.  slot is the inverse of rows over the kept
// slots: the MoE dispatch gives each kept (token, slot) a buffer row of
// its own, and every other slot (a dropped one) names row 0 with weight 0,
// so grad_eo[r] is the sum over the slots that name r of w[s] * g[seg[s]]
// -- the plain version's index_add_ -- whenever g is finite.  The
// dispatch builds slot anyway (buffer row -> (token, slot)), so no sort
// runs here.  It replaces no TPU kernel: the JAX package differentiates
// its segment sum with XLA (src/repro/models/transformer.py : _moe_ffn);
// it is the backward of K5's bf16-row form (csrc/segment_sum.cu) in
// training.
//
// What bounds it on an H100: the bytes.  Each slot's row of eo and of g is
// read once for its dot, each buffer row of grad_eo written once and each
// kept row of g read for it: at granite-moe-1b-a400m's training
// microbatch (16,384 tokens, top 8, 32 experts of 5,120 slots, D 1,024,
// bf16) some 0.47 GB a layer, 0.14 ms at 3.35 TB/s.
//
// What the design does about it: one warp a row of output, rows of grad_w
// first, then rows of grad_eo; a lane reads 16 bytes of eo at a time (8
// bf16 or 4 float32) and the matching float32 of g, and a dot's lane sums
// are added by a fixed butterfly.  No atomics: each output is written by
// one warp, in one order, so a relaunch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void to_float(const float* src, float* dst, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}
__device__ __forceinline__ void to_float(const __nv_bfloat16* src, float* dst, int n) {
  for (int i = 0; i < n; ++i) dst[i] = __bfloat162float(src[i]);
}

__device__ __forceinline__ void from_float(const float* src, float* dst, int n) {
  for (int i = 0; i < n; ++i) dst[i] = src[i];
}
__device__ __forceinline__ void from_float(const float* src, __nv_bfloat16* dst, int n) {
  for (int i = 0; i < n; ++i) dst[i] = __float2bfloat16_rn(src[i]);
}

// VEC elements of T a lane at a time (16 bytes when the wrapper finds d and
// the bases aligned for it, else 1)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
combine_bwd_kernel(const T* __restrict__ eo, const float* __restrict__ g,
                   const float* __restrict__ w, const int64_t* __restrict__ rows,
                   const int32_t* __restrict__ seg, const int64_t* __restrict__ slot,
                   float* __restrict__ grad_w,
                   T* __restrict__ grad_eo, int64_t n_slots, int64_t n_rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row < n_slots) {
    const T* er = eo + rows[row] * d;
    const float* gr = g + (int64_t)seg[row] * d;
    float acc = 0.0f;
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float e[VEC];
      alignas(16) T raw[VEC];
      *reinterpret_cast<typename std::conditional<VEC == 1, T, uint4>::type*>(raw) =
          *reinterpret_cast<const typename std::conditional<VEC == 1, T, uint4>::type*>(er + c);
      to_float(raw, e, VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc = fmaf(e[i], gr[c + i], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) grad_w[row] = acc;
  } else if (row < n_slots + n_rows) {
    const int64_t r = row - n_slots;
    const int64_t s = slot[r];
    T* out = grad_eo + r * d;
    const bool kept = s >= 0 && s < n_slots;
    const float ws = kept ? w[s] : 0.0f;
    const float* gr = kept ? g + (int64_t)seg[s] * d : nullptr;
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = kept ? ws * gr[c + i] : 0.0f;
      alignas(16) T raw[VEC];
      from_float(v, raw, VEC);
      *reinterpret_cast<typename std::conditional<VEC == 1, T, uint4>::type*>(out + c) =
          *reinterpret_cast<const typename std::conditional<VEC == 1, T, uint4>::type*>(raw);
    }
  }
}

template <typename T, int VEC>
int launch(const void* eo, const float* g, const float* w, const int64_t* rows,
           const int32_t* seg, const int64_t* slot, float* grad_w, void* grad_eo,
           int64_t n_slots, int64_t n_rows, int d, cudaStream_t stream) {
  constexpr int kWarps = kThreads / 32;
  const int64_t blocks = (n_slots + n_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  combine_bwd_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(eo), g, w, rows, seg, slot, grad_w, static_cast<T*>(grad_eo),
      n_slots, n_rows, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 float32, 1 bfloat16 (eo and grad_eo).  eo, grad_eo: [n_rows, d];
// g: [*, d] float32; w, grad_w: [n_slots] float32; rows [n_slots] int64,
// seg [n_slots] int32 and slot [n_rows] int64, as the MoE dispatch makes
// them; slot[r] outside [0, n_slots) means no slot.  vec: 16 / sizeof(T)
// (d a multiple of it, eo, g and grad_eo 16-byte aligned) or 1.
int moe_combine_bwd(const void* eo, int dtype, const float* g, const float* w,
                    const int64_t* rows, const int32_t* seg, const int64_t* slot, float* grad_w,
                    void* grad_eo, int64_t n_slots, int64_t n_rows, int d, int vec,
                    void* stream) {
  if (n_slots + n_rows == 0 || d == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(eo, g, w, rows, seg, slot, grad_w, grad_eo, n_slots, n_rows, d, st);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(eo, g, w, rows, seg, slot, grad_w, grad_eo, n_slots, n_rows, d, st);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(eo, g, w, rows, seg, slot, grad_w, grad_eo, n_slots,
                                    n_rows, d, st);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(eo, g, w, rows, seg, slot, grad_w, grad_eo, n_slots,
                                    n_rows, d, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
