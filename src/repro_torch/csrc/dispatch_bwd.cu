// The MoE dispatch's backward for Hopper (sm_90a), plain C interface.
//
// The dispatch gathers each kept (token, slot) pair's token into a buffer
// row of its own: buf[dest[t * k + j]] = x[t] where keep[t * k + j].  Given
// g = dL/d buf ([n_rows, d], bf16 or float32), moe_dispatch_bwd computes
//   gx[t] = sum over j < k with keep[t * k + j] of g[dest[t * k + j]]
// summed in float32 in ascending j from +0 (__fadd_rn, no contraction) and
// rounded once, to nearest even, into g's dtype.  A token with no kept slot
// gets zeros; a dropped slot reads nothing, whatever g holds at the row its
// dest names (and a kept slot whose dest lies outside [0, n_rows) counts as
// dropped).  Every element of gx is written.  On finite g that is, bit for
// bit, K5's gather form over rows dest (weight 1 a kept slot, 0 a dropped
// one) followed by a cast, which the port ran before: a token's k slots lie
// in one K5 walker, summed in slot order.  It replaces XLA's gradient of
// the dispatch scatter at src/repro/models/transformer.py:524-529 (the
// reference's `buf.at[...].add(where(keep, xf[tok_idx], 0))`); no Pallas
// kernel of the reference computes it.
//
// What bounds it on an H100: the bytes.  Each kept slot's buffer row read
// once (no buffer row is named by two slots), dest and keep read once, gx
// written once.  At granite-moe-1b-a400m's training microbatch (16,384
// tokens, top 8, 163,840 buffer rows of 1,024 bf16, some 65,000 slots kept)
// that is 167.8 MB, 0.050 ms at 3.35 TB/s.
//
// What the design does about it, for rows of a 16-byte multiple with
// 16-byte aligned bases (the vec body): one warp takes one token and one
// tile of 32 16-byte columns of its row (four tiles a token at d = 1,024 in
// bf16).  Lane j loads slot j's dest and keep; a ballot gives the kept
// slots, and their rows go round by shuffle, so the branch on keep is the
// warp's, and a dropped slot issues no load.  Up to kBatch kept rows' 16
// bytes a lane are in flight before the first add, read with the
// evict-first hint (each row is read exactly once); the sum stays in
// registers and leaves in one 16-byte streaming store a lane.  No shared
// memory, no plan, no second launch; no atomics, so a relaunch gives the
// same bits.  Other widths (the elem body) run a warp a token, an element
// a lane, in the same order.  kBatch and kThreads are what
// tools/dispatch_bwd_probe.py found fastest at that shape: 8 rows in flight
// took 62 registers a thread and ran 3-4 % slower; with no row read the
// launch takes ~30 % of the time, with no store ~80 %.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// kept rows a lane has in flight before it adds the first
constexpr int kBatch = 4;

// 16 bytes of T as floats and back (rounded once, to nearest even)
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ void unpack(const uint4& r, float* e) {
    e[0] = __uint_as_float(r.x);
    e[1] = __uint_as_float(r.y);
    e[2] = __uint_as_float(r.z);
    e[3] = __uint_as_float(r.w);
  }
  __device__ static __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ void unpack(const uint4& r, float* e) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[2 * i] = __uint_as_float(u[i] << 16);
      e[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ uint4 pack(const float* v) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// a buffer row read once: streaming, evict first
__device__ __forceinline__ uint4 load_row(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// Slots [s0, s0 + 32) of a token (those below `end`): lane j's row and
// whether it is kept and names a row of g.  Returns the kept lanes' mask.
__device__ __forceinline__ unsigned kept_slots(const int64_t* __restrict__ dest,
                                               const uint8_t* __restrict__ keep, int64_t s0,
                                               int64_t end, int64_t n_rows, int lane,
                                               long long& row) {
  const int64_t s = s0 + lane;
  bool kept = false;
  row = 0;
  if (s < end) {
    row = dest[s];
    kept = keep[s] != 0 && row >= 0 && row < n_rows;
  }
  return __ballot_sync(kFull, kept);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dispatch_bwd_vec_kernel(const T* __restrict__ g, const int64_t* __restrict__ dest,
                        const uint8_t* __restrict__ keep, T* __restrict__ gx, int64_t n_tok,
                        int k, int64_t n_rows, int d, int tiles) {
  using V = Vec16<T>;
  constexpr int VEC = V::kN;
  const int64_t wid = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (wid >= n_tok * tiles) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int64_t t = wid / tiles;
  const int c = ((int)(wid - t * tiles) * 32 + lane) * VEC;
  const bool live = c < d;
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
  const int64_t end = (t + 1) * k;
  for (int64_t s0 = t * k; s0 < end; s0 += 32) {
    long long row;
    unsigned left = kept_slots(dest, keep, s0, end, n_rows, lane, row);
    while (left) {
      uint4 v[kBatch];
      int n = 0;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (left) {
          const int i = __ffs(left) - 1;
          left &= left - 1;
          const long long r = __shfl_sync(kFull, row, i);
          if (live) v[b] = load_row(g + r * d + c);
          n = b + 1;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b < n && live) {
          float e[VEC];
          V::unpack(v[b], e);
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], e[q]);
        }
      }
    }
  }
  if (live) __stcs(reinterpret_cast<uint4*>(gx + t * d + c), V::pack(acc));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dispatch_bwd_elem_kernel(const T* __restrict__ g, const int64_t* __restrict__ dest,
                         const uint8_t* __restrict__ keep, T* __restrict__ gx, int64_t n_tok,
                         int k, int64_t n_rows, int d) {
  const int64_t t = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (t >= n_tok) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int64_t end = (t + 1) * k;
  for (int c0 = 0; c0 < d; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < d;
    float acc = 0.0f;
    for (int64_t s0 = t * k; s0 < end; s0 += 32) {
      long long row;
      for (unsigned left = kept_slots(dest, keep, s0, end, n_rows, lane, row); left;
           left &= left - 1) {
        const long long r = __shfl_sync(kFull, row, __ffs(left) - 1);
        if (live) acc = __fadd_rn(acc, to_float(g[r * d + c]));
      }
    }
    if (live) store(gx + t * d + c, acc);
  }
}

template <typename T>
int launch(const void* g, const int64_t* dest, const uint8_t* keep, void* gx, int64_t n_tok,
           int k, int64_t n_rows, int d, int vec, cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  T* out = static_cast<T*>(gx);
  if (vec == Vec16<T>::kN) {
    const int tiles = (d + 32 * vec - 1) / (32 * vec);
    const int64_t blocks = (n_tok * tiles + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    dispatch_bwd_vec_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gp, dest, keep, out, n_tok, k, n_rows, d, tiles);
  } else if (vec == 1) {
    const int64_t blocks = (n_tok + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    dispatch_bwd_elem_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gp, dest, keep, out, n_tok, k, n_rows, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 float32, 1 bfloat16 (g and gx).  g: [n_rows, d]; dest: [n_tok *
// k] int64; keep: [n_tok * k] bool (one byte each); gx: [n_tok, d], every
// element written.  vec: 16 / sizeof(T) (d a multiple of it, g and gx
// 16-byte aligned), which runs the vec body, or 1, the elem body.
int moe_dispatch_bwd(const void* g, int dtype, const int64_t* dest, const uint8_t* keep,
                     void* gx, int64_t n_tok, int k, int64_t n_rows, int d, int vec,
                     void* stream) {
  if (n_tok == 0 || d == 0) return cudaSuccess;
  if (n_tok < 0 || k < 0 || n_rows < 0 || d < 0 || gx == nullptr ||
      (k > 0 && (dest == nullptr || keep == nullptr || (n_rows > 0 && g == nullptr))))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(g, dest, keep, gx, n_tok, k, n_rows, d, vec, st);
  if (dtype == 1) return launch<__nv_bfloat16>(g, dest, keep, gx, n_tok, k, n_rows, d, vec, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
