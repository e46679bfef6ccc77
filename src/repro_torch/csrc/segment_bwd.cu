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
// its own, and every other slot (a dropped one) names row -1, outside
// [0, n_rows): such a slot reads no row, adds to none and gets grad_w 0,
// as the reference's where(keep, ...) gives it.  So grad_eo[r] is the sum
// over the slots that name r of w[s] * g[seg[s]] -- the plain version's
// index_add_ -- whatever g and eo hold.  The
// dispatch builds slot anyway (buffer row -> (token, slot)), so no sort
// runs here.  It replaces no TPU kernel: the JAX package differentiates
// its segment sum with XLA (src/repro/models/transformer.py : _moe_ffn);
// it is the backward of K5's bf16-row form (csrc/segment_sum.cu) in
// training.
//
// What bounds it on an H100: the bytes.  The rows the slots name, g, the
// indices and the slot map read once, grad_w and grad_eo written once: at
// granite-moe-1b-a400m's training microbatch (16,384 tokens, top 8, 32
// experts of 5,120 slots, D 1,024, bf16, some 65,000 slots kept) 0.54 GB a
// layer, 0.161 ms at 3.35 TB/s.  Three fifths of that is grad_eo, whose
// rows are mostly empty (no slot kept there): 0.2 GB of zeros.
//
// What the design does about it, for rows of 16-byte aligned width (the
// `stream` body): one launch of two kinds of warp.
//  - A slot warp takes kRun consecutive slots (a token's, at top 8, as the
//    dispatch orders them).  It loads the run's indices at once, holds
//    g[seg] in registers (a tile of 32 * kSteps 16-byte pieces of eo's row
//    at a time) from a token's first slot to its last, reads eo[rows[s]]
//    16 bytes a lane with the next slot's row already in flight, and sums
//    the dot.  Where the slot owns its row (slot[rows[s]] == s: every kept
//    slot under the dispatch's contract, no dropped one) it writes
//    grad_eo's row from the g it holds.  So g is read once, in token
//    order, whatever order the buffer rows are in; reading it again for
//    each kept row in buffer order, as the warp_row body does, costs 60 %
//    more time at that shape.  Loads issued ahead by a lane beat a ring
//    filled by TMA bulk copies (one CTA an SM) there, and one row ahead
//    does as well as two.
//  - A row warp takes 32 buffer rows, finds from slot[] the rows that no
//    slot owns and writes them: zeros by streaming stores, or, where
//    slot[r] is a slot that names another row (outside the contract),
//    w[slot[r]] * g[seg[slot[r]]] as before, so that the function stays
//    the same for every input.
// The row CTAs are spread evenly among the slot CTAs (kInterleave), so the
// zeros stream out while the gathers wait on device memory.  Each output
// is written by one warp in one order, with no atomics: a relaunch gives
// the same bits.  grad_w's dot keeps the warp_row body's order (a lane's
// 16-byte columns in turn, then the same butterfly), so the two bodies
// give the same bits too.
//
// The `warp_row` body (one warp an output row: the rows of grad_w, then
// those of grad_eo, each rereading its g row) runs the shapes whose rows
// are not 16-byte aligned, an element a lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the stream body: slots a slot warp, buffer rows a row warp, 16-byte
// pieces of a row a lane holds (a tile of 32 * kSteps pieces: 1,024 bf16
// or 512 float32 columns; g's matching floats held from a token's first
// slot to its last)
constexpr int kRun = 8;
constexpr int kRowsPerWarp = 32;
constexpr int kSteps = 4;
// eo rows a slot warp has in flight beyond the one it sums
constexpr int kAhead = 1;
// row CTAs spread among the slot CTAs; else every slot CTA first
constexpr bool kInterleave = true;

// ---- the warp_row body -------------------------------------------------

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
    const int64_t r = rows[row];
    const T* er = eo + r * d;
    const float* gr = g + (int64_t)seg[row] * d;
    float acc = 0.0f;
    // a slot that names no row (a dropped one) reads nothing: grad_w 0
    for (int c = lane * VEC; r >= 0 && r < n_rows && c < d; c += 32 * VEC) {
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
int launch_warp_row(const void* eo, const float* g, const float* w, const int64_t* rows,
                    const int32_t* seg, const int64_t* slot, float* grad_w, void* grad_eo,
                    int64_t n_slots, int64_t n_rows, int d, cudaStream_t stream) {
  const int64_t blocks = (n_slots + n_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  combine_bwd_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(eo), g, w, rows, seg, slot, grad_w, static_cast<T*>(grad_eo),
      n_slots, n_rows, d);
  return cudaGetLastError();
}

// ---- the stream body ---------------------------------------------------

// 16 bytes of T as floats and back (grad_eo rounded once, to nearest even)
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

// a lane's kSteps 16-byte pieces of a tile of a row: columns (j * 32 +
// lane) * kN, those below `left`
template <typename T>
__device__ __forceinline__ void load_tile(uint4 (&dst)[kSteps], const T* src, int lane,
                                          int left) {
  constexpr int VEC = Vec16<T>::kN;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int c = (j * 32 + lane) * VEC;
    if (c < left) dst[j] = __ldg(reinterpret_cast<const uint4*>(src + c));
  }
}

// the same columns of a float32 row
template <int VEC>
__device__ __forceinline__ void load_g(float (&dst)[kSteps * VEC], const float* src, int lane,
                                       int left) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int c = (j * 32 + lane) * VEC;
    if (c < left) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src + c) + q);
        dst[j * VEC + 4 * q] = f.x;
        dst[j * VEC + 4 * q + 1] = f.y;
        dst[j * VEC + 4 * q + 2] = f.z;
        dst[j * VEC + 4 * q + 3] = f.w;
      }
    }
  }
}

// slots [wid * kRun, wid * kRun + kRun): their dots, and grad_eo's rows
// that they own
template <typename T>
__device__ __forceinline__ void slot_warp(int64_t wid, int lane, const T* __restrict__ eo,
                                          const float* __restrict__ g,
                                          const float* __restrict__ w,
                                          const int64_t* __restrict__ rows,
                                          const int32_t* __restrict__ seg,
                                          const int64_t* __restrict__ slot,
                                          float* __restrict__ grad_w, T* __restrict__ grad_eo,
                                          int64_t n_slots, int64_t n_rows, int d) {
  using V = Vec16<T>;
  constexpr int VEC = V::kN;
  constexpr int kTile = 32 * kSteps * VEC;
  const int64_t s0 = wid * kRun;
  const int cnt = (int)(n_slots - s0 < kRun ? n_slots - s0 : kRun);
  // lane i holds slot s0 + i's indices; whether it owns its row is read
  // only after the first dot, so that its load waits on nothing.  A slot
  // that names no row (a dropped one) reads nothing, owns nothing and
  // keeps a dot of 0.
  long long my_row = 0;
  int my_seg = 0, my_own = 0;
  float my_w = 0.0f;
  bool my_named = false;
  if (lane < cnt) {
    my_row = rows[s0 + lane];
    my_seg = seg[s0 + lane];
    my_w = w[s0 + lane];
    my_named = my_row >= 0 && my_row < n_rows;
    my_own = my_named && slot[my_row] == s0 + lane;
  }
  const unsigned named = __ballot_sync(kFull, my_named);
  float acc[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) acc[i] = 0.0f;
  for (int t0 = 0; t0 < d; t0 += kTile) {
    const int left = d - t0;
    float gv[kSteps * VEC];
    uint4 ring[kAhead + 1][kSteps];
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      if (a < cnt && (named >> a & 1))
        load_tile<T>(ring[a], eo + __shfl_sync(kFull, my_row, a) * d + t0, lane, left);
    int held = 0;
    bool have = false;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (i < cnt) {
        if (i + kAhead < cnt && (named >> (i + kAhead) & 1))
          load_tile<T>(ring[(i + kAhead) % (kAhead + 1)],
                       eo + __shfl_sync(kFull, my_row, i + kAhead) * d + t0, lane, left);
        if (!(named >> i & 1)) continue;
        const uint4(&cur)[kSteps] = ring[i % (kAhead + 1)];
        const int sg = __shfl_sync(kFull, my_seg, i);
        if (!have || sg != held) {
          load_g<VEC>(gv, g + (int64_t)sg * d + t0, lane, left);
          held = sg;
          have = true;
        }
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          if ((j * 32 + lane) * VEC < left) {
            float e[VEC];
            V::unpack(cur[j], e);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[i] = fmaf(e[v], gv[j * VEC + v], acc[i]);
          }
        }
        if (__shfl_sync(kFull, my_own, i)) {
          const float ws = __shfl_sync(kFull, my_w, i);
          T* out = grad_eo + __shfl_sync(kFull, my_row, i) * d + t0;
#pragma unroll
          for (int j = 0; j < kSteps; ++j) {
            const int c = (j * 32 + lane) * VEC;
            if (c < left) {
              float v[VEC];
#pragma unroll
              for (int q = 0; q < VEC; ++q) v[q] = ws * gv[j * VEC + q];
              *reinterpret_cast<uint4*>(out + c) = V::pack(v);
            }
          }
        }
      }
    }
  }
  float mine = 0.0f;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    float a = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
    if (lane == i) mine = a;
  }
  if (lane < cnt) grad_w[s0 + lane] = mine;
}

// buffer rows [wid * 32, wid * 32 + 32) that no slot owns
template <typename T>
__device__ __forceinline__ void row_warp(int64_t wid, int lane, const float* __restrict__ g,
                                         const float* __restrict__ w,
                                         const int64_t* __restrict__ rows,
                                         const int32_t* __restrict__ seg,
                                         const int64_t* __restrict__ slot,
                                         T* __restrict__ grad_eo, int64_t n_slots,
                                         int64_t n_rows, int d) {
  using V = Vec16<T>;
  constexpr int VEC = V::kN;
  const int64_t r0 = wid * kRowsPerWarp;
  const int64_t r = r0 + lane;
  long long s = -1;
  bool todo = false;
  if (r < n_rows) {
    s = slot[r];
    const bool named = s >= 0 && s < n_slots;
    todo = !(named && rows[s] == r);
    if (!named) s = -1;
  }
  const int n16 = d / VEC;
  for (unsigned left = __ballot_sync(kFull, todo); left; left &= left - 1) {
    const int i = __ffs(left) - 1;
    const long long si = __shfl_sync(kFull, s, i);
    uint4* out = reinterpret_cast<uint4*>(grad_eo + (r0 + i) * d);
    if (si < 0) {
      for (int c = lane; c < n16; c += 32) __stcs(out + c, make_uint4(0u, 0u, 0u, 0u));
    } else {
      const float ws = w[si];
      const float* gr = g + (int64_t)seg[si] * d;
      for (int c = lane; c < n16; c += 32) {
        float v[VEC];
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float4 f = reinterpret_cast<const float4*>(gr + c * VEC)[q];
          v[4 * q] = ws * f.x;
          v[4 * q + 1] = ws * f.y;
          v[4 * q + 2] = ws * f.z;
          v[4 * q + 3] = ws * f.w;
        }
        out[c] = V::pack(v);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_bwd_stream_kernel(const T* __restrict__ eo, const float* __restrict__ g,
                          const float* __restrict__ w, const int64_t* __restrict__ rows,
                          const int32_t* __restrict__ seg, const int64_t* __restrict__ slot,
                          float* __restrict__ grad_w, T* __restrict__ grad_eo,
                          int64_t n_slots, int64_t n_rows, int d, int64_t slot_ctas,
                          int64_t row_ctas) {
  const int64_t b = blockIdx.x;
  bool row_cta;
  int64_t idx;
  if (kInterleave) {  // CTA b is the lo-th row CTA when it raises the share
    const int64_t total = slot_ctas + row_ctas;
    const int64_t lo = b * row_ctas / total;
    row_cta = (b + 1) * row_ctas / total > lo;
    idx = row_cta ? lo : b - lo;
  } else {
    row_cta = b >= slot_ctas;
    idx = row_cta ? b - slot_ctas : b;
  }
  const int64_t wid = idx * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row_cta) {
    if (wid * kRowsPerWarp < n_rows)
      row_warp<T>(wid, lane, g, w, rows, seg, slot, grad_eo, n_slots, n_rows, d);
  } else if (wid * kRun < n_slots) {
    slot_warp<T>(wid, lane, eo, g, w, rows, seg, slot, grad_w, grad_eo, n_slots, n_rows, d);
  }
}

template <typename T>
int launch_stream(const void* eo, const float* g, const float* w, const int64_t* rows,
                  const int32_t* seg, const int64_t* slot, float* grad_w, void* grad_eo,
                  int64_t n_slots, int64_t n_rows, int d, cudaStream_t stream) {
  const int64_t slot_warps = (n_slots + kRun - 1) / kRun;
  const int64_t row_warps = (n_rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const int64_t slot_ctas = (slot_warps + kWarps - 1) / kWarps;
  const int64_t row_ctas = (row_warps + kWarps - 1) / kWarps;
  if (slot_ctas + row_ctas > 0x7fffffff) return cudaErrorInvalidValue;
  combine_bwd_stream_kernel<T><<<(unsigned)(slot_ctas + row_ctas), kThreads, 0, stream>>>(
      static_cast<const T*>(eo), g, w, rows, seg, slot, grad_w, static_cast<T*>(grad_eo),
      n_slots, n_rows, d, slot_ctas, row_ctas);
  return cudaGetLastError();
}

int warp_row(const void* eo, int dtype, const float* g, const float* w, const int64_t* rows,
             const int32_t* seg, const int64_t* slot, float* grad_w, void* grad_eo,
             int64_t n_slots, int64_t n_rows, int d, int vec, cudaStream_t st) {
  if (dtype == 0 && vec == 4)
    return launch_warp_row<float, 4>(eo, g, w, rows, seg, slot, grad_w, grad_eo, n_slots,
                                     n_rows, d, st);
  if (dtype == 0 && vec == 1)
    return launch_warp_row<float, 1>(eo, g, w, rows, seg, slot, grad_w, grad_eo, n_slots,
                                     n_rows, d, st);
  if (dtype == 1 && vec == 8)
    return launch_warp_row<__nv_bfloat16, 8>(eo, g, w, rows, seg, slot, grad_w, grad_eo,
                                             n_slots, n_rows, d, st);
  if (dtype == 1 && vec == 1)
    return launch_warp_row<__nv_bfloat16, 1>(eo, g, w, rows, seg, slot, grad_w, grad_eo,
                                             n_slots, n_rows, d, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 float32, 1 bfloat16 (eo and grad_eo).  eo, grad_eo: [n_rows, d];
// g: [*, d] float32; w, grad_w: [n_slots] float32; rows [n_slots] int64,
// seg [n_slots] int32 and slot [n_rows] int64, as the MoE dispatch makes
// them; slot[r] outside [0, n_slots) means no slot, rows[s] outside [0,
// n_rows) no row (a dropped slot: grad_w[s] = 0).  vec: 16 / sizeof(T)
// (d a multiple of it, eo, g and grad_eo 16-byte aligned), which runs the
// stream body, or 1, the warp_row body.
int moe_combine_bwd(const void* eo, int dtype, const float* g, const float* w,
                    const int64_t* rows, const int32_t* seg, const int64_t* slot, float* grad_w,
                    void* grad_eo, int64_t n_slots, int64_t n_rows, int d, int vec,
                    void* stream) {
  if (n_slots + n_rows == 0 || d == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && vec == 4)
    return launch_stream<float>(eo, g, w, rows, seg, slot, grad_w, grad_eo, n_slots, n_rows,
                                d, st);
  if (dtype == 1 && vec == 8)
    return launch_stream<__nv_bfloat16>(eo, g, w, rows, seg, slot, grad_w, grad_eo, n_slots,
                                        n_rows, d, st);
  if (vec == 1)
    return warp_row(eo, dtype, g, w, rows, seg, slot, grad_w, grad_eo, n_slots, n_rows, d, 1,
                    st);
  return cudaErrorInvalidValue;
}

// The same function on the warp_row body whatever vec (1 or 16 / sizeof(T)).
int moe_combine_bwd_warp_row(const void* eo, int dtype, const float* g, const float* w,
                             const int64_t* rows, const int32_t* seg, const int64_t* slot,
                             float* grad_w, void* grad_eo, int64_t n_slots, int64_t n_rows,
                             int d, int vec, void* stream) {
  if (n_slots + n_rows == 0 || d == 0) return cudaSuccess;
  return warp_row(eo, dtype, g, w, rows, seg, slot, grad_w, grad_eo, n_slots, n_rows, d, vec,
                  (cudaStream_t)stream);
}

}  // extern "C"
