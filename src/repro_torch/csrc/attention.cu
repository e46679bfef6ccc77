// Flash attention for Hopper (sm_90a), plain C interface.
//
// K6 flash_attention computes, for q: [B, Hq, Sq, Dh] and k, v: [B, Hkv, Sk, Dh]
// (each addressed through element strides for B, H and S, Dh contiguous),
//   o[b, h, i] = sum_j softmax_j(s[i, j]) v[b, h / group, j],
//   s[i, j] = scale * <q[b, h, i], k[b, h / group, j]>,  scale = 1 / sqrt(Dh),
// over the keys j < kv_len, and with `causal` only those with i >= j (query and
// key positions both counted from 0).  It replaces the TPU kernel
//   src/repro/kernels/attention/kernel.py : flash_attention_pallas (_kernel)
// whose sequential kv grid axis carries m, l and acc in VMEM scratch.
//
// Precision follows the Pallas kernel: scores, the running max m, the
// normaliser l and the accumulator acc in float32; p is rounded to v's dtype
// before the PV product; the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100: in prefill, operations (4.Sq.Sk.Dh.Hq.B flops,
// half of them under the causal mask: 6.9e10 per layer at 8 x 2048 tokens of
// qwen1.5-0.5b, 0.07 ms at the 989 TFLOP/s of the bf16 tensor cores); in
// decode (Sq = 1), the bytes of the K/V cache (68 MB per layer at 8 x 2080).
//
// What the design does about it: one CTA per (64-query block, q head, batch
// row) walks the key tiles of 64 in order, with an online softmax.  bf16
// with more than one query block (prefill) runs on the tensor cores
// (mma.sync, flash_attention_mma_kernel below, K/V tiles double-buffered by
// cp.async).  The rest (float32, and decode's few query rows, where the
// bytes and not the arithmetic count) runs on FMA: 256 threads stage Q once
// and each K/V tile in shared memory as float32, each thread owning a 4 x 4
// block of the score tile and a 4-row slice of the accumulator; warps whose
// 8 query rows all lie past Sq (decode: all but the first) skip the
// arithmetic.  In decode the (b, h) pairs alone would leave most SMs idle
// (16 CTAs at batch 1), so the wrapper splits each row's key tiles over
// n_split CTAs (split-KV, as flash-decoding does); each writes its m, l and
// unnormalised acc to a float32 scratch, and a second kernel combines the
// splits in split order.  Key tiles wholly above the causal diagonal or at or
// past kv_len are never read, and the ragged last tile is masked here, so the
// caller pads nothing.  The GQA head map h / group is in the K/V offsets: no
// KV copy.  Keys are visited in one fixed order, splits are combined in one
// fixed order and no atomics are used, so a relaunch is bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns
static_assert(kBQ == kBK, "load_tile stages kBK rows for Q as well");
constexpr float kNegInf = -1.0e30f;

struct Strides {
  int64_t b, h, s;  // element strides; Dh is contiguous
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of T at src -> float dst[16 / sizeof(T)]
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// 4 floats -> 4 T at dst (aligned to 4 T)
__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c,
                                       float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

// Rows [row0, row0 + 64) of a [rows, DH] operand into dst[64][LD] as float;
// rows at or past n_rows are zero (so masked keys never feed NaN into p.v).
template <typename T, int DH, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int64_t s_stride,
                                          int row0, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DH / kVec;
  for (int idx = threadIdx.x; idx < kBK * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * kVec;
    float vals[kVec];
    if (row0 + r < n_rows) {
      load16(base + (int64_t)(row0 + r) * s_stride + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      store4(dst + r * LD + c + i, vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

template <int DH>
constexpr int smem_floats() {
  return kBQ * (DH + 4) + kBK * (DH + 4) + kBK * DH + kBQ * (kBK + 4);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Strides sq, Strides sk,
                       Strides sv, Strides so, int group, int seq_q, int seq_k,
                       int kv_len, int causal, float scale, int n_split,
                       float* __restrict__ part) {
  constexpr int QLD = DH + 4;  // float4 rows, conflict-free column reads
  constexpr int KLD = DH + 4;
  constexpr int PLD = kBK + 4;
  constexpr int NG = DH / 4;              // float4 column groups of the output
  constexpr int GPT = (NG + 15) / 16;     // groups per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * QLD;
  float* sV = sK + kBK * KLD;
  float* sP = sV + kBK * DH;

  // heavier (later) causal query blocks first; n_split CTAs per query block
  // share its key tiles (split-KV, decode)
  const int qb = gridDim.x / n_split - 1 - blockIdx.x / n_split;
  const int split = blockIdx.x % n_split;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qb * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // a warp holds rows [8w, 8w + 8): skip its arithmetic when all lie past Sq
  const bool busy = q0 + (threadIdx.x >> 5) * 8 < seq_q;

  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + (h / group) * sk.h;
  const T* vp = v + b * sv.b + (h / group) * sv.h;

  load_tile<T, DH, QLD>(sQ, qp, sq.s, q0, seq_q);  // sQ row r is query q0 + r

  const int kv_lim = min(kv_len, seq_k);
  int n_tiles = (kv_lim + kBK - 1) / kBK;
  if (causal) {
    const int q_last = min(q0 + kBQ, seq_q) - 1;
    n_tiles = min(n_tiles, q_last / kBK + 1);
  }
  const int per_split = (n_tiles + n_split - 1) / n_split;
  const int t_begin = split * per_split;
  const int t_end = min(n_tiles, t_begin + per_split);

  float m[4], l[4], acc[4][GPT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < GPT; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's sK / sV / sP are consumed
    load_tile<T, DH, KLD>(sK, kp, sk.s, k0, kv_lim);
    load_tile<T, DH, DH>(sV, vp, sv.s, k0, kv_lim);
    __syncthreads();
    float alpha[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (busy) {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * QLD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * KLD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        float mx = kNegInf;
        bool ok[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + tx + 16 * j;
          ok[j] = kj < kv_lim && (!causal || qi >= kj);
          s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
          sum += p;
          sP[(ty * 4 + i) * PLD + tx + 16 * j] = round_to(p, T());
        }
        // the butterfly adds commutative pairs: every lane gets the same sum
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        alpha[i] = expf(m[i] - m_new);
        l[i] = alpha[i] * l[i] + sum;
        m[i] = m_new;
      }
    }
    __syncthreads();
    if (busy) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < GPT; ++g)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha[i];
#pragma unroll 2
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(sP + (ty * 4 + i) * PLD + kk);
#pragma unroll
        for (int g = 0; g < GPT; ++g) {
          const int col = (tx + 16 * g) * 4;
          if (col < DH) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 vv = *reinterpret_cast<const float4*>(sV + (kk + u) * DH + col);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
                acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
                acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
                acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
                acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
              }
            }
          }
        }
      }
    }
  }

  if (!busy) return;
  if (n_split > 1) {  // this split's unnormalised acc, m and l, row by row
    const int64_t rows = (int64_t)gridDim.z * gridDim.y * seq_q;
    float* pm = part + rows * n_split * DH;  // acc first: float4-aligned
    float* pl = pm + rows * n_split;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if (qi >= seq_q) continue;
      const int64_t r = split * rows + ((int64_t)b * gridDim.y + h) * seq_q + qi;
      if (tx == 0) {
        pm[r] = m[i];
        pl[r] = l[i];
      }
      float* pa = part + r * DH;
#pragma unroll
      for (int g = 0; g < GPT; ++g) {
        const int col = (tx + 16 * g) * 4;
        if (col < DH) store4(pa + col, acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]);
      }
    }
    return;
  }
  T* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < GPT; ++g) {
      const int col = (tx + 16 * g) * 4;
      if (col < DH)
        store4(op + (int64_t)qi * so.s + col, acc[i][g][0] / denom, acc[i][g][1] / denom,
               acc[i][g][2] / denom, acc[i][g][3] / denom);
    }
  }
}

// The splits of one query row, combined in split order: one warp per row,
// lanes over Dh.  A split past the row's last key tile holds m = -1e30,
// l = 0 and acc = 0, and weighs exp(-1e30 - M) = 0.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
combine_splits_kernel(const float* __restrict__ part, T* __restrict__ o, Strides so,
                      int hq, int seq_q, int64_t rows, int n_split) {
  const int64_t r = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // r is the same for the whole warp
  const float* pa = part;
  const float* pm = part + rows * n_split * DH;
  const float* pl = pm + rows * n_split;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s * rows + r]);
  float l = 0.0f, acc[(DH + 31) / 32];
#pragma unroll
  for (int c = 0; c < (DH + 31) / 32; ++c) acc[c] = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(pm[s * rows + r] - mx);
    l = fmaf(w, pl[s * rows + r], l);
#pragma unroll
    for (int c = 0; c < (DH + 31) / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < DH) acc[c] = fmaf(w, pa[(s * rows + r) * DH + d], acc[c]);
    }
  }
  const float denom = fmaxf(l, 1e-30f);
  const int qi = (int)(r % seq_q);
  const int h = (int)((r / seq_q) % hq);
  const int64_t b = r / ((int64_t)seq_q * hq);
  T* op = o + b * so.b + h * so.h + (int64_t)qi * so.s;
#pragma unroll
  for (int c = 0; c < (DH + 31) / 32; ++c) {
    const int d = lane + 32 * c;
    if (d < DH) op[d] = from_float<T>(acc[c] / denom);
  }
}


// ---- bf16 prefill on the tensor cores --------------------------------------
// Eight warps, each owning 16 of the block's 128 query rows, run
// mma.sync.m16n8k16 (bf16 in, float32 accumulate): S = Q.K^T with Q's
// fragments held in registers for the whole walk, the online softmax on the
// accumulator fragments (a row's values sit in one quad of 4 lanes), then
// O += P.V with P's accumulators repacked in place as bf16 A fragments (the
// rounding of p to v's dtype) and V's B fragments from ldmatrix.trans.  K/V
// tiles are double-buffered: cp.async fetches tile t + 1 while tile t is
// computed; 128 query rows per CTA halve the K/V reads per query against the
// FMA kernel's 64.  Masks are computed only on the tiles of a warp that cross
// the causal diagonal or kv_len.  The softmax runs in base 2 (scores scaled
// by scale.log2(e), exp2f): the same p up to rounding.  The masks, the tile
// walk and the precision are otherwise those of the FMA kernel.
constexpr int kMmaRows = 128;
constexpr int kMmaThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
constexpr int mma_smem_bytes() {  // Q, then two stages of K and V
  return (kMmaRows + 4 * kBK) * (DH + 8) * (int)sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Starts the copy of rows [row0, row0 + ROWS) of a bf16 [rows, DH] operand
// into dst[ROWS][DH + 8] (cp.async, 16 bytes a thread at a time); rows at or
// past n_rows are zero-filled without a read.
template <int DH, int ROWS>
__device__ __forceinline__ void fetch_tile_bf16(__nv_bfloat16* dst,
                                                const __nv_bfloat16* base,
                                                int64_t s_stride, int row0, int n_rows) {
  constexpr int kPerRow = DH / 8;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kMmaThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * 8;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* src = ok ? base + (int64_t)(row0 + r) * s_stride + c : base;
    const uint32_t saddr =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * (DH + 8) + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most one committed group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
                           Strides sv, Strides so, int group, int seq_q, int seq_k,
                           int kv_len, int causal, float scale) {
  constexpr int LD = DH + 8;  // 16-byte pad: conflict-free fragment loads
  constexpr int KS = DH / 16;  // k steps of S = Q.K^T
  constexpr int NT = DH / 8;   // n tiles of O
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* sK0 = sQ + kMmaRows * LD;  // stage s: K at sK0 + 2s.kBK.LD, V after

  const int qb = gridDim.x - 1 - blockIdx.x;  // heavier causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qb * kMmaRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // the fragment's row (and +8)
  const int tig = lane & 3;   // its column pair
  const bool busy = q0 + warp * 16 < seq_q;

  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kp = k + b * sk.b + (h / group) * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + (h / group) * sv.h;
  const int kv_lim = min(kv_len, seq_k);
  int n_tiles = (kv_lim + kBK - 1) / kBK;
  if (causal) {
    const int q_last = min(q0 + kMmaRows, seq_q) - 1;
    n_tiles = min(n_tiles, q_last / kBK + 1);
  }
  const float scale2 = scale * kLog2e;
  auto fetch_kv = [&](int t) {  // tile t into stage t % 2
    __nv_bfloat16* dk = sK0 + (t & 1) * 2 * kBK * LD;
    fetch_tile_bf16<DH, kBK>(dk, kp, sk.s, t * kBK, kv_lim);
    fetch_tile_bf16<DH, kBK>(dk + kBK * LD, vp, sv.s, t * kBK, kv_lim);
  };
  fetch_tile_bf16<DH, kMmaRows>(sQ, qp, sq.s, q0, seq_q);
  fetch_kv(0);
  cp_async_commit();  // group 0: Q and tile 0

  uint32_t qa[KS][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // stage (t + 1) % 2 was last read by tile t - 1, behind the barrier that
    // ended its iteration; the group committed last is empty, which keeps
    // the wait below uniform
    if (t + 1 < n_tiles) fetch_kv(t + 1);
    cp_async_commit();
    cp_async_wait_one();  // tile t (and Q) have landed for this thread
    __syncthreads();      // ... and for every thread
    const __nv_bfloat16* sK = sK0 + (t & 1) * 2 * kBK * LD;
    const __nv_bfloat16* sV = sK + kBK * LD;
    // a warp skips the tiles wholly above its own rows' diagonal (p = 0 and
    // alpha = 1 there); at t = 0 every busy warp computes
    if (busy && !(causal && k0 > q0 + warp * 16 + 15)) {
      if (t == 0) {  // Q's A fragments, held in registers for the walk
        const __nv_bfloat16* qr = sQ + (warp * 16 + gid) * LD + tig * 2;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          qa[ks][0] = ld32(qr + ks * 16);
          qa[ks][1] = ld32(qr + 8 * LD + ks * 16);
          qa[ks][2] = ld32(qr + ks * 16 + 8);
          qa[ks][3] = ld32(qr + 8 * LD + ks * 16 + 8);
        }
      }
      float s[kBK / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = 0.0f;
        const __nv_bfloat16* kr = sK + (nt * 8 + gid) * LD + tig * 2;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma_bf16(s[nt], qa[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
      }
      // this warp's rows see a masked key in this tile only at the tile
      // holding kv_len or, causally, the diagonal
      const bool need_mask =
          k0 + kBK > kv_lim || (causal && k0 + kBK - 1 > q0 + warp * 16);
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows gid and gid + 8
        const int qi = q0 + warp * 16 + gid + 8 * half;
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nt][2 * half + e];
            x *= scale2;
            if (need_mask) {
              const int kj = k0 + nt * 8 + tig * 2 + e;
              if (kj >= kv_lim || (causal && qi < kj)) x = kNegInf;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // every row holds a real key in tile 0 (key 0), so m_new is finite
        // and a masked score's exp2f underflows to exactly 0
        const float m_new = fmaxf(m[half], mx);
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nt][2 * half + e];
            x = exp2f(x - m_new);
            sum += x;
          }
        // the butterfly adds commutative pairs: all 4 lanes get one sum
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float alpha = exp2f(m[half] - m_new);
        l[half] = alpha * l[half] + sum;
        m[half] = m_new;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[nt][2 * half] *= alpha;
          acc[nt][2 * half + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {  // 16 keys per step
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const int mi = lane >> 3;
        const __nv_bfloat16* vrow =
            sV + (16 * j + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {  // two n tiles of 8 per ldmatrix
          uint32_t b0, b1, b2, b3;
          const uint32_t addr =
              static_cast<uint32_t>(__cvta_generic_to_shared(vrow + np * 16));
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
              : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
              : "r"(addr));
          mma_bf16(acc[2 * np], pa, b0, b1);
          mma_bf16(acc[2 * np + 1], pa, b2, b3);
        }
      }
    }
    __syncthreads();  // stage t % 2 is consumed: tile t + 2 may overwrite it
  }

  if (!busy) return;
  __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + warp * 16 + gid + 8 * half;
    if (qi >= seq_q) continue;
    const float denom = fmaxf(l[half], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      __nv_bfloat162 pair = __floats2bfloat162_rn(acc[nt][2 * half] / denom,
                                                  acc[nt][2 * half + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(op + (int64_t)qi * so.s + nt * 8 + tig * 2) = pair;
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int hq,
           int group, int seq_q, int seq_k, int kv_len, int causal, float scale,
           const int64_t* st, int n_split, float* part, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (seq_q > kBQ) {  // prefill: the tensor cores (n_split is 1 here)
      const int smem = mma_smem_bytes<DH>();
      auto kern = flash_attention_mma_kernel<DH>;
      cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((seq_q + kMmaRows - 1) / kMmaRows, hq, batch);
      kern<<<grid, kMmaThreads, smem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)o, Strides{st[0], st[1], st[2]},
          Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
          Strides{st[9], st[10], st[11]}, group, seq_q, seq_k, kv_len, causal, scale);
      return cudaGetLastError();
    }
  }
  const size_t smem = smem_floats<DH>() * sizeof(float);
  auto kern = flash_attention_kernel<T, DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + kBQ - 1) / kBQ * n_split, hq, batch);
  const Strides so{st[9], st[10], st[11]};
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]}, so, group, seq_q,
      seq_k, kv_len, causal, scale, n_split, part);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int64_t rows = (int64_t)batch * hq * seq_q;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  combine_splits_kernel<T, DH><<<(unsigned)blocks, kThreads, 0, stream>>>(
      part, (T*)o, so, hq, seq_q, rows, n_split);
  return cudaGetLastError();
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o, int batch,
                int hq, int group, int seq_q, int seq_k, int kv_len, int causal,
                float scale, const int64_t* st, int n_split, float* part,
                cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, batch, hq, group, seq_q, seq_k, kv_len, causal,
                           scale, st, n_split, part, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, batch, hq, group, seq_q, seq_k, kv_len, causal,
                           scale, st, n_split, part, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, hq, group, seq_q, seq_k, kv_len, causal,
                           scale, st, n_split, part, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, hq, group, seq_q, seq_k, kv_len, causal,
                            scale, st, n_split, part, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (b, h, s) of q,
// k, v and o in that order; Dh is contiguous in all four, and every pointer and
// stride is 16-byte aligned (the wrapper checks both).  n_split > 1 (only
// with seq_q <= 64) splits each row's key tiles over n_split CTAs, which
// leave acc, m and l in `part` (n_split * batch * hq * seq_q * (dh + 2)
// float32, in that order, allocated by the caller) for a second kernel to
// combine.
int flash_attention(const void* q, const void* k, const void* v, void* o, int dtype,
                    int dh, int batch, int hq, int hkv, int seq_q, int seq_k, int kv_len,
                    int causal, float scale, const int64_t* strides, int n_split,
                    void* part, void* stream) {
  if (batch == 0 || hq == 0 || seq_q == 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || kv_len < 1 || seq_k < 1 || n_split < 1 ||
      (n_split > 1 && (seq_q > kBQ || part == nullptr)))
    return cudaErrorInvalidValue;
  const int group = hq / hkv;
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, o, batch, hq, group, seq_q, seq_k, kv_len,
                              causal, scale, strides, n_split, (float*)part,
                              (cudaStream_t)stream);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, batch, hq, group, seq_q, seq_k,
                                      kv_len, causal, scale, strides, n_split,
                                      (float*)part, (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
