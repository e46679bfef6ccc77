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
// decode (Sq <= 64), the bytes of the K/V cache (68 MB per layer at 8 x 2080
// keys, 134 MB at 1 x 32784: 0.020 and 0.040 ms at 3.35 TB/s).
//
// What the design does about it.  Prefill (Sq > 64): one CTA per (query
// block, q head, batch row) walks the key tiles of 64 in order, with an
// online softmax; bf16 runs on the tensor cores (mma.sync,
// flash_attention_mma_kernel, K/V tiles double-buffered by cp.async),
// float32 on FMA (flash_attention_kernel: 256 threads stage Q once and each
// K/V tile in shared memory, each thread owning a 4 x 4 block of the score
// tile and a 4-row slice of the accumulator).  Decode (Sq <= 64,
// flash_decode_kernel) is a stream over the cache: one 8-warp CTA (4 for
// float32 at Dh 128) per (split, kv head, batch row, chunk of up to 4 query
// rows) holds all the query rows that read its kv head in registers, so a
// kv head's cache is read once, not once per q head; each warp streams its
// own 16 keys of every 128-key tile through a ring of cp.async stages in the
// cache's own dtype (16 KB a warp: 4 stages at Dh 64 in bf16, one CTA an
// SM, 96 KB in flight) with no barrier at all, each lane fetching the
// pieces it reads; it scores them without padding (a key row spread over
// Dh.sizeof(T)/16 lanes, reduced by shuffles) and keeps a per-lane online
// softmax; at the end the lanes, then the warps (through shared memory, in
// warp order), merge their (m, l, acc).  The wrapper splits a row's key
// tiles over enough CTAs to fill the card once (split-KV, as
// flash-decoding does): each split leaves its (m, l, acc) in a float32
// scratch, and the last CTA of a (batch row, kv head, chunk) to arrive --
// found by an arrival counter that lives in the same scratch, zeroed on the
// launch's stream just before it -- combines all splits in split order, in
// the same launch.  The counter picks who combines, never the order of a
// sum.  Key tiles wholly above the causal diagonal or at
// or past kv_len are never read, and the ragged last tile is masked here,
// so the caller pads nothing.  The GQA head map h / group is in the K/V
// offsets: no KV copy.  Keys are visited in one fixed order and every sum
// runs in a fixed order, so a relaunch is bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;        // query rows per CTA of the FMA kernel
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

// 16 bytes of T -> float dst[16 / sizeof(T)]
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<__nv_bfloat16> {
  using type = uint4;
};

__device__ __forceinline__ void unpack16(const float4& v, float* dst) {
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void unpack16(const uint4& v, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// from global memory, read-only for the kernel's lifetime
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  unpack16(__ldg(reinterpret_cast<const typename Vec16<T>::type*>(src)), dst);
}

// from shared memory
template <typename T>
__device__ __forceinline__ void lds16(const T* src, float* dst) {
  unpack16(*reinterpret_cast<const typename Vec16<T>::type*>(src), dst);
}

// 4 floats at dst (16-byte aligned)
__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
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
                       int kv_len, int causal, float scale) {
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

  const int qb = gridDim.x - 1 - blockIdx.x;  // heavier causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qb * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // a warp holds rows [8w, 8w + 8): skip its arithmetic when all lie past Sq
  // (in the ragged last query block)
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

  for (int t = 0; t < n_tiles; ++t) {
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

// Starts a 16-byte copy from global src to shared dst; with ok false it
// reads nothing and zero-fills dst.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t saddr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(src), "r"(ok ? 16 : 0));
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
    cp_async16(dst + r * (DH + 8) + c,
               ok ? base + (int64_t)(row0 + r) * s_stride + c : base, ok);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
    cp_async_wait<1>();  // tile t (and Q) have landed for this thread
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

// ---- decode (Sq <= 64): a stream over the K/V cache -------------------------
// One CTA of W warps per (split, kv head, batch row, chunk of ROWS query
// rows).  The rows that read kv head kvh are (g, i) for q head kvh.group + g
// and query i, numbered g.Sq + i (head-major), so that row r of kv head kvh
// of batch row b is row (b.Hkv + kvh).group.Sq + r of q's [B, Hq, Sq] order.
// A tile is W x 16 keys, 16 to a warp.  Each lane holds a 16-byte column
// slice (at dc) of every row's q, as float32, and of one key per pass: a key
// row spans LPK lanes, KPP keys are scored per pass, and lane (ks, dc) scores
// keys ks, ks + KPP, ... of its warp's 16.  It also fetches exactly the K and
// V pieces it reads, so each lane's ring is its own: no barrier in the walk.
constexpr int kWarpKeys = 16;  // a warp's keys of each tile
constexpr int kDecMaxSq = 64;  // the decode kernel takes Sq <= 64
constexpr int kDecRows = 4;    // query rows per CTA when more than 1

template <typename T, int DH>
struct Dec {
  static constexpr int kEpl = 16 / (int)sizeof(T);     // elements per lane slice
  static constexpr int kLpk = DH / kEpl;               // lanes per key row
  static constexpr int kKpp = 32 / kLpk;               // keys per pass
  static constexpr int kPasses = kWarpKeys / kKpp;     // passes per tile
  static constexpr int kStage = 2 * kWarpKeys * DH;    // one warp's K and V, elements
  static constexpr int kStageBytes = kStage * (int)sizeof(T);
  // about 16 KB of ring per warp: 4 stages of 4 KB at Dh 64 in bf16 (8 and
  // 12 KB measured within 2 % of it, one CTA an SM)
  static constexpr int kStages =
      16384 / kStageBytes > 8 ? 8 : 16384 / kStageBytes < 2 ? 2 : 16384 / kStageBytes;
  // 8 warps (two a scheduler, one CTA an SM) where their rings fit, else 4
  static constexpr int kWarps = 8 * kStages * kStageBytes <= 160 * 1024 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = kWarps * kWarpKeys;
  static_assert(kLpk <= 32 && 32 % kLpk == 0 && kWarpKeys % kKpp == 0, "lane map");
};

template <typename T, int DH, int ROWS>
constexpr int dec_smem_bytes() {  // the warps' rings, then their (m, l, acc)
  using D = Dec<T, DH>;
  return D::kWarps * D::kStages * D::kStageBytes +
         D::kWarps * ROWS * (DH + 2) * (int)sizeof(float);
}

template <typename T, int DH, int ROWS>
__global__ void __launch_bounds__(Dec<T, DH>::kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, Strides sq, Strides sk,
                    Strides sv, Strides so, int hkv, int group, int seq_q, int seq_k,
                    int kv_len, int causal, float scale, int n_split, int n_chunks,
                    float* __restrict__ part) {
  using D = Dec<T, DH>;
  constexpr int EPL = D::kEpl, LPK = D::kLpk, KPP = D::kKpp, NP = D::kPasses;
  constexpr int NS = D::kStages, W = D::kWarps, TILE = D::kTile;
  constexpr int NC = (DH + 31) / 32;  // head-dim columns per lane in the combine
  extern __shared__ uint4 smem_dec[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ks = lane / LPK;          // this lane's first key of a warp tile
  const int dc = (lane % LPK) * EPL;  // its first head-dim column
  T* ring = reinterpret_cast<T*>(smem_dec) + warp * NS * D::kStage + ks * DH + dc;
  float* sm_m = reinterpret_cast<float*>(reinterpret_cast<T*>(smem_dec) +
                                         W * NS * D::kStage);
  float* sm_l = sm_m + W * ROWS;
  float* sm_acc = sm_l + W * ROWS;

  const int split = blockIdx.x % n_split;
  const int unit = blockIdx.x / n_split;  // (batch row, kv head, chunk)
  const int chunk = unit % n_chunks;
  const int bh = unit / n_chunks;         // b.Hkv + kvh
  const int kvh = bh % hkv;
  const int b = bh / hkv;
  const int rows_kv = seq_q * group;
  const int r0 = chunk * ROWS;
  const int n_rows = min(ROWS, rows_kv - r0);

  // q in registers; padding rows (past n_rows) score zeros and are dropped
  float qr[ROWS][EPL];
  int qpos[ROWS];
  int q_max = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    qpos[r] = 0;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[r][e] = 0.0f;
    if (r < n_rows) {
      const int g = (r0 + r) / seq_q, i = (r0 + r) % seq_q;
      load16(q + b * sq.b + (int64_t)(kvh * group + g) * sq.h + (int64_t)i * sq.s + dc,
             qr[r]);
      qpos[r] = i;
      q_max = max(q_max, i);
    }
  }

  const int kv_lim = min(kv_len, seq_k);
  int n_tiles = (kv_lim + TILE - 1) / TILE;
  if (causal) n_tiles = min(n_tiles, q_max / TILE + 1);
  const int per_split = (n_tiles + n_split - 1) / n_split;
  const int t_begin = min(n_tiles, split * per_split);
  const int t_end = min(n_tiles, t_begin + per_split);
  const T* kp = k + b * sk.b + (int64_t)kvh * sk.h + dc;  // this lane's column
  const T* vp = v + b * sv.b + (int64_t)kvh * sv.h + dc;

  // this lane's pieces of tile t (keys ks + KPP.p of the warp's 16, K and V)
  // into stage (t - t_begin) % NS; keys at or past kv_lim are zero-filled
  // without a read
  auto fetch = [&](int t) {
    T* dst = ring + ((t - t_begin) % NS) * D::kStage;
    const int key = t * TILE + warp * kWarpKeys + ks;
    const T* kg = kp + (int64_t)key * sk.s;
    const T* vg = vp + (int64_t)key * sv.s;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const bool ok = key + p * KPP < kv_lim;
      cp_async16(dst + p * KPP * DH, ok ? kg + (int64_t)(p * KPP) * sk.s : kp, ok);
      cp_async16(dst + (kWarpKeys + p * KPP) * DH, ok ? vg + (int64_t)(p * KPP) * sv.s : vp,
                 ok);
    }
  };

  float m[ROWS], l[ROWS], acc[ROWS][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.0f;
  }

#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (t_begin + st < t_end) fetch(t_begin + st);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<NS - 2>();  // this lane's pieces of tile t have landed
    // refill the stage this lane read tile t - 1 from; the last groups are
    // empty, which keeps the wait above uniform
    if (t + NS - 1 < t_end) fetch(t + NS - 1);
    cp_async_commit();
    const T* sK = ring + ((t - t_begin) % NS) * D::kStage;
    const T* sV = sK + kWarpKeys * DH;
    const int key0 = t * TILE + warp * kWarpKeys + ks;  // this lane's key, pass 0

    float s[ROWS][NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float kf[EPL];
      lds16(sK + p * KPP * DH, kf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[r][e], kf[e], d);
        s[r][p] = d;
      }
    }
    // each score summed over its key's LPK lanes; the butterfly adds
    // commutative pairs, so every lane of the key gets the same bits
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int p = 0; p < NP; ++p) s[r][p] += __shfl_xor_sync(0xffffffffu, s[r][p], off);

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      bool ok[NP];
      float mx = kNegInf;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int kj = key0 + p * KPP;
        ok[p] = kj < kv_lim && (!causal || qpos[r] >= kj);
        s[r][p] = ok[p] ? s[r][p] * scale : kNegInf;
        mx = fmaxf(mx, s[r][p]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        s[r][p] = ok[p] ? expf(s[r][p] - m_new) : 0.0f;
        sum += s[r][p];
      }
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float vf[EPL];
      lds16(sV + p * KPP * DH, vf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pr = round_to(s[r][p], T());  // p in v's dtype
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the warp's key slots (lanes ks and ks ^ 1, 2, ...), then lanes
  // 0 .. LPK - 1 hold the warp's (m, l, acc)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mm = fmaxf(m[r], m2);
      const float a = expf(m[r] - mm), a2 = expf(m2 - mm);
      l[r] = a * l[r] + a2 * l2;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[r][e] = a * acc[r][e] + a2 * __shfl_xor_sync(0xffffffffu, acc[r][e], off);
      m[r] = mm;
    }
  if (lane < LPK) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (lane == 0) {
        sm_m[warp * ROWS + r] = m[r];
        sm_l[warp * ROWS + r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[(warp * ROWS + r) * DH + dc + e] = acc[r][e];
    }
  }
  __syncthreads();

  const int64_t rows_total = (int64_t)(gridDim.x / (n_split * n_chunks)) * rows_kv;
  const int64_t row0 = (int64_t)bh * rows_kv + r0;  // this chunk's first row
  float* pm = part + n_split * rows_total * DH;      // acc first: float4-aligned
  float* pl = pm + n_split * rows_total;
  unsigned* arrivals = reinterpret_cast<unsigned*>(pl + n_split * rows_total);
  auto store = [&](int r, int d, float x) {
    const int g = (r0 + r) / seq_q, i = (r0 + r) % seq_q;
    o[b * so.b + (int64_t)(kvh * group + g) * so.h + (int64_t)i * so.s + d] =
        from_float<T>(x);
  };
  // the warps in warp order: the output, or this split's partial
  for (int idx = threadIdx.x; idx < n_rows * DH; idx += D::kThreads) {
    const int r = idx / DH, d = idx % DH;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mm = fmaxf(mm, sm_m[w * ROWS + r]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float wt = expf(sm_m[w * ROWS + r] - mm);
      ll += wt * sm_l[w * ROWS + r];
      aa += wt * sm_acc[(w * ROWS + r) * DH + d];
    }
    if (n_split == 1) {
      store(r, d, aa / fmaxf(ll, 1e-30f));
    } else {
      const int64_t pr = split * rows_total + row0 + r;
      part[pr * DH + d] = aa;
      if (d == 0) {
        pm[pr] = mm;
        pl[pr] = ll;
      }
    }
  }
  if (n_split == 1) return;

  // the last split of this (batch row, kv head, chunk) to arrive combines
  // them all, in split order
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + unit, 1u) == (unsigned)(n_split - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a warp a row, lanes over the splits (m, l) and over the head dim (acc);
  // the partials are read past L1 (__ldcg): other CTAs wrote them
  for (int r = warp; r < n_rows; r += W) {
    const int64_t pr = row0 + r;
    // lane s holds split s's m and l (the first 32 splits: one round trip
    // for the max and the weights)
    const bool has = lane < n_split;
    const float m_first = has ? __ldcg(pm + lane * rows_total + pr) : kNegInf;
    const float l_first = has ? __ldcg(pl + lane * rows_total + pr) : 0.0f;
    float mm = m_first;
    for (int sp = lane + 32; sp < n_split; sp += 32)
      mm = fmaxf(mm, __ldcg(pm + sp * rows_total + pr));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float ll = 0.0f, aa[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) aa[c] = 0.0f;
    for (int s0 = 0; s0 < n_split; s0 += 32) {
      float ws = expf(m_first - mm), ls = l_first;  // split s0 + lane's
      if (s0 > 0) {
        const bool in = s0 + lane < n_split;
        const int64_t at = (s0 + lane) * rows_total + pr;
        ws = in ? expf(__ldcg(pm + at) - mm) : 0.0f;
        ls = in ? __ldcg(pl + at) : 0.0f;
      }
      const int n = min(32, n_split - s0);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {  // split order
        const float w = __shfl_sync(0xffffffffu, ws, j);
        ll += w * __shfl_sync(0xffffffffu, ls, j);
        const float* pa = part + ((s0 + j) * rows_total + pr) * DH;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (lane + 32 * c < DH) aa[c] += w * __ldcg(pa + lane + 32 * c);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane + 32 * c < DH) store(r, lane + 32 * c, aa[c] / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int DH, int ROWS>
int launch_decode(const void* q, const void* k, const void* v, void* o, int batch,
                  int hkv, int group, int seq_q, int seq_k, int kv_len, int causal,
                  float scale, const int64_t* st, int n_split, float* part,
                  cudaStream_t stream) {
  const int smem = dec_smem_bytes<T, DH, ROWS>();
  auto kern = flash_decode_kernel<T, DH, ROWS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (seq_q * group + ROWS - 1) / ROWS;
  const int64_t units = (int64_t)batch * hkv * n_chunks;
  const int64_t blocks = units * n_split;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (n_split > 1) {  // the arrival counters, after the partials: zero them
    const int64_t rows_total = (int64_t)batch * hkv * group * seq_q;
    err = cudaMemsetAsync(part + n_split * rows_total * (DH + 2), 0,
                          units * sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)blocks, Dec<T, DH>::kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, hkv, group, seq_q, seq_k, kv_len, causal, scale,
      n_split, n_chunks, part);
  return cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int hq,
           int hkv, int seq_q, int seq_k, int kv_len, int causal, float scale,
           const int64_t* st, int n_split, float* part, cudaStream_t stream) {
  const int group = hq / hkv;
  if (seq_q <= kDecMaxSq) {
    if (seq_q * group == 1)
      return launch_decode<T, DH, 1>(q, k, v, o, batch, hkv, group, seq_q, seq_k,
                                     kv_len, causal, scale, st, n_split, part,
                                     stream);
    return launch_decode<T, DH, kDecRows>(q, k, v, o, batch, hkv, group, seq_q, seq_k,
                                          kv_len, causal, scale, st, n_split, part,
                                          stream);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {  // prefill: the tensor cores
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
  } else {  // float32 prefill: FMA
    const size_t smem = smem_floats<DH>() * sizeof(float);
    auto kern = flash_attention_kernel<T, DH>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq_q + kBQ - 1) / kBQ, hq, batch);
    kern<<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, Strides{st[0], st[1], st[2]},
        Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
        Strides{st[9], st[10], st[11]}, group, seq_q, seq_k, kv_len, causal, scale);
    return cudaGetLastError();
  }
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o, int batch,
                int hq, int hkv, int seq_q, int seq_k, int kv_len, int causal,
                float scale, const int64_t* st, int n_split, float* part,
                cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, batch, hq, hkv, seq_q, seq_k, kv_len, causal,
                           scale, st, n_split, part, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, batch, hq, hkv, seq_q, seq_k, kv_len, causal,
                           scale, st, n_split, part, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, hq, hkv, seq_q, seq_k, kv_len, causal,
                           scale, st, n_split, part, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, hq, hkv, seq_q, seq_k, kv_len, causal,
                            scale, st, n_split, part, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int dec_tile(int dh, int* tile) {
  switch (dh) {
    case 16: *tile = Dec<T, 16>::kTile; return cudaSuccess;
    case 32: *tile = Dec<T, 32>::kTile; return cudaSuccess;
    case 64: *tile = Dec<T, 64>::kTile; return cudaSuccess;
    case 128: *tile = Dec<T, 128>::kTile; return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The decode kernel's geometry for dtype (0 float32, 1 bfloat16) and dh, in
// out[0..2]: the largest seq_q it takes, the query rows a CTA holds (when a
// kv head serves more than one; with one, its CTA holds that one, in the
// same number of chunks) and the keys of a tile.  The wrapper's split policy
// and its sizing of `part` read them.
int flash_decode_geometry(int dtype, int dh, int* out) {
  out[0] = kDecMaxSq;
  out[1] = kDecRows;
  if (dtype == 0) return dec_tile<float>(dh, out + 2);
  if (dtype == 1) return dec_tile<__nv_bfloat16>(dh, out + 2);
  return cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (b, h, s) of q,
// k, v and o in that order; Dh is contiguous in all four, and every pointer and
// stride is 16-byte aligned (the wrapper checks both).  seq_q <= 64 runs the
// decode kernel, which splits each row's key tiles over n_split CTAs; with
// n_split > 1 they leave acc, m and l in `part` (n_split * batch * hq * seq_q
// * (dh + 2) float32, in that order) followed by their arrival counters
// (batch * hkv * ceil(seq_q * hq / hkv / rows) unsigned, rows from
// flash_decode_geometry, zeroed here on `stream`), allocated by the caller.
// seq_q > 64 takes n_split 1.
int flash_attention(const void* q, const void* k, const void* v, void* o, int dtype,
                    int dh, int batch, int hq, int hkv, int seq_q, int seq_k, int kv_len,
                    int causal, float scale, const int64_t* strides, int n_split,
                    void* part, void* stream) {
  if (batch == 0 || hq == 0 || seq_q == 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || kv_len < 1 || seq_k < 1 || n_split < 1 ||
      (n_split > 1 && (seq_q > kDecMaxSq || part == nullptr)))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, o, batch, hq, hkv, seq_q, seq_k, kv_len,
                              causal, scale, strides, n_split, (float*)part,
                              (cudaStream_t)stream);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, batch, hq, hkv, seq_q, seq_k,
                                      kv_len, causal, scale, strides, n_split,
                                      (float*)part, (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
