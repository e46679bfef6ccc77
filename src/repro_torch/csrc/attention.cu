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
// qwen1.5-0.5b, 0.07 ms at the 989 TFLOP/s of the bf16 tensor cores; 2.2e12
// and 2.22 ms at 1 x 32768).  At Dh 64 the exponentials are an equal floor:
// a score costs 4.Dh = 256 tensor-core flops (1/16 of an SM's clock) and one
// exp2, of which the SM's MUFU units give 16 a clock (also 1/16), so 8.6e9
// exp2 at 1 x 32768 take 2.22 ms too, and a kernel that runs the softmax
// and the products one after the other cannot go under about twice the
// bound.  In decode (Sq <= 64), the bytes of the K/V cache (68 MB per layer
// at 8 x 2080 keys, 134 MB at 1 x 32784: 0.020 and 0.040 ms at 3.35 TB/s).
//
// What the design does about it.  Prefill (Sq > 64): one CTA per (query
// block, q head, batch row) walks the key tiles in order, with an online
// softmax.  bf16 at Dh 64 and 128 runs flash_prefill_wgmma_kernel, built
// so that one tile's softmax runs while the tensor cores work on another:
// a producer warpgroup feeds K / V tiles of 128 keys by TMA through a ring
// of mbarrier-guarded stages; two (Dh 128) or three (Dh 64) consumer
// warpgroups of 64 query rows run S = Q.K^T and O += P.V on wgmma, take
// turns to issue them (named barriers in a ring), and each runs tile t's
// softmax while its P.V of tile t - 1 is on the tensor cores; three
// consumers at Dh 64 (192-row blocks) cut the K / V re-reads from L2 per
// flop by a third.  bf16 at Dh 16 and 32 runs flash_attention_mma_kernel
// (mma.sync, 64-key tiles double-buffered by cp.async), float32 the FMA
// kernel (flash_attention_kernel: 256 threads stage Q once and each K/V
// tile in shared memory, each thread owning a 4 x 4 block of the score tile
// and a 4-row slice of the accumulator); prefill_route holds that rule, and
// the wrapper reads it.  Decode (Sq <= 64,
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>
#include <type_traits>

namespace {

constexpr int kBQ = 64;        // query rows per CTA of the FMA kernel
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 columns
static_assert(kBQ == kBK, "load_tile stages kBK rows for Q as well");
constexpr float kNegInf = -1.0e30f;
constexpr float kNegInfinity = -std::numeric_limits<float>::infinity();

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

// ---- bf16 prefill at Dh 64 and 128: wgmma, TMA, warp-specialised ----------
// One CTA per (block of 64.kConsumers query rows, q head, batch row), of
// 1 + kConsumers warpgroups.  Warpgroup 0 is the producer: after setmaxnreg
// gives its registers away, one thread loads Q once and then each 128-key K
// and V tile through TMA into a ring of stages (128-byte swizzle; a row of
// Dh 128 is two 64-column panels), each stage with a "full" mbarrier for K,
// one for V and an "empty" one that every consumer arrives on.  The others
// are consumers, 64 query rows each: S = Q.K^T by wgmma m64n128k16 with
// both operands K-major in shared memory, the online softmax on the
// accumulator, then O += P.V by wgmma m64nDHk16 with P from registers (S's
// float pairs packed to bf16x2 in place: p's rounding to v's dtype) and V
// MN-major in shared memory (the transpose bit).  In each step a consumer
// issues S for tile t, rescales O, issues P.V for tile t - 1, and runs
// tile t's softmax while that product is on the tensor cores.  The
// consumers take turns to issue (named barriers 1.., in a ring: FA3's
// "ping-pong"), so one's softmax runs while another's products run.  A
// stage is released only after the P.V product that read it is done.  TMA
// zero-fills the query rows past seq_q and the keys past kv_lim (the K / V
// maps end there: those keys are never read); the kv_len and causal masks
// are computed only on the tiles that cross them.  All consumers take the
// same turns (the ring needs it), but each computes only the tiles it
// needs: none if its rows all lie past seq_q, none wholly above its causal
// diagonal.  Inside a tile, a warp's keys above its diagonal score -inf.
constexpr int kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2;

// The prefill kernel of a dtype (0 float32, 1 bfloat16) and head dim; the
// wrapper reads the same rule through flash_prefill_route.
constexpr int prefill_route(int dtype, int dh) {
  return dtype == 0 ? kRouteFma : (dh == 64 || dh == 128) ? kRouteWgmma : kRouteMma;
}

template <int DH>
struct Wg {
  static constexpr int kConsumers = DH == 64 ? 3 : 2;  // warpgroups of 64 query rows
  static constexpr int kRows = 64 * kConsumers;        // query rows a CTA
  static constexpr int kKeys = 128;                    // keys a tile
  static constexpr int kPanel = kKeys * 128;   // bytes of a K / V tile's 64 columns
  static constexpr int kQPanel = kRows * 128;  // ... and of Q's
  static constexpr int kTile = DH / 64 * kPanel;
  static constexpr int kQTile = DH / 64 * kQPanel;
  static constexpr int kStages = 3;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kBars = 1 + 3 * kStages;  // Q full; K full, V full, empty
  // 1024 bytes of slack to align the swizzled tiles to 1024
  static constexpr int kSmem = 1024 + kQTile + 2 * kStages * kTile + 8 * kBars;
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
                "the warpgroups' registers fit the SM's 64K");
  static_assert(kSmem <= 232448, "a CTA has at most 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// waits until the phase of parity `parity` of the barrier has completed
// (no __trap on a timeout here: with one, ptxas stops giving the consumers
// the registers setmaxnreg raises them to, and Dh 128 spills)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the box at (c0, c1, c2, c3) of a 4-D map into shared dst; completes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// named barrier `id` between two consumer warpgroups, one of which syncs
// on it while the other arrives (256 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of r across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address addr
// (1024-aligned atoms of 8 rows x 128 bytes): lbo and sbo in bytes
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A.B^T, m64n128k16: A [64 x 16] and B [128 x 16] both K-major in
// shared memory (descriptors da, db); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A.B, m64n64k16: A [64 x 16] bf16 from registers (a: the
// accumulator layout's pairs, packed), B [16 x 64] MN-major in shared memory
// (descriptor db, transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d += A.B, m64n128k16: A [64 x 16] bf16 from registers (a: the
// accumulator layout's pairs, packed), B [16 x 128] MN-major in shared memory
// (descriptor db, transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}


template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// The online softmax of one tile on a consumer thread's S fragment: s[4j +
// 2r + e] is row row0 + 8r, key k0 + 8j + col0 + e.  Scores stay raw; the
// exponent folds the scale in, exp2(s.c - m.c) with c = scale.log2(e): one
// FFMA and one ex2 a score.  l holds this thread's share of each row sum
// (its 32 keys of every tile), summed over the row's four lanes at the end.
// With `masked`, keys at or past kv_lim and, causally, past the row score
// -inf.  Sums and maxima run in a fixed order: a relaunch is bit-identical.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int row0, int col0,
                                             int kv_lim, int causal, bool masked, float c) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + col0 + (e & 1);
        if (kj >= kv_lim || (causal && kj > row0 + 8 * (e >> 1)))
          s[4 * j + e] = kNegInfinity;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx[4] = {m[r], m[r], m[r], m[r]};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx[j & 3] = fmaxf(mx[j & 3], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    float mn = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    mn = fmaxf(mn, __shfl_xor_sync(0xffffffffu, mn, 1));
    mn = fmaxf(mn, __shfl_xor_sync(0xffffffffu, mn, 2));
    // every row holds a real key in tile 0 (key 0), so mn is finite from
    // there on and alpha is 0 at tile 0 (m starts at -1e30)
    alpha[r] = ex2((m[r] - mn) * c);
    m[r] = mn;
    const float mc = mn * c;
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * r + e];
        x = ex2(fmaf(x, c, -mc));
        sum[j & 3] += x;
      }
    l[r] = l[r] * alpha[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
  }
}

template <int DH>
__global__ void __launch_bounds__(Wg<DH>::kThreads, 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o, Strides so, int group, int seq_q,
                           int kv_lim, int causal, float scale2) {
  using G = Wg<DH>;
  constexpr int NS = G::kStages;
  constexpr int KS = DH / 16;  // k steps of S = Q.K^T, 4 to a 64-column panel
  extern __shared__ uint4 smem_wg[];
  // Q, then stage s's K at base + kQTile + 2s.kTile and its V after it
  const uint32_t base = (smem_u32(smem_wg) + 1023) & ~1023u;
  const uint32_t bars = base + G::kQTile + 2 * NS * G::kTile;
  const uint32_t q_full = bars;
  auto k_tile = [&](int st) { return base + G::kQTile + 2 * st * G::kTile; };
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + NS + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * NS + st); };

  const int qb = gridDim.x - 1 - blockIdx.x;  // heavier causal blocks first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qb * G::kRows;
  int n_tiles = (kv_lim + G::kKeys - 1) / G::kKeys;
  if (causal) n_tiles = min(n_tiles, (min(q0 + G::kRows, seq_q) - 1) / G::kKeys + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), G::kConsumers);  // one thread of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, G::kQTile);
#pragma unroll
      for (int p = 0; p < DH / 64; ++p)
        tma_load(base + p * G::kQPanel, &tm_q, q_full, 64 * p, q0, head, b);
      const int hk = head / group;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty(st), (t / NS - 1) & 1);  // tile t - NS is done
        const uint32_t dk = k_tile(st), dv = dk + G::kTile;
        mbar_expect_tx(k_full(st), G::kTile);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p)
          tma_load(dk + p * G::kPanel, &tm_k, k_full(st), 64 * p, t * G::kKeys, hk, b);
        mbar_expect_tx(v_full(st), G::kTile);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p)
          tma_load(dv + p * G::kPanel, &tm_v, v_full(st), 64 * p, t * G::kKeys, hk, b);
      }
    }
  } else {  // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int row0 = q0 + 64 * c + 16 * warp + (lane >> 2);  // and row0 + 8
    const int col0 = 2 * (lane & 3);  // first column of each 8-column group
    const int warp_row = q0 + 64 * c + 16 * warp;
    // the tiles this warpgroup computes: none when its rows all lie past
    // seq_q (a ragged last block), and causally none wholly above its last
    // row; on the others it only takes its turns and releases their stages
    const int last_row = min(q0 + 64 * c + 63, seq_q - 1);
    const int n_live = last_row < q0 + 64 * c ? 0
                       : causal                ? min(n_tiles, last_row / G::kKeys + 1)
                                               : n_tiles;
    // the K-major descriptors step 32 bytes a k step inside a 128-byte panel
    const uint64_t dq = wgmma_desc(base + c * 64 * 128, 16, 1024);
    float s[64], acc[DH / 2];
    uint32_t p[32];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;

    auto gemm_s = [&](int st) {  // S = Q.K^T over stage st's K
      const uint64_t dk = wgmma_desc(k_tile(st), 16, 1024);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t in_panel = (ks & 3) * 32;
        wgmma_ss_n128(s, dq + (((ks >> 2) * G::kQPanel + in_panel) >> 4),
                      dk + (((ks >> 2) * G::kPanel + in_panel) >> 4), ks > 0);
      }
      wgmma_commit();
    };
    auto gemm_pv = [&](int st) {  // O += P.V over stage st's V, 16 keys a step
      const uint64_t dv = wgmma_desc(k_tile(st) + G::kTile, G::kPanel, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G::kKeys / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        wgmma_pv<DH>(acc, a, dv + ((kk * 16 * 128) >> 4));
      }
      wgmma_commit();
      fence_regs(p);
    };
    auto masked = [&](int t) {  // does tile t hold a key this warp masks?
      const int k0 = t * G::kKeys;
      return k0 + G::kKeys > kv_lim || (causal && k0 + G::kKeys - 1 > warp_row);
    };
    auto pack = [&]() {  // P in the A fragment layout: p's rounding to bf16
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };
    // Turns: consumer c issues its products after bar_sync(turn) and then
    // lets the next one issue (bar_arrive(next)), in a ring; consumer 0
    // goes first.  Every consumer takes n_tiles + 1 turns: S of tile 0;
    // S of tile t with P.V of tile t - 1; P.V of the last tile.  Past its
    // n_live tiles a turn issues nothing and only releases the stage of
    // tile t - 1, which every turn t < n_tiles does.  The last consumer's
    // last turn lets nobody on: nobody waits on a later one.
    const int turn = 1 + c, next = 1 + (c + 1) % G::kConsumers;
    auto pass_on = [&](int t) {
      if (c != G::kConsumers - 1 || t < n_tiles) bar_arrive(next);
    };
    auto release = [&](int t) {  // after turn t: tile t - 1's stage is read
      if (t >= 1 && t < n_tiles && tid == 0) mbar_arrive(empty((t - 1) % NS));
    };
    if (c == G::kConsumers - 1) bar_arrive(1);
    int t = 0;
    if (n_live > 0) {
      mbar_wait(q_full, 0);
      mbar_wait(k_full(0), 0);
      bar_sync(turn);
      gemm_s(0);
      pass_on(0);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, m, l, alpha, 0, row0, col0, kv_lim, causal, masked(0), scale2);
      pack();
      for (t = 1; t < n_live; ++t) {
        const int st = t % NS, sp = (t - 1) % NS;
        mbar_wait(k_full(st), (t / NS) & 1);
        bar_sync(turn);
        gemm_s(st);
        rescale();
        mbar_wait(v_full(sp), ((t - 1) / NS) & 1);
        gemm_pv(sp);
        pass_on(t);
        wgmma_wait<1>();  // S of tile t is done; P.V of tile t - 1 runs on
        fence_regs(s);
        softmax_tile(s, m, l, alpha, t * G::kKeys, row0, col0, kv_lim, causal, masked(t),
                     scale2);
        wgmma_wait<0>();
        fence_regs(acc);
        release(t);
        pack();
      }
      const int sl = (n_live - 1) % NS;  // turn n_live: P.V of the last live tile
      bar_sync(turn);
      rescale();
      mbar_wait(v_full(sl), ((n_live - 1) / NS) & 1);
      gemm_pv(sl);
      pass_on(n_live);
      wgmma_wait<0>();
      fence_regs(acc);
      release(n_live);
      t = n_live + 1;
    }
    for (; t <= n_tiles; ++t) {
      bar_sync(turn);
      pass_on(t);
      // tile t - 1 has been loaded, so this arrival is on its phase
      if (t >= 1 && t < n_tiles) mbar_wait(k_full((t - 1) % NS), ((t - 1) / NS) & 1);
      release(t);
    }

    __nv_bfloat16* op = o + b * so.b + head * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qi = row0 + 8 * r;
      if (qi >= seq_q) continue;
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + (int64_t)qi * so.s + 8 * j + col0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime: the library
// links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (Dh, S, H, B) of a bf16 operand [B, H, S, Dh] with element
// strides st = (b, h, s), its S cut at `rows`: a box of 64 columns x
// box_rows rows with the 128-byte swizzle, zero-filled past every extent.
int tensor_map(CUtensorMap* map, const void* ptr, int dh, int rows, int heads, int batch,
               const int64_t* st, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[0] * 2};
  // a dimension of extent 1 is never stepped: where the view's stride is
  // not one TMA takes (the wrapper checks only those it steps), pack it
  cuuint64_t dense = (cuuint64_t)dh * 2;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1 && (strides[i] == 0 || strides[i] % 16)) strides[i] = dense;
    dense = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
int launch_prefill_wgmma(const void* q, const void* k, const void* v, void* o, int batch,
                         int hq, int hkv, int seq_q, int seq_k, int kv_len, int causal,
                         float scale, const int64_t* st, cudaStream_t stream) {
  using G = Wg<DH>;
  // the K / V maps end at kv_lim: TMA never reads the keys past it
  const int kv_lim = min(kv_len, seq_k);
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, DH, seq_q, hq, batch, st, G::kRows);
  if (err == cudaSuccess) err = tensor_map(&mk, k, DH, kv_lim, hkv, batch, st + 3, G::kKeys);
  if (err == cudaSuccess) err = tensor_map(&mv, v, DH, kv_lim, hkv, batch, st + 6, G::kKeys);
  if (err != cudaSuccess) return err;
  auto kern = flash_prefill_wgmma_kernel<DH>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_q + G::kRows - 1) / G::kRows, hq, batch);
  kern<<<grid, G::kThreads, G::kSmem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, Strides{st[9], st[10], st[11]}, hq / hkv, seq_q, kv_lim,
      causal, scale * kLog2e);
  return cudaGetLastError();
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
  constexpr int route = prefill_route(std::is_same<T, float>::value ? 0 : 1, DH);
  if constexpr (route == kRouteWgmma) {
    return launch_prefill_wgmma<DH>(q, k, v, o, batch, hq, hkv, seq_q, seq_k, kv_len, causal,
                                    scale, st, stream);
  } else if constexpr (route == kRouteMma) {
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

// The kernel that runs a prefill (seq_q > 64) of dtype (0 float32, 1
// bfloat16) at head dim dh, in *route: 0 the FMA kernel, 1 the mma.sync
// kernel, 2 flash_prefill_wgmma_kernel.  The wrapper counts launches by it.
int flash_prefill_route(int dtype, int dh, int* route) {
  if ((dtype != 0 && dtype != 1) || (dh != 16 && dh != 32 && dh != 64 && dh != 128))
    return cudaErrorInvalidValue;
  *route = prefill_route(dtype, dh);
  return cudaSuccess;
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
