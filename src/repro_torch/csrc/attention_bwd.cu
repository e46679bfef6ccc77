// K6's backward for Hopper (sm_90a), plain C interface.
//
// flash_attention_bwd computes, for q, o, dO: [B, Hq, Sq, Dh] and k, v:
// [B, Hkv, Sk, Dh] (each addressed through element strides for B, H and S,
// Dh contiguous), the gradients of o = softmax(scale . q k^T) v, scale =
// 1 / sqrt(Dh), with the keys j <= i of query i under `causal` (positions
// counted from 0 on both sides, K6's convention) and GQA (q head h reads kv
// head h / group):
//   L_i = logsumexp_j(scale . <q_i, k_j>),   D_i = <dO_i, o_i>,
//   P = exp(scale . q k^T - L),   dV = P^T dO,   dS = P o (dO v^T - D),
//   dQ = scale . dS k,   dK = scale . dS^T q,
// dK and dV of a kv head summed over the q heads of its group.  The JAX
// package has no backward kernel: its model differentiates the einsum
// attention (src/repro/models/transformer.py : _attention_block) with XLA,
// and its Pallas kernel (src/repro/kernels/attention/kernel.py :
// flash_attention_pallas) has no VJP.  This is the backward of K6's forward
// (csrc/attention.cu), for training.
//
// What bounds it on an H100: operations.  Five products of 2.Dh flops per
// (query, key) pair, the pairs under the causal mask counted: 3.44e11 flops
// a layer at 4 x 16 heads x 4,096 tokens, Dh 64 (qwen1.5-0.5b's training
// microbatch), 0.35 ms at the 989 TFLOP/s of the bf16 tensor cores.
//
// What the design does about it.  Two kernels a route, dQ first, then dK /
// dV, no float atomics, so that a relaunch gives the same bits; both work
// in base 2 (exp2 of scores scaled by scale.log2(e)), and a float32 scratch
// [B, Hq, ld] holds each query row's L in that base and D.
//
// Route wgmma (bf16 at Dh 64 and 128 with Sq > 64: wherever the forward ran
// flash_prefill_wgmma_kernel, whose training instance writes L to the
// scratch, so that nothing here rebuilds it).  Both kernels are
// warp-specialised: warpgroup 0 is a producer that gives its registers away
// by setmaxnreg and has one thread issue TMA loads (128-byte swizzle; a row
// of Dh 128 is two 64-column panels) into a ring of stages guarded by
// mbarriers; consumer warpgroups of 64 rows each run every product on
// wgmma, the score products with both operands in shared memory, the
// accumulating ones with the bf16 A operand from registers (the float
// accumulator's pairs packed in place: P and dS rounded to bf16, as the
// mma.sync route rounds them) and B read MN-major through the transpose bit.
// * bwd_dkdv_wgmma_kernel, one CTA of two consumers per (block of 128 keys,
//   kv head, batch row): K and V loaded once; 64-row tiles of Q and dO with
//   their slices of L and D streamed, for each q head of the group in
//   order, and only the tiles at or below the causal diagonal; S^T = K.Q^T
//   and dP^T = V.dO^T, P^T = exp2(S^T.c - L) and dS^T = P^T o (dP^T - D) in
//   registers, dV += P^T.dO and dK += dS^T.Q.  dK and dV stay in registers
//   for the whole walk and are written once.
// * bwd_dq_wgmma_kernel, one CTA per (block of query rows, q head, batch
//   row), three consumers at Dh 64 and two at 128: D = <dO, o> in its
//   prologue (written for the dK / dV kernel), then 128-key tiles of K and
//   V streamed, each in two halves of 64 keys: S = Q.K^T, dP = dO.V^T, dS,
//   dQ += dS.K.
// Seven products where five are counted (S and dP in both kernels).  The
// CTAs run in groups of blocks, heaviest first, a group's blocks of a head
// side by side (block_order).  The masks (causal, ragged Sq and Sk) are one
// warp-uniform branch a tile with selects inside, a masked score set to
// -inf before its exp2: written per element as `if (...) p = 0`, they
// compiled into a convergence block each and took a third of the pair's
// time.
//
// Route mma_sync (bf16 otherwise) and fma (float32): L is computed here
// rather than read, since those forwards (the mma.sync and FMA prefill
// kernels, and the split-KV decode kernel at Sq <= 64, whose splits would
// each hold a part of L) do not write it:
// * the dQ kernel, one CTA per (block of 64 queries, q head, batch row),
//   walks the key tiles twice: first for each row's logsumexp L (an online
//   max and sum, as the forward's), which it writes with D to the scratch,
//   then for dQ += dS k, recomputing P from L;
// * the dK / dV kernel, one CTA per (block of 64 keys, kv head, batch row),
//   walks the query tiles that can see its keys, for each q head of its
//   group in turn, and sums dV += P^T dO and dK += dS^T q in that fixed
//   order, reading L and D from the scratch.
// bf16 runs on mma.sync m16n8k16 (bf16 in, float32 accumulate; 4 warps of
// 16 rows a CTA, tiles of 64 double-buffered by cp.async), as the
// forward's mma.sync kernel: P is rounded to bf16 for the dV product, dS
// for the dQ and dK products, as the forward rounds p before its PV
// product.  float32 runs on FMA (256 threads a CTA, each owning a 4 x 4
// block of the 64 x 64 score tile and a 4-row slice of its accumulators).
// Every route takes any Sq and Sk: the ragged tails are zero filled and
// masked here, so the caller pads nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>
#include <type_traits>

namespace {

constexpr int kB = 64;  // rows of a CTA's block, and of a tile of the other side
constexpr int kLdBlock = 128;  // the scratch holds ceil(Sq / 128) * 128 rows a (row, head)
constexpr int kDecodeMaxSq = 64;  // attention.cu's kDecMaxSq: no wgmma forward at or below
constexpr int kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2;
constexpr int kThreads = 256;     // FMA kernels: 16 x 16, ty owns 4 rows
constexpr int kMmaThreads = 128;  // mma.sync kernels: 4 warps of 16 rows
constexpr float kNegInf = -1.0e30f;
constexpr float kNegInfinity = -std::numeric_limits<float>::infinity();
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, h, s;  // element strides; Dh is contiguous
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;  // [batch, hq, ld] each
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int group, seq_q, seq_k, causal, ld;
  float scale, scale2;  // 1 / sqrt(Dh), and times log2(e)
};

// ---- float32 on FMA -------------------------------------------------------

// Rows [row0, row0 + 64) of a float32 [rows, DH] operand into dst[64][DH + 4];
// rows at or past n_rows are zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int64_t s_stride,
                                          int row0, int n_rows) {
  constexpr int kPerRow = DH / 4;
  for (int idx = threadIdx.x; idx < kB * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n_rows)
      v = __ldg(reinterpret_cast<const float4*>(base + (int64_t)(row0 + r) * s_stride + c));
    *reinterpret_cast<float4*>(dst + r * (DH + 4) + c) = v;
  }
}

// s[i][j] = <A[ty.4 + i], B[tx + 16 j]> over DH, both [64][DH + 4]
template <int DH>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* A, const float* B) {
  constexpr int LD = DH + 4;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

template <int DH>
constexpr int kGroups = (DH / 4 + 15) / 16;  // float4 column groups a thread owns

// acc[i][g][:] += sum_kk P[ty.4 + i][kk] . V[kk][(tx + 16 g).4 + :], P
// [64][64 + 4], V [64][DH + 4]
template <int DH>
__device__ __forceinline__ void acc_tile(float (&acc)[4][kGroups<DH>][4], const float* P,
                                         const float* V) {
  constexpr int LD = DH + 4;
  constexpr int PLD = kB + 4;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int kk = 0; kk < kB; kk += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * PLD + kk);
#pragma unroll
    for (int g = 0; g < kGroups<DH>; ++g) {
      const int col = (tx + 16 * g) * 4;
      if (col < DH) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(V + (kk + u) * LD + col);
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

// Rows of a [64, DH] result block from the accumulators, times `mul`, the
// rows at or past n_rows left out.
template <int DH>
__device__ __forceinline__ void store_acc(float* base, int64_t s_stride, int row0, int n_rows,
                                          const float (&acc)[4][kGroups<DH>][4], float mul) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int g = 0; g < kGroups<DH>; ++g) {
      const int col = (tx + 16 * g) * 4;
      if (col < DH)
        *reinterpret_cast<float4*>(base + (int64_t)r * s_stride + col) =
            make_float4(acc[i][g][0] * mul, acc[i][g][1] * mul, acc[i][g][2] * mul,
                        acc[i][g][3] * mul);
    }
  }
}

template <int DH>
constexpr int fma_smem_bytes() {  // four [64][DH + 4] tiles, two [64][68], L and D
  return (4 * kB * (DH + 4) + 2 * kB * (kB + 4) + 2 * kB) * (int)sizeof(float);
}

__device__ __forceinline__ bool masked(int qi, int kj, int seq_k, int causal) {
  return kj >= seq_k || (causal && qi < kj);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_dq_fma_kernel(Args a) {
  constexpr int LD = DH + 4;
  constexpr int PLD = kB + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kB * LD;
  float* sK = sdO + kB * LD;
  float* sV = sK + kB * LD;
  float* sS = sV + kB * LD;
  float* sD = sS + 2 * kB * PLD;

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* qp = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* op = static_cast<const float*>(a.o) + b * a.so.b + h * a.so.h;
  const float* dop = static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* kp = static_cast<const float*>(a.k) + b * a.sk.b + (h / a.group) * a.sk.h;
  const float* vp = static_cast<const float*>(a.v) + b * a.sv.b + (h / a.group) * a.sv.h;
  const int64_t row = ((int64_t)b * gridDim.y + h) * a.ld + q0;  // scratch offset

  load_tile<DH>(sQ, qp, a.sq.s, q0, a.seq_q);
  load_tile<DH>(sdO, dop, a.sdo.s, q0, a.seq_q);
  load_tile<DH>(sK, op, a.so.s, q0, a.seq_q);  // o, through sK before the walks
  __syncthreads();
  {  // D = <dO, o>: four threads a row, a quarter of Dh each, then two shuffles
    const int r = threadIdx.x >> 2;
    const int part = threadIdx.x & 3;
    float d = 0.0f;
#pragma unroll
    for (int c = part * (DH / 4); c < (part + 1) * (DH / 4); ++c)
      d = fmaf(sdO[r * LD + c], sK[r * LD + c], d);
    d += __shfl_xor_sync(kFull, d, 1);  // commutative pairs: all 4 get one sum
    d += __shfl_xor_sync(kFull, d, 2);
    if (part == 0) {
      sD[r] = d;
      a.delta[row + r] = d;
    }
  }

  int n_tiles = (a.seq_k + kB - 1) / kB;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + kB, a.seq_q) - 1) / kB + 1);

  // pass 1: L, the logsumexp of each row (base 2), by an online max and sum
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // sK is consumed (by D at t = 0)
    load_tile<DH>(sK, kp, a.sk.s, k0, a.seq_k);
    __syncthreads();
    float s[4][4];
    dot_tile<DH>(s, sQ, sK);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(qi, k0 + tx + 16 * j, a.seq_k, a.causal) ? kNegInf : s[i][j] * a.scale2;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      // key 0 is in every row's tile 0, so m_new is finite and a masked
      // score's exp2f is exactly 0
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += exp2f(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = l[i] * exp2f(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = m[i] + log2f(l[i]);
    if (tx == 0) a.lse[row + ty * 4 + i] = lse[i];
  }

  // pass 2: dQ += dS k
  float acc[4][kGroups<DH>][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < kGroups<DH>; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's sK, sV and sS are consumed
    load_tile<DH>(sK, kp, a.sk.s, k0, a.seq_k);
    load_tile<DH>(sV, vp, a.sv.s, k0, a.seq_k);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DH>(s, sQ, sK);
    dot_tile<DH>(dp, sdO, sV);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = masked(q0 + r, k0 + tx + 16 * j, a.seq_k, a.causal)
                            ? 0.0f
                            : exp2f(s[i][j] * a.scale2 - lse[i]);
        sS[r * PLD + tx + 16 * j] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();
    acc_tile<DH>(acc, sS, sK);
  }
  store_acc<DH>(static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.s, q0, a.seq_q,
                acc, a.scale);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_fma_kernel(Args a) {
  constexpr int LD = DH + 4;
  constexpr int PLD = kB + 4;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kB * LD;
  float* sQ = sV + kB * LD;
  float* sdO = sQ + kB * LD;
  float* sP = sdO + kB * LD;
  float* sS = sP + kB * PLD;
  float* sL = sS + kB * PLD;
  float* sD = sL + kB;

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = gridDim.y * a.group;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* kp = static_cast<const float*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const float* vp = static_cast<const float*>(a.v) + b * a.sv.b + hk * a.sv.h;
  load_tile<DH>(sK, kp, a.sk.s, k0, a.seq_k);
  load_tile<DH>(sV, vp, a.sv.s, k0, a.seq_k);

  // the query tiles that can see a key of this block, for each q head of the
  // group in turn
  const int n_qt = (a.seq_q + kB - 1) / kB;
  const int qt0 = a.causal ? min((int)blockIdx.x, n_qt) : 0;
  const int nq = n_qt - qt0;
  float acc_dk[4][kGroups<DH>][4], acc_dv[4][kGroups<DH>][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < kGroups<DH>; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_dk[i][g][c] = acc_dv[i][g][c] = 0.0f;
  for (int it = 0; it < a.group * nq; ++it) {
    const int h = hk * a.group + it / nq;
    const int q0 = (qt0 + it % nq) * kB;
    const float* qp = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
    const float* dop = static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    const int64_t row = ((int64_t)b * hq + h) * a.ld + q0;
    __syncthreads();  // the previous tile's sQ, sdO, sP, sS, sL and sD are consumed
    load_tile<DH>(sQ, qp, a.sq.s, q0, a.seq_q);
    load_tile<DH>(sdO, dop, a.sdo.s, q0, a.seq_q);
    if (threadIdx.x < kB) sL[threadIdx.x] = a.lse[row + threadIdx.x];
    else if (threadIdx.x < 2 * kB) sD[threadIdx.x - kB] = a.delta[row + threadIdx.x - kB];
    __syncthreads();
    // rows: keys ty.4 + i; columns: queries tx + 16 j
    float s[4][4], dp[4][4];
    dot_tile<DH>(s, sK, sQ);
    dot_tile<DH>(dp, sV, sdO);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        // a query row past seq_q has q = dO = 0 and D = 0: it adds nothing
        const float p = a.causal && q0 + c < k0 + r ? 0.0f : exp2f(s[i][j] * a.scale2 - sL[c]);
        sP[r * PLD + c] = p;
        sS[r * PLD + c] = p * (dp[i][j] - sD[c]);
      }
    }
    __syncthreads();
    acc_tile<DH>(acc_dv, sP, sdO);
    acc_tile<DH>(acc_dk, sS, sQ);
  }
  store_acc<DH>(static_cast<float*>(a.dk) + b * a.sdk.b + hk * a.sdk.h, a.sdk.s, k0, a.seq_k,
                acc_dk, a.scale);
  store_acc<DH>(static_cast<float*>(a.dv) + b * a.sdv.b + hk * a.sdv.h, a.sdv.s, k0, a.seq_k,
                acc_dv, 1.0f);
}

// ---- bf16 on mma.sync ---------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
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
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts the copy of rows [row0, row0 + 64) of a bf16 [rows, DH] operand
// into dst[64][DH + 8]; rows at or past n_rows are zero-filled unread.
template <int DH>
__device__ __forceinline__ void fetch_tile(bf16* dst, const bf16* base, int64_t s_stride,
                                           int row0, int n_rows) {
  constexpr int kPerRow = DH / 8;
  for (int idx = threadIdx.x; idx < kB * kPerRow; idx += kMmaThreads) {
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * (DH + 8) + c, ok ? base + (int64_t)(row0 + r) * s_stride + c : base,
               ok);
  }
}

// s[nt][:] = the C fragments of A[16 rows at sA] . B^T[64 rows at sB], both
// [*][DH + 8] bf16 (B's rows are the product's columns)
template <int DH>
__device__ __forceinline__ void mma_abt(float (&s)[kB / 8][4], const bf16* sA, const bf16* sB,
                                        int gid, int tig) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int nt = 0; nt < kB / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const bf16* ar = sA + gid * LD + ks * 16 + tig * 2;
    const uint32_t fa[4] = {ld32(ar), ld32(ar + 8 * LD), ld32(ar + 8), ld32(ar + 8 * LD + 8)};
#pragma unroll
    for (int nt = 0; nt < kB / 8; ++nt) {
      const bf16* br = sB + (nt * 8 + gid) * LD + ks * 16 + tig * 2;
      mma_bf16(s[nt], fa, ld32(br), ld32(br + 8));
    }
  }
}

// acc += P . V: P the float C fragments of a 16 x 64 product (rounded to
// bf16 here, packed in place as A fragments), V [64][DH + 8] bf16 read by
// ldmatrix.trans (its rows are the product's depth)
template <int DH>
__device__ __forceinline__ void mma_pv(float (&acc)[DH / 8][4], const float (&p)[kB / 8][4],
                                       const bf16* sV, int lane) {
  constexpr int LD = DH + 8;
  const int mi = lane >> 3;
#pragma unroll
  for (int j = 0; j < kB / 16; ++j) {  // 16 rows of V per step
    const uint32_t pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    const bf16* vrow = sV + (16 * j + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {  // two n tiles of 8 per ldmatrix
      uint32_t b0, b1, b2, b3;
      const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(vrow + np * 16));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                   : "r"(addr));
      mma_bf16(acc[2 * np], pa, b0, b1);
      mma_bf16(acc[2 * np + 1], pa, b2, b3);
    }
  }
}

// Rows r0 + gid (+ 8) of a bf16 result block from the C fragments, times
// `mul`, the rows at or past n_rows left out.
template <int DH>
__device__ __forceinline__ void store_frag(bf16* base, int64_t s_stride, int row, int n_rows,
                                           const float (&acc)[DH / 8][4], float mul, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= n_rows) continue;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(base + (int64_t)r * s_stride + nt * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[nt][2 * half] * mul, acc[nt][2 * half + 1] * mul);
  }
}

template <int DH>
constexpr int mma_smem_bytes() {  // six [64][DH + 8] bf16 tiles, then 4 x 64 floats
  return 6 * kB * (DH + 8) * (int)sizeof(bf16) + 4 * kB * (int)sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_mma_kernel(Args a) {
  constexpr int LD = DH + 8;
  extern __shared__ uint4 smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);
  bf16* sdO = sQ + kB * LD;
  bf16* sKV = sdO + kB * LD;  // stage s: K at sKV + 2s.kB.LD, V after it
  float* sD = reinterpret_cast<float*>(sKV + 4 * kB * LD);

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // the fragment's row (and + 8)
  const int tig = lane & 3;   // its column pair
  const int r0 = warp * 16;   // the warp's rows in the block
  const bool busy = q0 + r0 < a.seq_q;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* op = static_cast<const bf16*>(a.o) + b * a.so.b + h * a.so.h;
  const bf16* dop = static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk.b + (h / a.group) * a.sk.h;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv.b + (h / a.group) * a.sv.h;
  const int64_t row = ((int64_t)b * gridDim.y + h) * a.ld + q0;

  int n_tiles = (a.seq_k + kB - 1) / kB;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + kB, a.seq_q) - 1) / kB + 1);
  auto fetch_kv = [&](int t, bool with_v) {  // tile t into stage t % 2
    bf16* dst = sKV + (t & 1) * 2 * kB * LD;
    fetch_tile<DH>(dst, kp, a.sk.s, t * kB, a.seq_k);
    if (with_v) fetch_tile<DH>(dst + kB * LD, vp, a.sv.s, t * kB, a.seq_k);
  };
  fetch_tile<DH>(sQ, qp, a.sq.s, q0, a.seq_q);
  fetch_tile<DH>(sdO, dop, a.sdo.s, q0, a.seq_q);
  fetch_kv(0, false);
  cp_async_commit();  // group 0: Q, dO and K's tile 0

  {  // D = <dO, o> from global memory: two threads a row, then one shuffle
    const int r = threadIdx.x >> 1;
    const int part = threadIdx.x & 1;
    float d = 0.0f;
    if (q0 + r < a.seq_q) {
      const bf16* orow = op + (int64_t)(q0 + r) * a.so.s + part * (DH / 2);
      const bf16* drow = dop + (int64_t)(q0 + r) * a.sdo.s + part * (DH / 2);
#pragma unroll
      for (int c = 0; c < DH / 2; c += 2) {
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
        const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
        d = fmaf(dv.x, ov.x, d);
        d = fmaf(dv.y, ov.y, d);
      }
    }
    d += __shfl_xor_sync(kFull, d, 1);
    if (part == 0) {
      sD[r] = d;
      a.delta[row + r] = d;
    }
  }

  // pass 1: L, the logsumexp of each row (base 2), by an online max and sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    // stage (t + 1) % 2 was last read by tile t - 1, behind the barrier that
    // ended its iteration; the group committed last is empty at the end,
    // which keeps the wait uniform
    if (t + 1 < n_tiles) fetch_kv(t + 1, false);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sK = sKV + (t & 1) * 2 * kB * LD;
    // a warp skips the tiles wholly above its rows' diagonal (tile 0 never)
    if (busy && !(a.causal && k0 > q0 + r0 + 15)) {
      float s[kB / 8][4];
      mma_abt<DH>(s, sQ + r0 * LD, sK, gid, tig);
      const bool need_mask = k0 + kB > a.seq_k || (a.causal && k0 + kB - 1 > q0 + r0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows gid and gid + 8
        const int qi = q0 + r0 + gid + 8 * half;
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < kB / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nt][2 * half + e];
            x *= a.scale2;
            if (need_mask && masked(qi, k0 + nt * 8 + tig * 2 + e, a.seq_k, a.causal))
              x = kNegInf;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[half], mx);
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < kB / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += exp2f(s[nt][2 * half + e] - m_new);
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        l[half] = l[half] * exp2f(m[half] - m_new) + sum;
        m[half] = m_new;
      }
    }
    __syncthreads();  // stage t % 2 is consumed
  }
  // rows past seq_q hold zero q (a finite L); a warp wholly past it writes
  // 0, which its zero dO and D turn into no contribution in dK / dV
  float lse[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    lse[half] = busy ? m[half] + log2f(l[half]) : 0.0f;
    if (tig == 0) a.lse[row + r0 + gid + 8 * half] = lse[half];
  }

  // pass 2: dQ += dS k
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.0f;
  fetch_kv(0, true);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    if (t + 1 < n_tiles) fetch_kv(t + 1, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sK = sKV + (t & 1) * 2 * kB * LD;
    const bf16* sV = sK + kB * LD;
    if (busy && !(a.causal && k0 > q0 + r0 + 15)) {
      float s[kB / 8][4], dp[kB / 8][4];
      mma_abt<DH>(s, sQ + r0 * LD, sK, gid, tig);
      mma_abt<DH>(dp, sdO + r0 * LD, sV, gid, tig);
      const bool need_mask = k0 + kB > a.seq_k || (a.causal && k0 + kB - 1 > q0 + r0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qi = q0 + r0 + gid + 8 * half;
        const float d = sD[r0 + gid + 8 * half];
#pragma unroll
        for (int nt = 0; nt < kB / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nt][2 * half + e];
            float p = exp2f(x * a.scale2 - lse[half]);
            if (need_mask && masked(qi, k0 + nt * 8 + tig * 2 + e, a.seq_k, a.causal)) p = 0.0f;
            x = p * (dp[nt][2 * half + e] - d);  // dS
          }
      }
      mma_pv<DH>(acc, s, sK, lane);
    }
    __syncthreads();
  }
  if (busy)
    store_frag<DH>(static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.s,
                   q0 + r0 + gid, a.seq_q, acc, a.scale, tig);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads) bwd_dkdv_mma_kernel(Args a) {
  constexpr int LD = DH + 8;
  extern __shared__ uint4 smem_mma[];
  bf16* sK = reinterpret_cast<bf16*>(smem_mma);
  bf16* sV = sK + kB * LD;
  bf16* sQdO = sV + kB * LD;  // stage s: Q at sQdO + 2s.kB.LD, dO after it
  float* sLD = reinterpret_cast<float*>(sQdO + 4 * kB * LD);  // stage s: L, then D

  const int k0 = blockIdx.x * kB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = gridDim.y * a.group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int r0 = warp * 16;  // the warp's keys in the block
  const bool busy = k0 + r0 < a.seq_k;

  const int n_qt = (a.seq_q + kB - 1) / kB;
  const int qt0 = a.causal ? min((int)blockIdx.x, n_qt) : 0;
  const int nq = n_qt - qt0;
  const int n_it = a.group * nq;
  auto fetch_q = [&](int it) {  // iteration it's Q, dO, L and D into stage it % 2
    const int h = hk * a.group + it / nq;
    const int q0 = (qt0 + it % nq) * kB;
    bf16* dst = sQdO + (it & 1) * 2 * kB * LD;
    fetch_tile<DH>(dst, static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.s, q0,
                   a.seq_q);
    fetch_tile<DH>(dst + kB * LD, static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h,
                   a.sdo.s, q0, a.seq_q);
    if (threadIdx.x < 2 * kB / 4) {  // 16 pieces of 16 bytes for L, 16 for D
      const int piece = threadIdx.x & (kB / 4 - 1);
      const float* src = (threadIdx.x < kB / 4 ? a.lse : a.delta) +
                         ((int64_t)b * hq + h) * a.ld + q0 + piece * 4;
      cp_async16(sLD + (it & 1) * 2 * kB + (threadIdx.x / (kB / 4)) * kB + piece * 4, src, true);
    }
  };
  fetch_tile<DH>(sK, static_cast<const bf16*>(a.k) + b * a.sk.b + hk * a.sk.h, a.sk.s, k0,
                 a.seq_k);
  fetch_tile<DH>(sV, static_cast<const bf16*>(a.v) + b * a.sv.b + hk * a.sv.h, a.sv.s, k0,
                 a.seq_k);
  if (n_it > 0) fetch_q(0);
  cp_async_commit();  // group 0: K, V and iteration 0's tiles

  float acc_dk[DH / 8][4], acc_dv[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[nt][c] = acc_dv[nt][c] = 0.0f;
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) fetch_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + it % nq) * kB;
    const bf16* sQ = sQdO + (it & 1) * 2 * kB * LD;
    const bf16* sdO = sQ + kB * LD;
    const float* sL = sLD + (it & 1) * 2 * kB;
    const float* sD = sL + kB;
    if (busy) {
      // rows: the warp's keys; columns: the tile's queries.  A query row past
      // seq_q has q = dO = 0 and D = 0: it adds nothing
      float s[kB / 8][4], dp[kB / 8][4];
      mma_abt<DH>(s, sK + r0 * LD, sQ, gid, tig);
      mma_abt<DH>(dp, sV + r0 * LD, sdO, gid, tig);
      const bool need_mask = a.causal && q0 < k0 + r0 + 15;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kj = k0 + r0 + gid + 8 * half;
#pragma unroll
        for (int nt = 0; nt < kB / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + tig * 2 + e;
            float& x = s[nt][2 * half + e];
            float p = exp2f(x * a.scale2 - sL[c]);
            if (need_mask && q0 + c < kj) p = 0.0f;
            x = p;                                              // P^T
            dp[nt][2 * half + e] = p * (dp[nt][2 * half + e] - sD[c]);  // dS^T
          }
      }
      mma_pv<DH>(acc_dv, s, sdO, lane);
      mma_pv<DH>(acc_dk, dp, sQ, lane);
    }
    __syncthreads();  // stage it % 2 is consumed
  }
  cp_async_wait<0>();
  if (busy) {
    store_frag<DH>(static_cast<bf16*>(a.dk) + b * a.sdk.b + hk * a.sdk.h, a.sdk.s,
                   k0 + r0 + gid, a.seq_k, acc_dk, a.scale, tig);
    store_frag<DH>(static_cast<bf16*>(a.dv) + b * a.sdv.b + hk * a.sdv.h, a.sdv.s,
                   k0 + r0 + gid, a.seq_k, acc_dv, 1.0f, tig);
  }
}

// ---- bf16 at Dh 64 and 128: wgmma, TMA, warp-specialised ------------------
// The rule the wrapper reads (flash_attention_bwd_route): wgmma wherever
// attention.cu's prefill ran flash_prefill_wgmma_kernel.
constexpr int bwd_route(int dtype, int dh, int seq_q) {
  return dtype == 0 ? kRouteFma
         : (dh == 64 || dh == 128) && seq_q > kDecodeMaxSq ? kRouteWgmma
                                                         : kRouteMma;
}

// Phase hooks: tools/k6_bwd_probe.py's `phases` variant defines them to
// add each consumer warpgroup's clocks between stamps to a counter a
// phase; here they are empty.
#define BWD_START()
#define BWD_STAMP(i)

// Consumer warpgroups (of 64 rows each) a CTA of each kernel: three dQ
// consumers at Dh 64 (160 registers each) keep the tensor cores busier
// than two; a dK / dV consumer holds two accumulators beside its tile's
// operands, which do not fit in 160 (with three it spilled).
template <int DH>
constexpr int kDqConsumers = DH == 64 ? 3 : 2;
constexpr int kDkdvConsumers = 2;

template <int DH, int NC>
struct Bw {
  static constexpr int kConsumers = NC;
  static constexpr int kBlock = 64 * NC;  // keys (dK / dV) or query rows (dQ) a CTA
  static constexpr int kQTile = 64;       // query rows of a dK / dV stage
  static constexpr int kKTile = 128;      // keys of a dQ stage
  static constexpr int kPanelBlk = kBlock * 128;  // bytes of a block's 64 columns
  static constexpr int kPanelQt = kQTile * 128;   // ... of a dK / dV stage's
  static constexpr int kPanelKt = kKTile * 128;   // ... of a dQ stage's
  static constexpr int kBlk = DH / 64 * kPanelBlk;
  static constexpr int kQt = DH / 64 * kPanelQt;
  static constexpr int kKt = DH / 64 * kPanelKt;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  // dK / dV: K, V, then kStagesKV stages of (Q, dO), then their L and D
  // (256 bytes each), then the barriers (K/V full; full and empty a stage)
  static constexpr int kStagesKV = DH == 64 ? 4 : 3;
  static constexpr int kSmemKV =
      1024 + 2 * kBlk + kStagesKV * (2 * kQt + 512) + 8 * (1 + 2 * kStagesKV);
  // dQ: Q, dO, then kStagesQ stages of (K, V), then the barriers (Q / dO
  // full; K full, V full and empty a stage)
  static constexpr int kStagesQ = DH == 64 ? 3 : 2;
  static constexpr int kSmemQ = 1024 + 2 * kBlk + kStagesQ * 2 * kKt + 8 * (1 + 3 * kStagesQ);
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
                "the warpgroups' registers fit the SM's 64K");
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448,
                "a CTA has at most 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// waits until the phase of parity `parity` of the barrier has completed (no
// __trap on a timeout: with one, ptxas ignores setmaxnreg's registers)
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

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global src into
// shared dst; completes on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// d (+)= A.B^T, m64n64k16: A [64 x 16] and B [64 x 16] both K-major in
// shared memory (descriptors da, db); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
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

// d += A.B, m64n128k16: as wgmma_rs_n64 with B [16 x 128]
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

// acc += A.B over 64 rows of depth: A the 64 x 64 float fragment of a score
// product packed to bf16 pairs (pk[4kk..4kk+3] its 16 columns kk), B the
// 64-row tile at descriptor db (MN-major, 16 rows = 2048 bytes a step)
template <int DH>
__device__ __forceinline__ void gemm_acc(float (&acc)[DH / 2], uint32_t (&pk)[16],
                                         uint64_t db) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3]};
    if constexpr (DH == 64)
      wgmma_rs_n64(acc, a, db + ((kk * 16 * 128) >> 4));
    else
      wgmma_rs_n128(acc, a, db + ((kk * 16 * 128) >> 4));
  }
  wgmma_commit();
  fence_regs(pk);
}

// d = A.B^T over depth DH: A the 64 rows at da, B the 64 rows at db, both
// K-major with 64-column panels pa and pb bytes apart (32 bytes a k step)
template <int DH>
__device__ __forceinline__ void gemm_scores(float (&d)[32], uint64_t da, int pa, uint64_t db,
                                            int pb) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const int in_panel = (ks & 3) * 32;
    wgmma_ss_n64(d, da + (((ks >> 2) * pa + in_panel) >> 4), db + (((ks >> 2) * pb + in_panel) >> 4),
                 ks > 0);
  }
}

// A stage's L or D (64 floats at sl, queries q0..) for the thread's 16
// columns 8j + col0 + e, in v[2j + e]; with `ragged`, a query at or past
// seq_q reads 0 (the scratch holds nothing written there)
__device__ __forceinline__ void load_ld(float (&v)[16], const float* sl, int q0, int col0,
                                        int seq_q, bool ragged) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(sl + 8 * j + col0);
    v[2 * j] = x.x;
    v[2 * j + 1] = x.y;
  }
  if (ragged) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[2 * j + e] = q0 + 8 * j + col0 + e >= seq_q ? 0.0f : v[2 * j + e];
  }
}

// the 32 float pairs of a 64 x 64 fragment, rounded to bf16 and packed
__device__ __forceinline__ void pack_frag(uint32_t (&pk)[16], const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pk[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// rows [row, row + 8) of a bf16 [.., DH] result from the accumulator
// fragment, times mul; rows at or past n_rows left out
template <int DH>
__device__ __forceinline__ void store_acc_wg(bf16* base, int64_t s_stride, int row, int n_rows,
                                             const float (&acc)[DH / 2], float mul, int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(base + (int64_t)i * s_stride + 8 * j + col0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// A 1-D grid's CTA -> (block, head, batch row) for n_blocks blocks of each
// of n_pairs = heads x batch rows: groups of kGroupBlocks consecutive
// blocks in block order, and within a group every (head, batch row)'s
// blocks side by side.  Block order puts the heaviest blocks under the
// causal mask first (blocks near key 0 in the dK / dV kernel; the dQ
// kernel reverses its blocks); a group's blocks of one head running side
// by side read the operand they all stream (Q and dO, or K and V) from
// device memory about once a group, then from L2.
constexpr int kGroupBlocks = 8;

__device__ __forceinline__ void block_order(int n_blocks, int n_pairs, int heads, int& blk,
                                            int& head, int& b) {
  const int full = n_blocks / kGroupBlocks * kGroupBlocks;  // blocks in whole groups
  int pair, in_group;
  if ((int)blockIdx.x < full * n_pairs) {
    const int grp = blockIdx.x / (kGroupBlocks * n_pairs);
    const int rest = blockIdx.x - grp * kGroupBlocks * n_pairs;
    pair = rest / kGroupBlocks;
    in_group = grp * kGroupBlocks + rest % kGroupBlocks;
  } else {  // the last, partial group
    const int g = n_blocks - full;
    const int rest = blockIdx.x - full * n_pairs;
    pair = rest / g;
    in_group = full + rest % g;
  }
  blk = in_group;
  head = pair % heads;
  b = pair / heads;
}

// One CTA per (block of 128 keys, kv head, batch row) of a 1-D grid, in
// block_order: the blocks nearest key 0 (the most query tiles under the
// causal mask) first.
// In a consumer's fragments, row r of a thread is key krow + 8r and column
// 8j + col0 + e of a 64-column product is query q0 + 8j + col0 + e.
template <int DH, int NC>
__global__ void __launch_bounds__(Bw<DH, NC>::kThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, Args a, int hq, int hkv) {
  using G = Bw<DH, NC>;
  constexpr int NS = G::kStagesKV;
  extern __shared__ uint4 smem_wg[];
  const uint32_t raw = smem_u32(smem_wg);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t s_k = base, s_v = base + G::kBlk;
  auto q_tile = [&](int st) { return base + 2 * G::kBlk + 2 * st * G::kQt; };  // dO after it
  const uint32_t s_ld = base + 2 * G::kBlk + 2 * NS * G::kQt;  // stage st: L, then D
  const uint32_t bars = s_ld + NS * 512;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + NS + st); };
  const float* ld_smem = reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(smem_wg) + (s_ld - raw));

  const int n_kb = (a.seq_k + G::kBlock - 1) / G::kBlock;
  int kb, hk, b;
  block_order(n_kb, gridDim.x / n_kb, hkv, kb, hk, b);
  const int k0 = kb * G::kBlock;
  const int n_qt = (a.seq_q + G::kQTile - 1) / G::kQTile;
  const int qt0 = a.causal ? min(k0 / G::kQTile, n_qt) : 0;
  const int nq = n_qt - qt0;
  const int n_it = a.group * nq;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), G::kConsumers);  // one thread of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * G::kBlk);
#pragma unroll
      for (int p = 0; p < DH / 64; ++p) {
        tma_load(s_k + p * G::kPanelBlk, &tm_k, kv_full, 64 * p, k0, hk, b);
        tma_load(s_v + p * G::kPanelBlk, &tm_v, kv_full, 64 * p, k0, hk, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % NS;
        if (it >= NS) mbar_wait(empty(st), (it / NS - 1) & 1);  // tile it - NS is done
        const int h = hk * a.group + it / nq;
        const int q0 = (qt0 + it % nq) * G::kQTile;
        const uint32_t dq = q_tile(st), ddo = dq + G::kQt;
        mbar_expect_tx(full(st), 2 * G::kQt + 512);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p) {
          tma_load(dq + p * G::kPanelQt, &tm_q, full(st), 64 * p, q0, h, b);
          tma_load(ddo + p * G::kPanelQt, &tm_do, full(st), 64 * p, q0, h, b);
        }
        const int64_t row = ((int64_t)b * hq + h) * a.ld + q0;
        bulk_load(s_ld + st * 512, a.lse + row, 256, full(st));
        bulk_load(s_ld + st * 512 + 256, a.delta + row, 256, full(st));
      }
    }
  } else {  // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int col0 = 2 * (lane & 3);
    const int krow = k0 + 64 * c + 16 * warp + (lane >> 2);  // and krow + 8
    const int warp_key = k0 + 64 * c + 16 * warp;            // the warp's first key
    const uint64_t d_k = wgmma_desc(s_k + c * 64 * 128, 16, 1024);
    const uint64_t d_v = wgmma_desc(s_v + c * 64 * 128, 16, 1024);
    float acc_dk[DH / 2], acc_dv[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc_dk[i] = acc_dv[i] = 0.0f;
    float s[32], dp[32];
    uint32_t pk_p[16], pk_ds[16];
    mbar_wait(kv_full, 0);
    BWD_START();
    for (int it = 0; it < n_it; ++it) {
      const int st = it % NS;
      const int q0 = (qt0 + it % nq) * G::kQTile;
      mbar_wait(full(st), (it / NS) & 1);
      BWD_STAMP(0);
      const uint32_t sq = q_tile(st), sdo = sq + G::kQt;
      // S^T = K.Q^T and dP^T = V.dO^T, two groups
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      gemm_scores<DH>(s, d_k, G::kPanelBlk, wgmma_desc(sq, 16, 1024), G::kPanelQt);
      wgmma_commit();
      gemm_scores<DH>(dp, d_v, G::kPanelBlk, wgmma_desc(sdo, 16, 1024), G::kPanelQt);
      wgmma_commit();
      const float* sl = ld_smem + st * 128;  // L, then D at + 64
      // a query past seq_q (zero q and dO, L and D unwritten) and, causally,
      // a query before the key score nothing
      const bool need_mask = q0 + G::kQTile > a.seq_q || (a.causal && q0 < warp_key + 15);
      BWD_STAMP(1);
      wgmma_wait<1>();  // S^T is done; dP^T runs on
      fence_regs(s);
      BWD_STAMP(2);
      // L (then D) of the thread's 16 queries 8j + col0 + e, index 2j + e;
      // a query past seq_q reads 0, not what is left in the scratch
      float lq[16];
      load_ld(lq, sl, q0, col0, a.seq_q, need_mask);
      // one warp-uniform branch a tile, and inside it selects only: a masked
      // score becomes -inf, its P exactly 0
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = q0 + 8 * j + col0 + e;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const bool drop = (qi >= a.seq_q) | (a.causal & (qi < krow + 8 * r));
              s[4 * j + 2 * r + e] = drop ? kNegInfinity : s[4 * j + 2 * r + e];
            }
          }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = ex2(fmaf(s[i], a.scale2, -lq[((i >> 2) << 1) + (i & 1)]));
      pack_frag(pk_p, s);
      BWD_STAMP(3);
      gemm_acc<DH>(acc_dv, pk_p, wgmma_desc(sdo, G::kPanelQt, 1024));  // dV += P^T.dO
      // dP^T is done; at Dh 64 the dV product runs on while dS is formed,
      // at Dh 128 it is waited for too, so that P^T's registers are free
      // for dS^T's (dK and dV take 128 a thread there)
      if constexpr (DH == 64)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_regs(dp);
      BWD_STAMP(4);
      float dq[16];
      load_ld(dq, sl + 64, q0, col0, a.seq_q, need_mask);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dq[((i >> 2) << 1) + (i & 1)]);
      pack_frag(pk_ds, dp);
      gemm_acc<DH>(acc_dk, pk_ds, wgmma_desc(sq, G::kPanelQt, 1024));  // dK += dS^T.Q
      BWD_STAMP(5);
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      if (tid == 0) mbar_arrive(empty(st));  // stage st is read
      BWD_STAMP(6);
    }
    store_acc_wg<DH>(static_cast<bf16*>(a.dk) + b * a.sdk.b + hk * a.sdk.h, a.sdk.s, krow,
                     a.seq_k, acc_dk, a.scale, col0);
    store_acc_wg<DH>(static_cast<bf16*>(a.dv) + b * a.sdv.b + hk * a.sdv.h, a.sdv.s, krow,
                     a.seq_k, acc_dv, 1.0f, col0);
  }
}

// One CTA per (block of query rows, q head, batch row) of a 1-D grid, in
// block_order, under the causal mask the blocks with the most key tiles
// first.  In a
// consumer's fragments, row r of a thread is query qrow + 8r and column 8j +
// col0 + e of a 64-key half tile is key kh + 8j + col0 + e.
template <int DH, int NC>
__global__ void __launch_bounds__(Bw<DH, NC>::kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, Args a, int hq) {
  using G = Bw<DH, NC>;
  constexpr int NS = G::kStagesQ;
  extern __shared__ uint4 smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023) & ~1023u;
  const uint32_t s_q = base, s_do = base + G::kBlk;
  auto k_tile = [&](int st) { return base + 2 * G::kBlk + 2 * st * G::kKt; };  // V after it
  const uint32_t bars = base + 2 * G::kBlk + 2 * NS * G::kKt;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + NS + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * NS + st); };

  const int n_qb = (a.seq_q + G::kBlock - 1) / G::kBlock;
  int qb, h, b;
  block_order(n_qb, gridDim.x / n_qb, hq, qb, h, b);
  if (a.causal) qb = n_qb - 1 - qb;
  const int q0 = qb * G::kBlock;
  const int hk = h / a.group;
  int n_tiles = (a.seq_k + G::kKTile - 1) / G::kKTile;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + G::kBlock, a.seq_q) - 1) / G::kKTile + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), G::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * G::kBlk);
#pragma unroll
      for (int p = 0; p < DH / 64; ++p) {
        tma_load(s_q + p * G::kPanelBlk, &tm_q, q_full, 64 * p, q0, h, b);
        tma_load(s_do + p * G::kPanelBlk, &tm_do, q_full, 64 * p, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty(st), (t / NS - 1) & 1);
        const uint32_t dk = k_tile(st), dv = dk + G::kKt;
        mbar_expect_tx(k_full(st), G::kKt);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p)
          tma_load(dk + p * G::kPanelKt, &tm_k, k_full(st), 64 * p, t * G::kKTile, hk, b);
        mbar_expect_tx(v_full(st), G::kKt);
#pragma unroll
        for (int p = 0; p < DH / 64; ++p)
          tma_load(dv + p * G::kPanelKt, &tm_v, v_full(st), 64 * p, t * G::kKTile, hk, b);
      }
    }
  } else {  // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int col0 = 2 * (lane & 3);
    const int qrow = q0 + 64 * c + 16 * warp + (lane >> 2);  // and qrow + 8
    const int warp_row = q0 + 64 * c + 16 * warp;
    const bf16* op = static_cast<const bf16*>(a.o) + b * a.so.b + h * a.so.h;
    const bf16* dop = static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    const int64_t row = ((int64_t)b * hq + h) * a.ld;
    // D = <dO, o> of rows qrow and qrow + 8: the four lanes of a row each
    // sum a quarter of Dh, then two shuffles give all four the same sum
    float dr[2], lr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qrow + 8 * r;
      float d = 0.0f;
      if (qi < a.seq_q) {
        const int c0 = (lane & 3) * (DH / 4);
#pragma unroll
        for (int u = 0; u < DH / 4; u += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(op + (int64_t)qi * a.so.s + c0 + u);
          const uint4 gv = *reinterpret_cast<const uint4*>(dop + (int64_t)qi * a.sdo.s + c0 + u);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float2 of = __bfloat1622float2(o2[w]);
            const float2 gf = __bfloat1622float2(g2[w]);
            d = fmaf(gf.x, of.x, d);
            d = fmaf(gf.y, of.y, d);
          }
        }
      }
      d += __shfl_xor_sync(kFull, d, 1);  // commutative pairs: all 4 get one sum
      d += __shfl_xor_sync(kFull, d, 2);
      dr[r] = d;
      if ((lane & 3) == 0 && qi < a.ld) a.delta[row + qi] = d;
      lr[r] = qi < a.seq_q ? a.lse[row + qi] : 0.0f;
    }
    const uint64_t d_q = wgmma_desc(s_q + c * 64 * 128, 16, 1024);
    const uint64_t d_do = wgmma_desc(s_do + c * 64 * 128, 16, 1024);
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
    float s[32], dp[32];
    uint32_t pk[16];
    mbar_wait(q_full, 0);
    BWD_START();
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % NS;
      mbar_wait(k_full(st), (t / NS) & 1);
      mbar_wait(v_full(st), (t / NS) & 1);
      BWD_STAMP(8);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kh = t * G::kKTile + 64 * half;
        const uint32_t sk = k_tile(st) + half * 64 * 128, sv = sk + G::kKt;
        // S = Q.K^T and dP = dO.V^T over these 64 keys, two groups
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        gemm_scores<DH>(s, d_q, G::kPanelBlk, wgmma_desc(sk, 16, 1024), G::kPanelKt);
        wgmma_commit();
        gemm_scores<DH>(dp, d_do, G::kPanelBlk, wgmma_desc(sv, 16, 1024), G::kPanelKt);
        wgmma_commit();
        // keys past seq_k (zero-filled) and, causally, after the row score
        // nothing
        const bool need_mask = kh + 64 > a.seq_k || (a.causal && kh + 63 > warp_row);
        BWD_STAMP(9);
        wgmma_wait<1>();  // S is done (and the previous half's dQ product)
        fence_regs(s);
        BWD_STAMP(10);
        if (need_mask) {  // a warp-uniform branch; a masked score becomes -inf
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kj = kh + 8 * j + col0 + e;
                const bool drop = (kj >= a.seq_k) | (a.causal & (kj > qrow + 8 * r));
                s[4 * j + 2 * r + e] = drop ? kNegInfinity : s[4 * j + 2 * r + e];
              }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], a.scale2, -lr[(i >> 1) & 1]));
        BWD_STAMP(11);
        wgmma_wait<0>();  // dP is done
        fence_regs(dp);
        BWD_STAMP(12);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dr[(i >> 1) & 1]);
        pack_frag(pk, dp);
        gemm_acc<DH>(acc, pk, wgmma_desc(sk, G::kPanelKt, 1024));  // dQ += dS.K
        BWD_STAMP(13);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(empty(st));  // stage st is read
      BWD_STAMP(14);
    }
    store_acc_wg<DH>(static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.s, qrow,
                     a.seq_q, acc, a.scale, col0);
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
// strides st = (b, h, s): a box of 64 columns x box_rows rows with the
// 128-byte swizzle, zero-filled past every extent.
int tensor_map(CUtensorMap* map, const void* ptr, int dh, int rows, int heads, int batch,
               const Strides& st, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
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

// The wgmma route: the dQ kernel (which writes D), then the dK / dV kernel,
// on `stream`; a.lse holds the forward's L.
template <int DH>
int launch_wgmma(const Args& a, int batch, int hq, int hkv, cudaStream_t stream) {
  using GQ = Bw<DH, kDqConsumers<DH>>;
  using GK = Bw<DH, kDkdvConsumers>;
  auto dq_kern = bwd_dq_wgmma_kernel<DH, GQ::kConsumers>;
  auto kv_kern = bwd_dkdv_wgmma_kernel<DH, GK::kConsumers>;
  // runtime calls first: they make the primary context current in this
  // thread (the autograd engine's worker thread may have none yet), which
  // cuTensorMapEncodeTiled needs
  int err = cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 GQ::kSmemQ);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GK::kSmemKV);
  if (err != cudaSuccess) return err;
  // dQ: Q and dO by blocks, K and V by stages; dK / dV: the reverse
  CUtensorMap q_blk, do_blk, k_t, v_t, q_t, do_t, k_blk, v_blk;
  err = tensor_map(&q_blk, a.q, DH, a.seq_q, hq, batch, a.sq, GQ::kBlock);
  if (err == cudaSuccess) err = tensor_map(&do_blk, a.dout, DH, a.seq_q, hq, batch, a.sdo, GQ::kBlock);
  if (err == cudaSuccess) err = tensor_map(&k_t, a.k, DH, a.seq_k, hkv, batch, a.sk, GQ::kKTile);
  if (err == cudaSuccess) err = tensor_map(&v_t, a.v, DH, a.seq_k, hkv, batch, a.sv, GQ::kKTile);
  if (err == cudaSuccess) err = tensor_map(&q_t, a.q, DH, a.seq_q, hq, batch, a.sq, GK::kQTile);
  if (err == cudaSuccess) err = tensor_map(&do_t, a.dout, DH, a.seq_q, hq, batch, a.sdo, GK::kQTile);
  if (err == cudaSuccess) err = tensor_map(&k_blk, a.k, DH, a.seq_k, hkv, batch, a.sk, GK::kBlock);
  if (err == cudaSuccess) err = tensor_map(&v_blk, a.v, DH, a.seq_k, hkv, batch, a.sv, GK::kBlock);
  if (err != cudaSuccess) return err;
  const int n_qb = (a.seq_q + GQ::kBlock - 1) / GQ::kBlock;
  dq_kern<<<n_qb * hq * batch, GQ::kThreads, GQ::kSmemQ, stream>>>(q_blk, k_t, v_t, do_blk, a, hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_kb = (a.seq_k + GK::kBlock - 1) / GK::kBlock;
  kv_kern<<<n_kb * hkv * batch, GK::kThreads, GK::kSmemKV, stream>>>(q_t, k_blk, v_blk, do_t, a,
                                                                      hq, hkv);
  return cudaGetLastError();
}

template <typename Kern>
cudaError_t run(Kern kern, dim3 grid, int threads, int smem, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DH>
int launch(const Args& a, int batch, int hq, int hkv, cudaStream_t stream) {
  const dim3 g_dq((a.seq_q + kB - 1) / kB, hq, batch);
  const dim3 g_dkdv((a.seq_k + kB - 1) / kB, hkv, batch);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    err = run(bwd_dq_mma_kernel<DH>, g_dq, kMmaThreads, mma_smem_bytes<DH>(), a, stream);
    if (err == cudaSuccess)
      err = run(bwd_dkdv_mma_kernel<DH>, g_dkdv, kMmaThreads, mma_smem_bytes<DH>(), a, stream);
  } else {
    err = run(bwd_dq_fma_kernel<DH>, g_dq, kThreads, fma_smem_bytes<DH>(), a, stream);
    if (err == cudaSuccess)
      err = run(bwd_dkdv_fma_kernel<DH>, g_dkdv, kThreads, fma_smem_bytes<DH>(), a, stream);
  }
  return err;
}

template <typename T>
int dispatch(int dh, const Args& a, int batch, int hq, int hkv, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(a, batch, hq, hkv, stream);
    case 32: return launch<T, 32>(a, batch, hq, hkv, stream);
    case 64: return launch<T, 64>(a, batch, hq, hkv, stream);
    case 128: return launch<T, 128>(a, batch, hq, hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

// route: the route to run (bwd_route's, or kRouteMma for the private entry)
int backward(const void* q, const void* k, const void* v, const void* o, const void* dout,
             void* dq, void* dk, void* dv, void* lse, void* delta, int dtype, int dh, int batch,
             int hq, int hkv, int seq_q, int seq_k, int causal, float scale, const int64_t* st,
             void* stream, int route) {
  if (batch == 0 || hq == 0 || seq_q == 0 || seq_k == 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || lse == nullptr || delta == nullptr ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  Strides* s[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.group = hq / hkv;
  a.seq_q = seq_q;
  a.seq_k = seq_k;
  a.causal = causal;
  a.ld = (seq_q + kLdBlock - 1) / kLdBlock * kLdBlock;
  a.scale = scale;
  a.scale2 = scale * kLog2e;
  const cudaStream_t sm = (cudaStream_t)stream;
  if (route == kRouteWgmma) {
    if (dh == 64) return launch_wgmma<64>(a, batch, hq, hkv, sm);
    if (dh == 128) return launch_wgmma<128>(a, batch, hq, hkv, sm);
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return dispatch<float>(dh, a, batch, hq, hkv, sm);
  return dispatch<bf16>(dh, a, batch, hq, hkv, sm);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The rows the scratch rounds Sq up to: lse and delta hold ceil(seq_q /
// block) * block entries a (batch row, q head).
int flash_attention_bwd_block() { return kLdBlock; }

// The route that runs a backward of dtype (0 float32, 1 bfloat16) at head
// dim dh and seq_q query rows, in *route: 0 the FMA pair, 1 the mma.sync
// pair, 2 the wgmma pair (which reads the forward's L from lse).  The
// wrapper counts launches by it.
int flash_attention_bwd_route(int dtype, int dh, int seq_q, int* route) {
  if ((dtype != 0 && dtype != 1) || (dh != 16 && dh != 32 && dh != 64 && dh != 128) ||
      seq_q < 1)
    return cudaErrorInvalidValue;
  *route = bwd_route(dtype, dh, seq_q);
  return cudaSuccess;
}

// dtype: 0 float32, 1 bfloat16, for all of q, k, v, o, dout, dq, dk and dv.
// strides: 24 element strides, (b, h, s) of q, k, v, o, dout, dq, dk and dv
// in that order; Dh is contiguous in all eight, and every pointer and stride
// is 16-byte aligned (the wrapper checks both).  lse and delta: float32
// scratch of batch * hq * ceil(seq_q / 128) * 128 entries each, allocated
// by the caller.  On the wgmma route lse holds the forward's L
// (attention.cu's flash_attention_lse) and delta is written here; on the
// others both are written here.  Launches the route's dQ kernel, then its
// dK / dV kernel, on `stream`.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
                        int dtype, int dh, int batch, int hq, int hkv, int seq_q, int seq_k,
                        int causal, float scale, const int64_t* st, void* stream) {
  return backward(q, k, v, o, dout, dq, dk, dv, lse, delta, dtype, dh, batch, hq, hkv, seq_q,
                  seq_k, causal, scale, st, stream, bwd_route(dtype, dh, seq_q));
}

// The mma.sync pair on any bf16 operands, whatever the route: to time the
// route the wgmma pair replaced beside it.  Arguments as flash_attention_bwd's.
int flash_attention_bwd_mma_sync(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, void* dq, void* dk, void* dv, void* lse,
                                 void* delta, int dtype, int dh, int batch, int hq, int hkv,
                                 int seq_q, int seq_k, int causal, float scale,
                                 const int64_t* st, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  return backward(q, k, v, o, dout, dq, dk, dv, lse, delta, dtype, dh, batch, hq, hkv, seq_q,
                  seq_k, causal, scale, st, stream, kRouteMma);
}

}  // extern "C"
