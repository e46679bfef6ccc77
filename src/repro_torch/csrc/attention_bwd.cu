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
// What the design does about it.  Two kernels, no float atomics, so that a
// relaunch gives the same bits:
// * the dQ kernel, one CTA per (block of 64 queries, q head, batch row),
//   walks the key tiles twice: first for each row's logsumexp L (an online
//   max and sum, as the forward's), which it writes with D to a float32
//   scratch, then for dQ += dS k, recomputing P from L;
// * the dK / dV kernel, one CTA per (block of 64 keys, kv head, batch row),
//   walks the query tiles that can see its keys, for each q head of its
//   group in turn, and sums dV += P^T dO and dK += dS^T q in that fixed
//   order, reading L and D from the scratch.
// L is computed here rather than written by the forward: training reaches
// four forward kernels (the wgmma, mma.sync and FMA prefill kernels, and the
// split-KV decode kernel at Sq <= 64, whose splits would each hold a part of
// L), all of which serve, the wgmma kernel with a tight register allocation;
// so they stay as they are, and one path here covers every Sq, at the cost
// of one more Q.K^T product (eight products where five are counted).
// bf16 runs on mma.sync m16n8k16 (bf16 in, float32 accumulate; 4 warps of
// 16 rows a CTA, tiles of 64 double-buffered by cp.async), as the
// forward's mma.sync kernel: P is
// rounded to bf16 for the dV product, dS for the dQ and dK products, as the
// forward rounds p before its PV product.  float32 runs on FMA (256 threads
// a CTA, each owning a 4 x 4 block of the 64 x 64 score tile and a 4-row
// slice of its accumulators).  Any Sq and Sk: the ragged tails are zero
// filled and masked here, so the caller pads nothing.  Both kernels work in
// base 2 (exp2 of scores scaled by scale.log2(e)); the scratch holds L in
// that base.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kB = 64;  // rows of a CTA's block, and of a tile of the other side
constexpr int kThreads = 256;     // FMA kernels: 16 x 16, ty owns 4 rows
constexpr int kMmaThreads = 128;  // mma.sync kernels: 4 warps of 16 rows
constexpr float kNegInf = -1.0e30f;
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

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The rows of a CTA's block: lse and delta hold ceil(seq_q / block) * block
// entries a (batch row, q head).
int flash_attention_bwd_block() { return kB; }

// dtype: 0 float32, 1 bfloat16, for all of q, k, v, o, dout, dq, dk and dv.
// strides: 24 element strides, (b, h, s) of q, k, v, o, dout, dq, dk and dv
// in that order; Dh is contiguous in all eight, and every pointer and stride
// is 16-byte aligned (the wrapper checks both).  lse and delta: float32
// scratch of batch * hq * ceil(seq_q / 64) * 64 entries each, allocated by
// the caller, written and read here.  Launches the dQ kernel, then the dK /
// dV kernel, on `stream`.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
                        int dtype, int dh, int batch, int hq, int hkv, int seq_q, int seq_k,
                        int causal, float scale, const int64_t* st, void* stream) {
  if (batch == 0 || hq == 0 || seq_q == 0 || seq_k == 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || lse == nullptr || delta == nullptr)
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
  a.ld = (seq_q + kB - 1) / kB * kB;
  a.scale = scale;
  a.scale2 = scale * kLog2e;
  if (dtype == 0) return dispatch<float>(dh, a, batch, hq, hkv, (cudaStream_t)stream);
  if (dtype == 1) return dispatch<bf16>(dh, a, batch, hq, hkv, (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
