// Block-sparse (BSR) diffusion kernels for Hopper (sm_90a), plain C interface.
//
// K1 frontier_round_bsr replaces the TPU kernel
//   src/repro/kernels/diffusion/kernel.py : frontier_round_bsr_pallas
//   (bodies _frontier_kernel / _frontier_kernel_dma).
// K2 bsr_spmm replaces
//   src/repro/kernels/diffusion/kernel.py : bsr_spmm_pallas (body _kernel),
//   and, through a visit table (visit_block, visit_col, row_ptr) over a tile
//   pool, the engine's bsr_gather_spmm_pallas (bodies _gather_kernel /
//   _gather_kernel_dma).
//
// What bounds them on an H100: the tile bytes.  Each [bs, bs] f32 tile is read
// once per round (64 KiB at bs = 128) against bs * C fluid values, so at C = 1
// a round does 2 flops per 4-byte weight: 0.5 flop/byte, far below the card's
// ~20 flop/byte f32 balance point.  Only the HBM rate matters.  K1 reads only
// the tiles of armed block columns (col_active != 0): its bytes are those
// tiles', from 95 % of the pool in a dense round to none in an empty one
// (a cold solve at N = 2**21 has both).
//
// What the simt bodies (frontier_round_kernel, bsr_spmm_kernel) do about it:
//   * One CUDA block owns one output block row r and walks that row's tiles
//     row_ptr[r] .. row_ptr[r+1] in their sorted order.  This loop inside the
//     block replaces the TPU grid's in-order "first visit seeds, last visit
//     reduces" pattern, which cannot carry over: CUDA blocks run in no order.
//     The row's accumulator lives in shared memory for the whole walk, and no
//     two blocks ever write the same output, so the kernel needs no atomics
//     and gives bit-identical results from run to run.
//   * A warp owns an output row of the tile and reads the tile's row-major
//     rows with consecutive lanes on consecutive addresses (coalesced 128-byte
//     loads); four rows are in flight per warp to keep loads outstanding.
//   * A tile whose block column has no armed fluid (col_active == 0) is never
//     read: late in a solve most tiles cost no bytes at all.
//   * The sent fluid of a column block is built once per tile into shared
//     memory with the same predicate the wrapper uses, fabsf(f) * wt > 1.
// Rows that own no tile (row_ptr[r] == row_ptr[r+1]) write the kept fluid and
// its |.|_1 directly: the result the TPU path gets from its occupancy epilogue.
// What holds the simt bodies back: a CTA a row (16,384 at N = 2**21, about 5
// tiles each) pays its own start and drain, and each tile waits on a chain of
// dependent loads between two __syncthreads.
//
// K1 and K2 each have two routes, chosen here (frontier_route, spmm_route)
// and nowhere else:
//   * bulk (frontier_round_bulk_kernel, bsr_spmm_bulk_kernel), every
//     bs % 4 == 0 with 16-byte aligned operands whose ring fits: persistent
//     CTAs (kCtasPerSm an SM, as many as fit) walk the output rows
//     r = blockIdx.x + i * gridDim.x.
//     A producer streams the tiles as contiguous slabs of whole tile rows
//     (kSlabBytes) by 1-D TMA bulk copies into a kBulkStages ring guarded by
//     full / empty mbarriers, each tile's fluid (x; K1: f and wt of its
//     column) into a slot of its own, and runs ahead across slab, tile, visit
//     and row edges, so the HBM stream never drains at a tile edge and no
//     __syncthreads sits in the walk.  Consumer warps own the tile
//     rows row == warp (mod kBulkWarps) for the whole walk and keep their sums
//     in shared memory; rows without tiles cost no CTA.  Two CTAs an SM: at
//     bs = 128 one CTA's eight consumer warps cannot keep up with K2's
//     stream, and K1's sparse rounds are bound by per-row latency, which a
//     second CTA hides (tools/k1_probe.py, tools/k2_probe.py).
//     K1's producer is a whole warp, so that skipping unarmed tiles costs no
//     serial latency: it tests kScanLanes tiles at once (block_col, then
//     col_active, a lane each; __ballot_sync gives the armed ones) and copies
//     only those.  It loads the bounds of 32 of its rows at once (a lane
//     each) and a row's first block columns while it tests the row before,
//     so in a sparse round, when most tiles are skipped, a row waits on one
//     load.  It first counts a row's armed tiles and writes the count
//     and col_active[r] beside the row's own f and wt, which it copies into
//     one of kRowSlots row slots; the consumers read that record, seed the
//     row with its kept fluid from the slot and take exactly that many tiles
//     from the ring, so they never touch block_col or col_active (a second
//     scan in every consumer warp would put the load chain back on the
//     arithmetic's path).  They build sent as they read f: fabsf(f) * wt > 1
//     ? f : 0, the value the simt body puts in x_s.  A row ends with the simt
//     body's epilogue among the consumers, on a named barrier; a row with
//     no armed tile is finished by one consumer warp in turn, in the same
//     order, with no barrier, so that eight such rows run at once.
//   * simt (frontier_round_kernel, bsr_spmm_kernel): one CTA per output row,
//     4-byte loads from global memory; odd bs, unaligned operands and rings
//     that do not fit.
// Both routes of a kernel take every (row, c) sum in the same order: fmaf
// over j = lane, lane + 32, ..., the warp_sum butterfly, then added to the
// accumulator (K1: seeded with the kept fluid; K2: 0) tile after tile in
// row_ptr order, unarmed tiles skipped; K1's |f_new[r]|_1 is block_l1's sum
// in both.  The routes give the same bits on every input.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 4;
constexpr int kMaxSmem = 232448;  // bytes of shared memory one CTA may use

// the bulk route's ring (kernel.py mirrors these in its route rule)
constexpr int kBulkStages = 3;
constexpr int kSlabBytes = 32 * 1024;
constexpr int kCtasPerSm = 2;
// an evict_first L2 policy on the tile copies (each tile is read once a
// launch): off, as it costs the engine's shapes 0.8 % (tools/k2_probe.py)
constexpr bool kEvictFirst = false;
constexpr int kBulkWarps = 8;                        // consumer warps a CTA
constexpr int kBulkThreads = 32 * (kBulkWarps + 1);  // and a producer warp
// K1's bulk body: row slots (a row's own f and wt, and its record), and the
// tiles its producer warp tests at once (one a lane)
constexpr int kRowSlots = 8;
constexpr int kScanLanes = 32;
constexpr int kRouteSimt = 0, kRouteBulk = 1;

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: a fixed tree, so the result does not depend on timing
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc_s[row * C + c] += sum_j tile[row, j] * x_s[j * C + c] for the rows this
// warp owns.  The sum over j runs lane-strided then through the butterfly, in
// the same order on every launch.
__device__ __forceinline__ void accumulate_tile(const float* __restrict__ tile,
                                                const float* __restrict__ x_s,
                                                float* __restrict__ acc_s,
                                                int bs, int C, int warp, int lane) {
  for (int row0 = warp; row0 < bs; row0 += kRowsInFlight * kWarps) {
    for (int c = 0; c < C; ++c) {
      float part[kRowsInFlight];
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) part[q] = 0.0f;
#pragma unroll 4
      for (int j = lane; j < bs; j += 32) {
        const float xj = x_s[j * C + c];
#pragma unroll
        for (int q = 0; q < kRowsInFlight; ++q) {
          const int row = row0 + q * kWarps;
          if (row < bs) part[q] = fmaf(__ldg(tile + (size_t)row * bs + j), xj, part[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {
        const int row = row0 + q * kWarps;
        const float s = warp_sum(part[q]);
        if (lane == 0 && row < bs) acc_s[row * C + c] += s;
      }
    }
  }
}

// out = acc_s and *row_l1 = |acc_s|_1, summed in one order: thread tid <
// kThreads over i = tid, tid + kThreads, ..., the butterfly, then warps 0 ..
// kWarps - 1.  sync: __syncthreads, or the bulk body's consumer barrier.
template <typename Sync>
__device__ __forceinline__ void block_l1(const float* __restrict__ acc_s, float* __restrict__ out,
                                         float* __restrict__ red_s, float* __restrict__ row_l1,
                                         int m, int tid, int warp, int lane, Sync sync) {
  if (tid < kThreads) {
    float l1 = 0.0f;
    for (int i = tid; i < m; i += kThreads) {
      const float v = acc_s[i];
      out[i] = v;
      l1 += fabsf(v);
    }
    l1 = warp_sum(l1);
    if (lane == 0) red_s[warp] = l1;
  }
  sync();
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red_s[w];
    *row_l1 = s;
  }
}

__global__ void __launch_bounds__(kThreads)
frontier_round_kernel(const float* __restrict__ blocks, const int32_t* __restrict__ block_col,
                      const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ col_active,
                      const float* __restrict__ f, const float* __restrict__ wt,
                      float* __restrict__ f_new, float* __restrict__ row_l1, int bs, int C) {
  extern __shared__ float smem[];
  const int m = bs * C;
  float* acc_s = smem;
  float* x_s = smem + m;
  float* red_s = smem + 2 * m;
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // seed with the kept fluid: a node counts as sent only if its own block
  // column is armed this round (deferred columns keep their fluid)
  const float* f_r = f + (size_t)r * m;
  const float* wt_r = wt + (size_t)r * bs;
  const bool armed = col_active[r] != 0;
  for (int i = tid; i < m; i += kThreads) {
    const float v = f_r[i];
    const bool sel = armed && fabsf(v) * wt_r[i / C] > 1.0f;
    acc_s[i] = sel ? 0.0f : v;
  }

  const int64_t lo = row_ptr[r], hi = row_ptr[r + 1];
  for (int64_t k = lo; k < hi; ++k) {
    const int col = block_col[k];
    if (col_active[col] == 0) continue;  // the same for every thread of the block
    __syncthreads();  // seeds written; the previous tile's readers are done with x_s
    const float* f_c = f + (size_t)col * m;
    const float* wt_c = wt + (size_t)col * bs;
    for (int i = tid; i < m; i += kThreads) {
      const float v = f_c[i];
      x_s[i] = fabsf(v) * wt_c[i / C] > 1.0f ? v : 0.0f;
    }
    __syncthreads();
    accumulate_tile(blocks + (size_t)k * bs * bs, x_s, acc_s, bs, C, warp, lane);
  }
  __syncthreads();
  block_l1(acc_s, f_new + (size_t)r * m, red_s, row_l1 + r, m, tid, warp, lane,
           [] { __syncthreads(); });
}

__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ blocks, const int32_t* __restrict__ visit_block,
                const int32_t* __restrict__ visit_col, const int64_t* __restrict__ row_ptr,
                const float* __restrict__ x, float* __restrict__ out, int bs, int C) {
  extern __shared__ float smem[];
  const int m = bs * C;
  float* acc_s = smem;
  float* x_s = smem + m;
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < m; i += kThreads) acc_s[i] = 0.0f;

  const int64_t lo = row_ptr[r], hi = row_ptr[r + 1];
  for (int64_t k = lo; k < hi; ++k) {
    __syncthreads();
    const float* x_c = x + (size_t)visit_col[k] * m;
    for (int i = tid; i < m; i += kThreads) x_s[i] = x_c[i];
    __syncthreads();
    accumulate_tile(blocks + (size_t)visit_block[k] * bs * bs, x_s, acc_s, bs, C, warp, lane);
  }
  __syncthreads();
  float* out_r = out + (size_t)r * m;
  for (int i = tid; i < m; i += kThreads) out_r[i] = acc_s[i];
}

// ---- the bulk route --------------------------------------------------------

// tile rows a slab holds: kSlabBytes of them, at most the whole tile
__host__ __device__ constexpr int slab_rows(int bs) {
  return kSlabBytes / (bs * 4) < 1 ? 1 : (kSlabBytes / (bs * 4) > bs ? bs : kSlabBytes / (bs * 4));
}

// the ring, an x slot a stage, the accumulator, then 4 barriers a stage
__host__ __device__ constexpr size_t bulk_smem(int bs, int C) {
  return (size_t)kBulkStages * slab_rows(bs) * bs * 4 + (kBulkStages + 1) * (size_t)bs * C * 4 +
         4 * kBulkStages * 8;
}

// K1's: the ring, an (f, wt) slot a stage and a row slot, the accumulator,
// block_l1's warp sums, a record a row slot, then 4 barriers a stage and 2 a
// row slot
__host__ __device__ constexpr size_t frontier_bulk_smem(int bs, int C) {
  return 4 * ((size_t)kBulkStages * slab_rows(bs) * bs + (size_t)(kBulkStages + kRowSlots) * bs * (C + 1) +
              (size_t)bs * C + kWarps + 2 * kRowSlots) +
         8 * (4 * kBulkStages + 2 * kRowSlots);
}

// kRouteBulk, kRouteSimt, or -1 where no route fits
int spmm_route(int bs, int C, bool aligned) {
  if (bs < 1 || bs > 1024 || C < 1 || 2 * (size_t)bs * C * 4 > kMaxSmem) return -1;
  if (bs % 4 == 0 && aligned && bulk_smem(bs, C) <= kMaxSmem) return kRouteBulk;
  return kRouteSimt;
}

int frontier_route(int bs, int C, bool aligned) {
  if (bs < 1 || bs > 1024 || C < 1 || (2 * (size_t)bs * C + kWarps) * 4 > kMaxSmem) return -1;
  if (bs % 4 == 0 && aligned && frontier_bulk_smem(bs, C) <= kMaxSmem) return kRouteBulk;
  return kRouteSimt;
}

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

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the same with an L2 cache policy
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// acc_s[row * C + c] += sum_j slab[row - row0, j] * x_s[j * C + c] for the
// rows row0 .. row0 + nr - 1 this warp owns (row == warp mod kBulkWarps): per
// row the same sum, in the same order, as accumulate_tile's.  kSent (K1): x_s
// holds a column's f and wt_s its weights, and each x is sent as it is read,
// fabsf(f) * wt > 1 ? f : 0, the value frontier_round_kernel puts in x_s.
template <bool kSent = false>
__device__ __forceinline__ void accumulate_slab(const float* __restrict__ slab,
                                                const float* __restrict__ x_s,
                                                float* __restrict__ acc_s, int row0, int nr,
                                                int bs, int C, int warp, int lane,
                                                const float* __restrict__ wt_s = nullptr) {
  const int end = row0 + nr;
  const int first = row0 + (warp - row0 % kBulkWarps + kBulkWarps) % kBulkWarps;
  for (int rq = first; rq < end; rq += kRowsInFlight * kBulkWarps) {
    for (int c = 0; c < C; ++c) {
      float part[kRowsInFlight];
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) part[q] = 0.0f;
#pragma unroll 4
      for (int j = lane; j < bs; j += 32) {
        float xj = x_s[j * C + c];
        if constexpr (kSent) xj = fabsf(xj) * wt_s[j] > 1.0f ? xj : 0.0f;
#pragma unroll
        for (int q = 0; q < kRowsInFlight; ++q) {
          const int row = rq + q * kBulkWarps;
          if (row < end) part[q] = fmaf(slab[(row - row0) * bs + j], xj, part[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {
        const int row = rq + q * kBulkWarps;
        const float s = warp_sum(part[q]);
        if (lane == 0 && row < end) acc_s[row * C + c] += s;
      }
    }
  }
}

__global__ void __launch_bounds__(kBulkThreads, kCtasPerSm)
bsr_spmm_bulk_kernel(const float* __restrict__ blocks, const int32_t* __restrict__ visit_block,
                     const int32_t* __restrict__ visit_col, const int64_t* __restrict__ row_ptr,
                     const float* __restrict__ x, float* __restrict__ out, int n_rows, int bs,
                     int C) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int m = bs * C;
  const int sr = slab_rows(bs);
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* x_ring = ring + (size_t)kBulkStages * sr * bs;
  float* acc_s = x_ring + (size_t)kBulkStages * m;
  uint64_t* bars = reinterpret_cast<uint64_t*>(acc_s + m);
  auto full = [&](int st) { return smem_u32(bars + st); };
  auto empty = [&](int st) { return smem_u32(bars + kBulkStages + st); };
  auto x_full = [&](int st) { return smem_u32(bars + 2 * kBulkStages + st); };
  auto x_empty = [&](int st) { return smem_u32(bars + 3 * kBulkStages + st); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < m; i += kBulkThreads) acc_s[i] = 0.0f;
  if (tid == 0) {
    for (int st = 0; st < kBulkStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kBulkWarps);  // lane 0 of each consumer warp
      mbar_init(x_full(st), 1);
      mbar_init(x_empty(st), kBulkWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Both sides walk the same rows, visits and slabs in the same order: slab
  // number `it` sits in stage it % kBulkStages, visit number `vi`'s x in slot
  // vi % kBulkStages, each in phase (count / kBulkStages) & 1.
  if (warp == kBulkWarps) {  // ---- producer: one thread issues every copy ----
    if (lane != 0) return;
    uint64_t policy = 0;
    if (kEvictFirst) asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
    const int x_bytes = m * 4;
    int it = 0, vi = 0;
    for (int r = blockIdx.x; r < n_rows; r += gridDim.x) {
      const int64_t hi = row_ptr[r + 1];
      for (int64_t k = row_ptr[r]; k < hi; ++k, ++vi) {
        const int xs = vi % kBulkStages;
        if (vi >= kBulkStages) mbar_wait(x_empty(xs), (vi / kBulkStages - 1) & 1);
        mbar_expect_tx(x_full(xs), x_bytes);
        bulk_load(smem_u32(x_ring + (size_t)xs * m), x + (size_t)visit_col[k] * m, x_bytes,
                  x_full(xs));
        const float* tile = blocks + (size_t)visit_block[k] * bs * bs;
        for (int row0 = 0; row0 < bs; row0 += sr, ++it) {
          const int st = it % kBulkStages;
          const int bytes = min(sr, bs - row0) * bs * 4;
          if (it >= kBulkStages) mbar_wait(empty(st), (it / kBulkStages - 1) & 1);
          mbar_expect_tx(full(st), bytes);
          const uint32_t dst = smem_u32(ring + (size_t)st * sr * bs);
          if (kEvictFirst)
            bulk_load(dst, tile + (size_t)row0 * bs, bytes, full(st), policy);
          else
            bulk_load(dst, tile + (size_t)row0 * bs, bytes, full(st));
        }
      }
    }
    return;
  }

  // ---- consumers: warp owns the tile rows == warp (mod kBulkWarps) ----
  int it = 0, vi = 0;
  for (int r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const int64_t hi = row_ptr[r + 1];
    for (int64_t k = row_ptr[r]; k < hi; ++k, ++vi) {
      const int xs = vi % kBulkStages;
      mbar_wait(x_full(xs), (vi / kBulkStages) & 1);
      const float* x_s = x_ring + (size_t)xs * m;
      for (int row0 = 0; row0 < bs; row0 += sr, ++it) {
        const int st = it % kBulkStages;
        mbar_wait(full(st), (it / kBulkStages) & 1);
        accumulate_slab(ring + (size_t)st * sr * bs, x_s, acc_s, row0, min(sr, bs - row0), bs, C,
                        warp, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
      if (lane == 0) mbar_arrive(x_empty(xs));
    }
    // the warp's rows of out[r], then their accumulators back to 0
    __syncwarp();
    float* out_r = out + (size_t)r * m;
    const int n_own = (bs - warp + kBulkWarps - 1) / kBulkWarps;
    for (int i = lane; i < n_own * C; i += 32) {
      const int e = (warp + i / C * kBulkWarps) * C + i % C;
      out_r[e] = acc_s[e];
      acc_s[e] = 0.0f;
    }
    __syncwarp();
  }
}

// the K1 consumers' barrier (named barrier 1): the producer warp never joins
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBulkWarps * 32) : "memory");
}

// The block column of tile base + lane where lane < kScanLanes and the tile
// is < hi, else -1
__device__ __forceinline__ int tile_col(const int32_t* __restrict__ block_col, int64_t base,
                                        int64_t hi, int lane) {
  return lane < kScanLanes && base + lane < hi ? __ldg(block_col + base + lane) : -1;
}

// The lanes whose block column is armed.  The whole warp calls it.
__device__ __forceinline__ uint32_t armed_lanes(const int32_t* __restrict__ col_active, int col) {
  return __ballot_sync(0xffffffffu, col >= 0 && __ldg(col_active + col) != 0);
}

__global__ void __launch_bounds__(kBulkThreads, kCtasPerSm)
frontier_round_bulk_kernel(const float* __restrict__ blocks, const int32_t* __restrict__ block_col,
                           const int64_t* __restrict__ row_ptr,
                           const int32_t* __restrict__ col_active, const float* __restrict__ f,
                           const float* __restrict__ wt, float* __restrict__ f_new,
                           float* __restrict__ row_l1, int n_rows, int bs, int C) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int m = bs * C;
  const int slot = m + bs;  // an (f, wt) slot: bs x C fluid, then bs weights
  const int sr = slab_rows(bs);
  const int n_slabs = (bs + sr - 1) / sr;
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* x_ring = ring + (size_t)kBulkStages * sr * bs;    // an armed tile's column
  float* row_ring = x_ring + (size_t)kBulkStages * slot;  // a row's own f and wt
  float* acc_s = row_ring + (size_t)kRowSlots * slot;
  float* red_s = acc_s + m;
  int* rec = reinterpret_cast<int*>(red_s + kWarps);  // (armed tiles, col_active[r]) a row slot
  uint64_t* bars = reinterpret_cast<uint64_t*>(rec + 2 * kRowSlots);
  auto full = [&](int st) { return smem_u32(bars + st); };
  auto empty = [&](int st) { return smem_u32(bars + kBulkStages + st); };
  auto x_full = [&](int st) { return smem_u32(bars + 2 * kBulkStages + st); };
  auto x_empty = [&](int st) { return smem_u32(bars + 3 * kBulkStages + st); };
  auto row_full = [&](int rs) { return smem_u32(bars + 4 * kBulkStages + rs); };
  auto row_empty = [&](int rs) { return smem_u32(bars + 4 * kBulkStages + kRowSlots + rs); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int st = 0; st < kBulkStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kBulkWarps);  // lane 0 of each consumer warp
      mbar_init(x_full(st), 1);
      mbar_init(x_empty(st), kBulkWarps);
    }
    for (int rs = 0; rs < kRowSlots; ++rs) {
      mbar_init(row_full(rs), 1);
      mbar_init(row_empty(rs), kBulkWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Both sides walk the same rows, armed tiles and slabs in the same order:
  // row number ri sits in row slot ri % kRowSlots, armed tile number vi's
  // column in slot vi % kBulkStages, slab number it in stage it % kBulkStages,
  // each in phase (count / slots) & 1.
  const int x_bytes = slot * 4;
  if (warp == kBulkWarps) {  // ---- producer warp: lane 0 issues every copy ----
    constexpr uint32_t kAll = 0xffffffffu;
    int it = 0, vi = 0, ri = 0;
    // copies the column and the slabs of tile base + b for every lane b set
    // in armed; col: the lanes' block columns
    auto issue = [&](uint32_t armed, int64_t base, int col) {
      for (; armed; armed &= armed - 1, ++vi, it += n_slabs) {
        const int b = __ffs(armed) - 1;
        const int c = __shfl_sync(kAll, col, b);
        if (lane != 0) continue;
        const int xs = vi % kBulkStages;
        if (vi >= kBulkStages) mbar_wait(x_empty(xs), (vi / kBulkStages - 1) & 1);
        float* dst = x_ring + (size_t)xs * slot;
        mbar_expect_tx(x_full(xs), x_bytes);
        bulk_load(smem_u32(dst), f + (size_t)c * m, m * 4, x_full(xs));
        bulk_load(smem_u32(dst + m), wt + (size_t)c * bs, bs * 4, x_full(xs));
        const float* tile = blocks + (size_t)(base + b) * bs * bs;
        for (int s = 0; s < n_slabs; ++s) {
          const int i = it + s, st = i % kBulkStages, row0 = s * sr;
          const int bytes = min(sr, bs - row0) * bs * 4;
          if (i >= kBulkStages) mbar_wait(empty(st), (i / kBulkStages - 1) & 1);
          mbar_expect_tx(full(st), bytes);
          bulk_load(smem_u32(ring + (size_t)st * sr * bs), tile + (size_t)row0 * bs, bytes,
                    full(st));
        }
      }
    };
    // 32 of the CTA's rows at a time: lane i loads row rb + i * gridDim.x's
    // bounds and col_active, and each row's first block columns are loaded
    // while the row before is tested, so a row waits on one load, not three
    for (int rb = blockIdx.x; rb < n_rows; rb += 32 * gridDim.x) {
      const int rl = rb + lane * gridDim.x;
      const bool in = rl < n_rows;
      const int64_t lo_l = in ? __ldg(row_ptr + rl) : 0, hi_l = in ? __ldg(row_ptr + rl + 1) : 0;
      const int own_l = in ? __ldg(col_active + rl) : 0;
      const int nb = __popc(__ballot_sync(kAll, in));
      int64_t lo = __shfl_sync(kAll, lo_l, 0), hi = __shfl_sync(kAll, hi_l, 0);
      int col = tile_col(block_col, lo, hi, lane);
      for (int i = 0; i < nb; ++i, ++ri) {
        const int r = rb + i * gridDim.x;
        const int own = __shfl_sync(kAll, own_l, i);
        const int64_t lo_n = __shfl_sync(kAll, lo_l, (i + 1) & 31);
        const int64_t hi_n = __shfl_sync(kAll, hi_l, (i + 1) & 31);
        const int col_n = i + 1 < nb ? tile_col(block_col, lo_n, hi_n, lane) : -1;
        // the row's armed tiles: the first kScanLanes, then the rest
        const uint32_t first = armed_lanes(col_active, col);
        int n = __popc(first);
        for (int64_t base = lo + kScanLanes; base < hi; base += kScanLanes)
          n += __popc(armed_lanes(col_active, tile_col(block_col, base, hi, lane)));
        if (lane == 0) {
          const int rs = ri % kRowSlots;
          if (ri >= kRowSlots) mbar_wait(row_empty(rs), (ri / kRowSlots - 1) & 1);
          rec[2 * rs] = n;  // published by the arrive below
          rec[2 * rs + 1] = own;
          float* dst = row_ring + (size_t)rs * slot;
          mbar_expect_tx(row_full(rs), x_bytes);
          bulk_load(smem_u32(dst), f + (size_t)r * m, m * 4, row_full(rs));
          bulk_load(smem_u32(dst + m), wt + (size_t)r * bs, bs * 4, row_full(rs));
        }
        issue(first, lo, col);
        for (int64_t base = lo + kScanLanes; base < hi; base += kScanLanes) {
          const int cb = tile_col(block_col, base, hi, lane);
          issue(armed_lanes(col_active, cb), base, cb);
        }
        lo = lo_n;
        hi = hi_n;
        col = col_n;
      }
    }
    return;
  }

  // ---- consumers: warp owns the tile rows == warp (mod kBulkWarps) ----
  const int n_own = (bs - warp + kBulkWarps - 1) / kBulkWarps;
  int it = 0, vi = 0, ri = 0;
  for (int r = blockIdx.x; r < n_rows; r += gridDim.x, ++ri) {
    const int rs = ri % kRowSlots;
    mbar_wait(row_full(rs), (ri / kRowSlots) & 1);
    const int n = rec[2 * rs];
    const bool armed = rec[2 * rs + 1] != 0;
    const float* f_r = row_ring + (size_t)rs * slot;
    if (n == 0) {
      // No armed tile: f_new[r] is the kept fluid, and one warp (in turn)
      // writes it and sums |f_new[r]|_1 in block_l1's order, warp by warp,
      // with no barrier, so that several such rows run at once.
      if (warp == ri % kBulkWarps) {
        float* out = f_new + (size_t)r * m;
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          float l1 = 0.0f;
          for (int i = w * 32 + lane; i < m; i += kThreads) {
            const float v = f_r[i];
            const float kept = armed && fabsf(v) * f_r[m + i / C] > 1.0f ? 0.0f : v;
            out[i] = kept;
            l1 += fabsf(kept);
          }
          s += warp_sum(l1);
        }
        if (lane == 0) row_l1[r] = s;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(row_empty(rs));
      continue;
    }
    // seed the warp's rows with the kept fluid, as frontier_round_kernel does
    for (int i = lane; i < n_own * C; i += 32) {
      const int e = (warp + i / C * kBulkWarps) * C + i % C;
      const float v = f_r[e];
      const bool sel = armed && fabsf(v) * f_r[m + e / C] > 1.0f;
      acc_s[e] = sel ? 0.0f : v;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(row_empty(rs));
    for (int k = 0; k < n; ++k, ++vi) {
      const int xs = vi % kBulkStages;
      mbar_wait(x_full(xs), (vi / kBulkStages) & 1);
      const float* x_s = x_ring + (size_t)xs * slot;
      for (int row0 = 0; row0 < bs; row0 += sr, ++it) {
        const int st = it % kBulkStages;
        mbar_wait(full(st), (it / kBulkStages) & 1);
        accumulate_slab<true>(ring + (size_t)st * sr * bs, x_s, acc_s, row0, min(sr, bs - row0), bs,
                              C, warp, lane, x_s + m);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
      if (lane == 0) mbar_arrive(x_empty(xs));
    }
    consumer_sync();  // every warp's sums are in
    block_l1(acc_s, f_new + (size_t)r * m, red_s, row_l1 + r, m, tid, warp, lane,
             [] { consumer_sync(); });
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// persistent CTAs: kCtasPerSm an SM, or as many as the kernel's ring lets
// stay, and no more than there are rows
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int n_rows, int* grid) {
  cudaError_t err = prepare(kernel, smem);
  int dev = 0, n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBulkThreads, smem);
  const int ctas = (per_sm < 1 ? 1 : per_sm < kCtasPerSm ? per_sm : kCtasPerSm) * n_sm;
  *grid = n_rows < ctas ? n_rows : ctas;
  return err;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The route frontier_round_bsr takes by itself (route = -1) for a bs x C
// round whose blocks, f and wt are (aligned = 1) or are not 16-byte aligned:
// kRouteBulk, kRouteSimt, or an error where neither fits.
int frontier_round_bsr_route(int bs, int C, int aligned, int* route) {
  *route = frontier_route(bs, C, aligned != 0);
  return *route < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// f, f_new: [n_row_blocks, bs, C]; wt: [n_row_blocks, bs]; row_l1: [n_row_blocks];
// blocks: [n_blocks, bs, bs] sorted by block row; block_col: [n_blocks];
// row_ptr: [n_row_blocks + 1]; col_active: [n_row_blocks].  route: -1 for
// frontier_round_bsr_route's choice, else kRouteSimt or kRouteBulk (an error
// where that route does not fit); *taken: the route that ran.
int frontier_round_bsr(const void* blocks, const void* block_col, const void* row_ptr,
                       const void* col_active, const void* f, const void* wt, void* f_new,
                       void* row_l1, int n_row_blocks, int bs, int C, int route, int* taken,
                       void* stream) {
  const bool aligned = ((uintptr_t)blocks | (uintptr_t)f | (uintptr_t)wt) % 16 == 0;
  const int fits = frontier_route(bs, C, aligned);
  if (route < 0) route = fits;
  if (fits < 0 || (route == kRouteBulk && fits != kRouteBulk) ||
      (route != kRouteBulk && route != kRouteSimt))
    return cudaErrorInvalidValue;
  *taken = route;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == kRouteSimt) {
    const size_t smem = (2 * (size_t)bs * C + kWarps) * sizeof(float);
    cudaError_t err = prepare(frontier_round_kernel, smem);
    if (err != cudaSuccess || n_row_blocks == 0) return err;
    frontier_round_kernel<<<n_row_blocks, kThreads, smem, st>>>(
        (const float*)blocks, (const int32_t*)block_col, (const int64_t*)row_ptr,
        (const int32_t*)col_active, (const float*)f, (const float*)wt, (float*)f_new,
        (float*)row_l1, bs, C);
    return cudaGetLastError();
  }
  const size_t smem = frontier_bulk_smem(bs, C);
  int grid = 0;
  cudaError_t err = persistent_grid(frontier_round_bulk_kernel, smem, n_row_blocks, &grid);
  if (err != cudaSuccess || n_row_blocks == 0) return err;
  frontier_round_bulk_kernel<<<grid, kBulkThreads, smem, st>>>(
      (const float*)blocks, (const int32_t*)block_col, (const int64_t*)row_ptr,
      (const int32_t*)col_active, (const float*)f, (const float*)wt, (float*)f_new,
      (float*)row_l1, n_row_blocks, bs, C);
  return cudaGetLastError();
}

// The route bsr_spmm takes by itself (route = -1) for a bs x C product whose
// blocks and x are (aligned = 1) or are not 16-byte aligned: kRouteBulk,
// kRouteSimt, or an error where neither fits.
int bsr_spmm_route(int bs, int C, int aligned, int* route) {
  *route = spmm_route(bs, C, aligned != 0);
  return *route < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// x: [n_col_blocks, bs, C]; out: [n_row_blocks, bs, C]; visits sorted by
// destination row, row_ptr: [n_row_blocks + 1] over the visits.  route: -1
// for bsr_spmm_route's choice, else kRouteSimt or kRouteBulk (an error where
// that route does not fit); *taken: the route that ran.
int bsr_spmm(const void* blocks, const void* visit_block, const void* visit_col,
             const void* row_ptr, const void* x, void* out, int n_row_blocks, int bs, int C,
             int route, int* taken, void* stream) {
  const bool aligned = ((uintptr_t)blocks | (uintptr_t)x) % 16 == 0;
  const int fits = spmm_route(bs, C, aligned);
  if (route < 0) route = fits;
  if (fits < 0 || (route == kRouteBulk && fits != kRouteBulk) ||
      (route != kRouteBulk && route != kRouteSimt))
    return cudaErrorInvalidValue;
  *taken = route;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == kRouteSimt) {
    const size_t smem = 2 * (size_t)bs * C * sizeof(float);
    cudaError_t err = prepare(bsr_spmm_kernel, smem);
    if (err != cudaSuccess || n_row_blocks == 0) return err;
    bsr_spmm_kernel<<<n_row_blocks, kThreads, smem, st>>>(
        (const float*)blocks, (const int32_t*)visit_block, (const int32_t*)visit_col,
        (const int64_t*)row_ptr, (const float*)x, (float*)out, bs, C);
    return cudaGetLastError();
  }
  const size_t smem = bulk_smem(bs, C);
  int grid = 0;
  cudaError_t err = persistent_grid(bsr_spmm_bulk_kernel, smem, n_row_blocks, &grid);
  if (err != cudaSuccess || n_row_blocks == 0) return err;
  bsr_spmm_bulk_kernel<<<grid, kBulkThreads, smem, st>>>(
      (const float*)blocks, (const int32_t*)visit_block, (const int32_t*)visit_col,
      (const int64_t*)row_ptr, (const float*)x, (float*)out, n_row_blocks, bs, C);
  return cudaGetLastError();
}

}  // extern "C"
