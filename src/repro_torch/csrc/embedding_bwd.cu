// The FM tables' gradient for Hopper (sm_90a), plain C interface.
//
// embedding_bwd computes, for ids seg sorted ascending (int32 or int64, read
// as they come), the stable sort's permutation order (int32 or int64) and
// g: [n_g, d] float32,
//   out[r] = sum over e with seg[e] == r of g[order[e] / bag]   (0 <= r < n)
// into a dense float32 out: [n, d], 0 where no e names r.  Ids outside
// [0, n), and rows order[e] / bag outside [0, n_g), contribute nothing.
// With seg = rows[order] it is the gradient of the FM lookups
//   table[rows]                              (bag 1, d = 10)
//   lin_table[rows].reshape(B, F).sum(-1)    (bag F = 39, d = 1)
// for g = dL/d(lookup).  It replaces XLA's gradient of the gathers at
// src/repro/models/recsys.py:77 (the table) and :79 (the linear table), a
// dense scatter-add; no Pallas kernel of the reference computes it.
//
// What bounds it on an H100: the bytes of the output.  At the train_batch
// cell (B = 65,536, F = 39: 2,555,904 ids into 39,000,000 rows) the table's
// gradient writes 1.56 GB once and reads 102 MB of g and 31 MB of ids
// (0.51 ms at 3.35 TB/s); the linear table's writes 156 MB (0.056 ms).
// 532 K of the 39 M rows receive anything, and the zipf ids put 82 % of the
// ids into 39 tiles of 1,024 rows (the first rows of each field): summed by
// the CTA that owns the tile, one such tile took 0.13-0.5 ms, as long as all
// the zeros (tools/emb_bwd_probe.py).  So the ids are summed apart from the
// tiles.
//
// What the design does about it: one cooperative launch (every CTA resident
// at once), in three phases split by grid-wide barriers.
// * A: the ids split evenly over every warp of the grid, in pieces of 32-id
//   groups, whatever their rows; a warp counts the runs of equal ids that
//   begin in its piece.  A hot id's rows spread over all the warps its run
//   spans.
// * B: a warp sums its piece, lanes over ids (d is 10 or 1: lanes over
//   columns would idle): 32 ids at a time, a segmented inclusive scan by
//   shuffles in a fixed tree sums each run, the run still open goes on to
//   the next 32 as the carry, and 32 ids that all continue it are added to
//   each lane's own partial sum instead, reduced by a fixed butterfly when
//   the run closes.  Every run that begins in the piece gets its rank (the
//   runs before it, from A's counts), its id, its first index, and its part
//   of the sum in sums[rank] (a table of each tile's first run too); the
//   piece's part of a run begun before it goes to head[warp].  Loads are
//   issued a step before their values are read.  B reads 2.56 M random
//   40-byte rows of g, two 32-byte sectors each: ~130 µs at train_batch.
// * C: tiles of the output, not chunks of the input: R consecutive output
//   rows, kTileBytes of them in shared memory (R = 2,048 at d = 10, 16,384
//   at d = 1: the largest power of two that fits), each taken from a
//   counter by whichever CTA is free (the stores' share of the bandwidth
//   differs between CTAs: static ranges left the last CTA ~90 µs after the
//   median).  A tile's runs come from B's table; each thread puts a run's
//   sum in its row (sums[rank] plus, in warp order, the heads of the pieces
//   the run spans; a thread's first run loaded while the tile before is
//   written out), and the tile leaves once, coalesced, by 16-byte streaming
//   stores (__stcs of float4; the ragged end of the last tile by 4-byte
//   ones), empty rows and all, zeroed as it is read out.
// No float atomics anywhere (one integer counter): relaunches are
// bit-identical on one card (the pieces follow the grid, so the bits may
// differ on a card with another number of SMs).  The scratch (the runs' ids,
// first indices and sums, the heads, the counts and tables) comes from the
// caller: embedding_bwd_scratch says how many bytes.
// kTileBytes and kCtasPerSm are what tools/emb_bwd_probe.py found fastest
// at train_batch's two launches; the probe passes other values at run time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// A hook that tools/emb_bwd_probe.py's build fills in to clock each CTA's
// phases (empty here)
#define EMB_STAMP(i)

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 80 * 1024;  // the output tile in shared memory
constexpr int kCtasPerSm = 2;          // CTAs an SM
constexpr int kMinCtas = 2;            // CTAs an SM the registers must fit
constexpr int kMaxTileBytes = 200 * 1024;
constexpr int kMinPiece = 256;  // ids a warp at the least: a run spans few pieces
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoKey = INT_MIN;         // a lane with no id
constexpr int kBefore = INT_MIN + 1;    // the id before the first

// ids a lane loads at once (32 * items a warp step), by the widest group
// of columns a lane holds
__host__ __device__ constexpr int items_for(int maxd) {
  return maxd >= 8 ? 1 : maxd >= 2 ? 2 : 4;
}

struct Args {
  const float* g;     // [n_g, d]
  const void* seg;    // [n_entries] sorted ids, seg_bytes each
  const void* order;  // [n_entries] rows of the lookup, order_bytes each
  float* out;         // [n, d]
  // scratch
  int* cta_runs;      // [grid] runs that begin in a CTA's pieces
  int* counter;       // [1] C's tiles taken so far
  int* tile_start;    // [n_tiles + 1] the first run of each tile
  int* keys;          // [n_entries] each run's id, clamped to [-1, n]
  int* first;         // [n_entries] each run's first id's index
  float* sums;        // [n_entries, d] each run's sum over the piece it begins in
  float* head;        // [warps, d] a piece's part of the run begun before it
  int64_t n_entries, n_g, n, n_tiles, piece;  // piece: ids a warp, a multiple of 32
  int d, bag, tile_rows, seg_bytes, order_bytes, pair;
};

// An id or an order as loaded, int32 (zero-extended) or int64: nothing
// reads the loaded register until the value is used, so that a load issued
// a step ahead does not stall the warp where it is issued.
__device__ __forceinline__ uint64_t raw_at(const void* p, int bytes, int64_t e) {
  return bytes == 8 ? (uint64_t)__ldg(static_cast<const unsigned long long*>(p) + e)
                    : (uint64_t)__ldg(static_cast<const unsigned*>(p) + e);
}

// the same, read for the last time: evict-first in L2, so that B's reads do
// not push out the run sums that C reads back
__device__ __forceinline__ uint64_t raw_last(const void* p, int bytes, int64_t e) {
  return bytes == 8 ? (uint64_t)__ldcs(static_cast<const unsigned long long*>(p) + e)
                    : (uint64_t)__ldcs(static_cast<const unsigned*>(p) + e);
}

__device__ __forceinline__ int64_t value_of(uint64_t raw, int bytes) {
  return bytes == 8 ? (int64_t)raw : (int64_t)(int)(uint32_t)raw;
}

// an id clamped to [-1, n]: -1 below every row, n past them
__device__ __forceinline__ int key_of(const Args& a, uint64_t raw) {
  const int64_t s = value_of(raw, a.seg_bytes);
  return s < 0 ? -1 : s >= a.n ? (int)a.n : (int)s;
}

__device__ __forceinline__ int key_at(const Args& a, int64_t e) {
  return key_of(a, raw_at(a.seg, a.seg_bytes, e));
}

// the row of g that order o names, or -1 when it lies outside [0, n_g)
__device__ __forceinline__ int src_of(const Args& a, uint64_t raw) {
  const int64_t o = value_of(raw, a.order_bytes);
  if (o < 0 || o >= a.n_entries) return -1;  // n_entries < 2**31: a 32-bit divide
  const int r = a.bag == 1 ? (int)o : (int)((uint32_t)o / (uint32_t)a.bag);
  return r < a.n_g ? r : -1;
}

// columns [c0, c0 + dg) of g's row src (zeros for src -1), each read once:
// evict-first in L2
template <int MAXD>
__device__ __forceinline__ void load_row(const Args& a, int src, int c0, int dg, float (&x)[MAXD]) {
#pragma unroll
  for (int j = 0; j < MAXD; ++j) x[j] = 0.0f;
  if (src < 0) return;
  const float* r = a.g + (int64_t)src * a.d + c0;
  if (MAXD % 2 == 0 && a.pair) {
#pragma unroll
    for (int j = 0; j < MAXD; j += 2)
      if (j < dg) {
        const float2 p = __ldcs(reinterpret_cast<const float2*>(r + j));
        x[j] = p.x;
        x[j + 1] = p.y;
      }
  } else {
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < dg) x[j] = __ldcs(r + j);
  }
}

// every lane's x summed over the warp, the same bits in every lane
template <int MAXD>
__device__ __forceinline__ void butterfly(float (&x)[MAXD]) {
#pragma unroll 1
  for (int off = 16; off >= 1; off >>= 1)
#pragma unroll
    for (int j = 0; j < MAXD; ++j) x[j] = x[j] + __shfl_xor_sync(kFull, x[j], off);
}

// Phase A: the runs that begin in the piece [p0, p1) (an id differing from
// the one before it), 8 groups of 32 ids loaded at once.
__device__ int count_runs(const Args& a, int64_t p0, int64_t p1, int lane) {
  int prev = p0 == 0 ? kBefore : key_at(a, p0 - 1), runs = 0;
  for (int64_t b = p0; b < p1; b += 8 * 32) {
    uint64_t raw[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t e = b + 32 * u + lane;
      if (e < p1) raw[u] = raw_at(a.seg, a.seg_bytes, e);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t e0 = b + 32 * u;
      if (e0 >= p1) break;
      const int cnt = (int)min((int64_t)32, p1 - e0);
      const int k = lane < cnt ? key_of(a, raw[u]) : kNoKey;
      int kp = __shfl_up_sync(kFull, k, 1);
      if (lane == 0) kp = prev;
      runs += __popc(__ballot_sync(kFull, lane < cnt && k != kp));
      prev = __shfl_sync(kFull, k, cnt - 1);
    }
  }
  return runs;
}

// The first tile that begins after run key k (clamped to [-1, n]), and the
// last one that begins at or before it
__device__ __forceinline__ int64_t tile_after(const Args& a, int k) {
  return k < 0 ? 0 : k / a.tile_rows + 1;
}

__device__ __forceinline__ int64_t tile_upto(const Args& a, int k) {
  return k < 0 ? -1 : min((int64_t)(k / a.tile_rows), a.n_tiles);
}

// Phase B: one warp's piece [p0, p1), columns [c0, c0 + dg).  Every run
// that begins in the piece gets rank `rank` on (in order): its id, its first
// index and the tiles it is the first run of (with the first columns), and
// its sum over the piece in sums; the piece's part of a run begun before it
// goes to head[w].  The warp that ends the ids marks the tiles after the
// last run (n_runs runs in all).
template <int MAXD>
__device__ void piece_sums(const Args& a, int64_t p0, int64_t p1, int rank, int n_runs,
                           int64_t w, int c0, int dg, int lane) {
  constexpr int kItems = items_for(MAXD);
  constexpr int S = 32 * kItems;  // ids a step
  const unsigned lt = (1u << lane) - 1u;
  int prev = p0 == 0 ? kBefore : key_at(a, p0 - 1);
  // the open run: its id (warp-uniform) and rank (-1: begun before the piece)
  int carry = kNoKey, carry_rank = -1;
  if (key_at(a, p0) == prev) carry = prev;
  bool spread = false;  // acc holds lane partials (true) or the run's sum in every lane
  float acc[MAXD];
#pragma unroll
  for (int j = 0; j < MAXD; ++j) acc[j] = 0.0f;

  // the part v of the run of rank r: to sums, or the piece's head
  auto emit = [&](int r, const float(&v)[MAXD]) {
    float* o = (r < 0 ? a.head + w * a.d : a.sums + (int64_t)r * a.d) + c0;
#pragma unroll
    for (int j = 0; j < MAXD; ++j)
      if (j < dg) o[j] = v[j];
  };

  // Every load is issued a step before its value is read: the ids of step
  // k + 2 (as loaded) and the rows of g of step k + 1 are in flight while
  // step k sums.
  uint64_t rs[kItems], ro[kItems];
  auto load_raw = [&](int64_t base) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t e = base + 32 * i + lane;
      if (e < p1) {
        rs[i] = raw_last(a.seg, a.seg_bytes, e);
        ro[i] = raw_last(a.order, a.order_bytes, e);
      }
    }
  };
  int key[kItems], src[kItems];
  auto convert = [&](int64_t base) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t e = base + 32 * i + lane;
      key[i] = kNoKey;
      src[i] = -1;
      if (e < p1) {
        key[i] = key_of(a, rs[i]);
        src[i] = src_of(a, ro[i]);
      }
    }
  };
  int k_now[kItems];
  auto sum_step = [&](int64_t base, float(&x)[kItems][MAXD]) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t sb = base + 32 * i;
      if (sb >= p1) break;
      const int cnt = (int)min((int64_t)32, p1 - sb);
      const bool valid = lane < cnt;
      const int k = k_now[i];
      float(&v)[MAXD] = x[i];
      // the runs that begin here, ranked in order
      int kp = __shfl_up_sync(kFull, k, 1);
      if (lane == 0) kp = prev;
      prev = __shfl_sync(kFull, k, cnt - 1);
      const bool begins = valid && k != kp;
      const unsigned starts = __ballot_sync(kFull, begins);
      if (begins && c0 == 0) {
        const int r = rank + __popc(starts & lt);
        a.keys[r] = k;
        a.first[r] = (int)(sb + lane);
        // r is the first run of every tile that begins after the run before
        // it and at or before it
        for (int64_t t = tile_after(a, kp); t <= tile_upto(a, k); ++t) a.tile_start[t] = r;
      }
      if (starts == 0) {  // all 32 continue the open run
        if (!spread && lane != 0) {
#pragma unroll
          for (int j = 0; j < MAXD; ++j) acc[j] = 0.0f;
        }
        spread = true;
        if (valid) {
#pragma unroll
          for (int j = 0; j < MAXD; ++j) acc[j] = acc[j] + v[j];
        }
        continue;
      }
      // each lane's run's rank: the last run begun at or before it, else the
      // open one
      const int le = __popc(starts & (lt | (1u << lane)));
      const int my_rank = le > 0 ? rank + le - 1 : carry_rank;
      float c[MAXD];  // the open run's sum, in every lane
#pragma unroll
      for (int j = 0; j < MAXD; ++j) c[j] = acc[j];
      if (spread) butterfly<MAXD>(c);
      // the sum of each lane's run up to it (ids ascend: equal ids are
      // adjacent); the loops over offsets stay loops: the unrolled body
      // outgrew the instruction cache
#pragma unroll 1
      for (int off = 1; off < 32; off <<= 1) {
        const int kk = __shfl_up_sync(kFull, k, off);
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
          const float y = __shfl_up_sync(kFull, v[j], off);
          if (lane >= off && kk == k) v[j] = y + v[j];
        }
      }
      if (carry != kNoKey) {
        if (le == 0) {  // the first run goes on from the open one
#pragma unroll
          for (int j = 0; j < MAXD; ++j) v[j] = c[j] + v[j];
        }
        if (lane == 0 && (starts & 1u)) emit(carry_rank, c);  // it closed before these
      }
      const int kn = __shfl_down_sync(kFull, k, 1);
      if (valid && lane != cnt - 1 && kn != k) emit(my_rank, v);
      carry = __shfl_sync(kFull, k, cnt - 1);  // the last run stays open
      carry_rank = __shfl_sync(kFull, my_rank, cnt - 1);
#pragma unroll
      for (int j = 0; j < MAXD; ++j) acc[j] = __shfl_sync(kFull, v[j], cnt - 1);
      spread = false;
      rank += __popc(starts);
    }
  };
  float x[kItems][MAXD], nx[kItems][MAXD];
  load_raw(p0);
  convert(p0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    load_row<MAXD>(a, src[i], c0, dg, x[i]);
    k_now[i] = key[i];
  }
  load_raw(p0 + S);
  for (int64_t base = p0; base < p1; base += S) {
    convert(base + S);
#pragma unroll
    for (int i = 0; i < kItems; ++i) load_row<MAXD>(a, src[i], c0, dg, nx[i]);
    load_raw(base + 2 * S);
    sum_step(base, x);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      k_now[i] = key[i];
#pragma unroll
      for (int j = 0; j < MAXD; ++j) x[i][j] = nx[i][j];  // loaded during the sums
    }
  }
  if (spread) butterfly<MAXD>(acc);
  if (lane == 0) emit(carry_rank, acc);
  // the tiles after the last run begin at the end of the runs
  if (c0 == 0 && p1 == a.n_entries && lane == 0)
    for (int64_t t = tile_after(a, prev); t <= a.n_tiles; ++t) a.tile_start[t] = n_runs;
}

// dg floats of the scratch, zeros past them
template <int MAXD>
__device__ __forceinline__ void load_part(const float* p, int dg, float (&x)[MAXD]) {
#pragma unroll
  for (int j = 0; j < MAXD; ++j) x[j] = j < dg ? p[j] : 0.0f;
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads, kMinCtas) embedding_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float tile[];
  __shared__ int warp_runs[kWarps];
  __shared__ int warp_rank[kWarps];
  __shared__ int64_t runs_total;
  __shared__ int taken;         // the tile the CTA took last
  const cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t p0 = min(w * a.piece, a.n_entries), p1 = min(p0 + a.piece, a.n_entries);
  EMB_STAMP(0);

  // A: the runs that begin in each warp's piece, summed by CTA
  const int runs = p0 < p1 ? count_runs(a, p0, p1, lane) : 0;
  if (lane == 0) warp_runs[warp] = runs;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int i = 0; i < kWarps; ++i) t += warp_runs[i];
    a.cta_runs[blockIdx.x] = t;
    if (blockIdx.x == 0) *a.counter = 0;
  }
  grid.sync();
  EMB_STAMP(1);

  // B: each warp's first rank (the CTAs' runs before, then its warps'), and
  // its piece's sums
  if (warp == 0) {
    long long before = 0, total = 0;
    for (int c = lane; c < (int)gridDim.x; c += 32) {
      const int v = __ldcg(a.cta_runs + c);
      total += v;
      if (c < (int)blockIdx.x) before += v;
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      before += __shfl_xor_sync(kFull, before, off);
      total += __shfl_xor_sync(kFull, total, off);
    }
    if (lane == 0) {
      runs_total = total;
      for (int i = 0; i < kWarps; ++i) {
        warp_rank[i] = (int)before;
        before += warp_runs[i];
      }
    }
  }
  __syncthreads();
  if (p0 < p1)
    for (int c0 = 0; c0 < a.d; c0 += MAXD)
      piece_sums<MAXD>(a, p0, p1, warp_rank[warp], (int)runs_total, w, c0, min(MAXD, a.d - c0),
                       lane);
  if (a.n_entries == 0 && blockIdx.x == 0)  // no runs: every tile begins at 0
    for (int64_t t = threadIdx.x; t <= a.n_tiles; t += kThreads) a.tile_start[t] = 0;
  grid.sync();
  EMB_STAMP(2);

  // C: each tile zeroed, given its runs' sums, and written out
  const int64_t n_runs = runs_total;
  {
    float4* t4 = reinterpret_cast<float4*>(tile);
    const int n4 = (a.tile_rows * a.d + 3) / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads) t4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // a run's sum (its piece's part, then the heads of the pieces it spans,
  // in order) into its row of the tile; columns [0, MAXD) come as loaded
  const int piece = (int)a.piece;
  auto place = [&](int64_t r, int64_t row0, int key, int begin, int end,
                   const float(&v0)[MAXD]) {
    const int row = key - (int)row0;
    for (int c0 = 0; c0 < a.d; c0 += MAXD) {
      const int dg = min(MAXD, a.d - c0);
      float v[MAXD];
      if (c0 == 0) {
#pragma unroll
        for (int j = 0; j < MAXD; ++j) v[j] = v0[j];
      } else {
        load_part<MAXD>(a.sums + r * a.d + c0, dg, v);
      }
#pragma unroll 4
      for (int p = begin / piece + 1; (int64_t)p * piece < end; ++p) {
        float h[MAXD];
        load_part<MAXD>(a.head + (int64_t)p * a.d + c0, dg, h);
#pragma unroll
        for (int j = 0; j < MAXD; ++j) v[j] = v[j] + h[j];
      }
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < dg) tile[row * a.d + c0 + j] = v[j];
    }
  };
  // a run's id, first and last-plus-one id indices and first columns.  The
  // scratch was written before the last grid barrier and never read here
  // before it: plain loads see it.
  struct Run {
    int key, begin, end;
    float v[MAXD];
  };
  auto fetch = [&](int64_t r, Run& u) {
    u.key = a.keys[r];
    u.begin = a.first[r];
    u.end = r + 1 < n_runs ? a.first[r + 1] : (int)a.n_entries;
    load_part<MAXD>(a.sums + r * a.d, min(MAXD, a.d), u.v);
  };
  // the tiles, taken one at a time from a counter by whichever CTA is free
  // (the stores' share of the bandwidth and the runs' work differ between
  // CTAs); tile t's runs are [start[t], start[t + 1]) of B's table
  if (threadIdx.x == 0) taken = atomicAdd(a.counter, 1);
  __syncthreads();
  int64_t t = taken;
  // a thread's first run of a tile, loaded while the tile before is
  // written out
  Run next;
  if (t < a.n_tiles && a.tile_start[t] + threadIdx.x < a.tile_start[t + 1])
    fetch(a.tile_start[t] + threadIdx.x, next);
  while (t < a.n_tiles) {
    const int64_t row0 = t * a.tile_rows;
    const int rows = (int)min((int64_t)a.tile_rows, a.n - row0);
    const int n_fl = rows * a.d;
    const int64_t r0 = a.tile_start[t], r1 = a.tile_start[t + 1];
    __syncthreads();  // every thread has read taken
    if (threadIdx.x == 0) taken = atomicAdd(a.counter, 1);
    // a thread a run: the first kThreads from what was loaded a tile ago
    Run cur = next;
    if (r0 + threadIdx.x < r1) place(r0 + threadIdx.x, row0, cur.key, cur.begin, cur.end, cur.v);
    for (int64_t r = r0 + kThreads + threadIdx.x; r < r1; r += kThreads) {
      fetch(r, cur);
      place(r, row0, cur.key, cur.begin, cur.end, cur.v);
    }
    __syncthreads();
    const int64_t tn = taken;
    if (tn < a.n_tiles && a.tile_start[tn] + threadIdx.x < a.tile_start[tn + 1])
      fetch(a.tile_start[tn] + threadIdx.x, next);
    // the tile out once: 16-byte streaming stores (row0 * d is a multiple of
    // 4), the last tile's ragged end by 4-byte ones; what is read out is
    // zeroed for the next tile in the same pass
    float* dst = a.out + row0 * a.d;
    const int n4 = n_fl / 4;
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      __stcs(reinterpret_cast<float4*>(dst) + i, t4[i]);
      t4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int i = n4 * 4 + threadIdx.x; i < n_fl; i += kThreads) {
      __stcs(dst + i, tile[i]);
      tile[i] = 0.0f;
    }
    __syncthreads();  // the tile is read out and zeroed before the next
    t = tn;
  }
  EMB_STAMP(3);
}

// the largest power of two R >= 4 with R * d * 4 <= kTileBytes
int default_tile_rows(int d) {
  int r = 4;
  while ((int64_t)2 * r * d * 4 <= kTileBytes) r *= 2;
  return r;
}

// The launch's shape: CTAs (all resident at once), ids a warp, tile rows
// and shared memory, or an error.
struct Plan {
  int grid, rows, smem;
  int64_t piece;
};

int maxd_for(int d) {
  const int m = d < 32 ? d : 32;
  return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : m <= 8 ? 8 : m <= 10 ? 10 : m <= 16 ? 16 : 32;
}

template <int MAXD>
int plan_for(int64_t n_entries, int d, int tile_rows, int ctas_per_sm, Plan& p) {
  p.rows = tile_rows ? tile_rows : default_tile_rows(d);
  const int64_t tile_floats = ((int64_t)p.rows * d + 3) / 4 * 4;
  if (tile_floats * 4 > kMaxTileBytes) return cudaErrorInvalidValue;
  p.smem = (int)(tile_floats * 4);
  auto kern = embedding_bwd_kernel<MAXD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  int dev = 0, sms = 0, fit = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern, kThreads, p.smem);
  if (err != cudaSuccess) return err;
  const int ctas = ctas_per_sm > 0 ? ctas_per_sm : kCtasPerSm;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  p.grid = (ctas < fit ? ctas : fit) * sms;
  const int64_t warps = (int64_t)p.grid * kWarps;
  p.piece = ((n_entries + warps - 1) / warps + 31) / 32 * 32;
  if (p.piece < kMinPiece) p.piece = kMinPiece;
  return cudaSuccess;
}

int plan(int64_t n_entries, int d, int tile_rows, int ctas_per_sm, Plan& p) {
  switch (maxd_for(d)) {
    case 1: return plan_for<1>(n_entries, d, tile_rows, ctas_per_sm, p);
    case 2: return plan_for<2>(n_entries, d, tile_rows, ctas_per_sm, p);
    case 4: return plan_for<4>(n_entries, d, tile_rows, ctas_per_sm, p);
    case 8: return plan_for<8>(n_entries, d, tile_rows, ctas_per_sm, p);
    case 10: return plan_for<10>(n_entries, d, tile_rows, ctas_per_sm, p);
    case 16: return plan_for<16>(n_entries, d, tile_rows, ctas_per_sm, p);
    default: return plan_for<32>(n_entries, d, tile_rows, ctas_per_sm, p);
  }
}

// the scratch's parts, each 16-byte aligned: cta_runs, counter,
// tile_start, keys, first, sums, head
int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

int64_t n_tiles_of(const Plan& p, int64_t n) { return (n + p.rows - 1) / p.rows; }

int64_t scratch_bytes(const Plan& p, int64_t n_entries, int64_t n, int d) {
  return align16(4 * (int64_t)p.grid) + align16(4) + align16(4 * (n_tiles_of(p, n) + 1)) +
         2 * align16(4 * n_entries) + align16(4 * n_entries * d) +
         align16(4 * (int64_t)p.grid * kWarps * d);
}

template <int MAXD>
int launch(Args a, const Plan& p, cudaStream_t stream) {
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)embedding_bwd_kernel<MAXD>,
                                                dim3(p.grid), dim3(kThreads), args, p.smem,
                                                stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool bad_shape(int64_t n_g, int64_t n_entries, int64_t n, int d) {
  return n <= 0 || n >= INT_MAX || d <= 0 || n_g < 0 || n_g >= INT_MAX || n_entries < 0 ||
         n_entries >= INT_MAX;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The source's rows a tile at width d (0 for d < 1).
int embedding_bwd_tile_rows(int d) { return d > 0 ? default_tile_rows(d) : 0; }

// The scratch bytes a launch with these arguments needs, in *bytes; 0 or an
// error.
int embedding_bwd_scratch(int64_t n_g, int64_t n_entries, int64_t n, int d, int tile_rows,
                          int ctas_per_sm, int64_t* bytes) {
  if (bad_shape(n_g, n_entries, n, d) || tile_rows < 0 || tile_rows % 4 != 0 ||
      ctas_per_sm < 0)
    return cudaErrorInvalidValue;
  Plan p;
  const int err = plan(n_entries, d, tile_rows, ctas_per_sm, p);
  if (err != cudaSuccess) return err;
  *bytes = scratch_bytes(p, n_entries, n, d);
  return cudaSuccess;
}

// One cooperative launch.  g: [n_g, d] float32; seg: [n_entries] ids sorted
// ascending, seg_bytes (4 or 8) each; order: [n_entries], order_bytes (4 or
// 8) each; out: [n, d] float32, 16-byte aligned, every element written;
// scratch: embedding_bwd_scratch's bytes, 16-byte aligned.  n, n_g and
// n_entries < 2**31.  tile_rows: rows a tile, a multiple of 4 (0: the
// source's own); ctas_per_sm: CTAs an SM (0: the source's own; at most as
// many as fit).
int embedding_bwd(const void* g, int64_t n_g, const void* seg, int seg_bytes, const void* order,
                  int order_bytes, int64_t n_entries, void* out, int64_t n, int d, int bag,
                  void* scratch, int64_t scratch_size, int tile_rows, int ctas_per_sm,
                  void* stream) {
  if (bad_shape(n_g, n_entries, n, d) || bag < 1 || out == nullptr ||
      (uintptr_t)out % 16 != 0 || scratch == nullptr || (uintptr_t)scratch % 16 != 0 ||
      (seg_bytes != 4 && seg_bytes != 8) || (order_bytes != 4 && order_bytes != 8) ||
      (n_entries > 0 && (seg == nullptr || order == nullptr || (n_g > 0 && g == nullptr))) ||
      tile_rows < 0 || tile_rows % 4 != 0 || ctas_per_sm < 0)
    return cudaErrorInvalidValue;
  Plan p;
  int err = plan(n_entries, d, tile_rows, ctas_per_sm, p);
  if (err != cudaSuccess) return err;
  if (scratch_size < scratch_bytes(p, n_entries, n, d)) return cudaErrorInvalidValue;
  char* s = static_cast<char*>(scratch);
  Args a;
  a.g = static_cast<const float*>(g);
  a.seg = seg;
  a.order = order;
  a.out = static_cast<float*>(out);
  a.cta_runs = reinterpret_cast<int*>(s);
  s += align16(4 * (int64_t)p.grid);
  a.counter = reinterpret_cast<int*>(s);
  s += align16(4);
  a.tile_start = reinterpret_cast<int*>(s);
  s += align16(4 * (n_tiles_of(p, n) + 1));
  a.keys = reinterpret_cast<int*>(s);
  s += align16(4 * n_entries);
  a.first = reinterpret_cast<int*>(s);
  s += align16(4 * n_entries);
  a.sums = reinterpret_cast<float*>(s);
  s += align16(4 * n_entries * d);
  a.head = reinterpret_cast<float*>(s);
  a.n_entries = n_entries;
  a.n_g = n_g;
  a.n = n;
  a.n_tiles = (n + p.rows - 1) / p.rows;
  a.piece = p.piece;
  a.d = d;
  a.bag = bag;
  a.tile_rows = p.rows;
  a.seg_bytes = seg_bytes;
  a.order_bytes = order_bytes;
  a.pair = d % 2 == 0 && (uintptr_t)g % 8 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (maxd_for(d)) {
    case 1: return launch<1>(a, p, st);
    case 2: return launch<2>(a, p, st);
    case 4: return launch<4>(a, p, st);
    case 8: return launch<8>(a, p, st);
    case 10: return launch<10>(a, p, st);
    case 16: return launch<16>(a, p, st);
    default: return launch<32>(a, p, st);
  }
}

}  // extern "C"
