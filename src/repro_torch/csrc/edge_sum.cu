// Deterministic per-destination edge reduction for Hopper (sm_90a), plain C
// interface.
//
// K3 edge_sum computes out[j] = sum over in-edges e of j of x[src[e]] * wgt[e].
// It has no Pallas source: it replaces the XLA segment_sum of the per-edge
// frontier round and of the warm-start product P.H in the JAX package
//   src/repro/core/diteration.py : frontier_step (jax.ops.segment_sum)
//   src/repro/api/session.py     : _SegmentSumDriver.warm_seed,
//                                  _BsrFrontierDriver.warm_seed
// torch's index_add_ would scatter with atomics on the card, whose float sum
// order changes from run to run; the stream soak's bit-exact replay forbids it.
//
// What bounds it on an H100: the edge bytes.  Each edge is read once (4-byte
// source id + 4-byte weight) plus a 4-byte gather of x[src]; one multiply-add
// per 12 bytes is far below the card's flop/byte balance, so only HBM matters.
//
// What the design does about it: the edges arrive sorted by destination (a CSC
// order built once on the host).  One thread owns one destination and walks its
// in-edges in that fixed order, so every sum runs in the same order on every
// launch and no two threads write the same output: no atomics.  The product is
// rounded before the add (__fmul_rn, __fadd_rn), as the reference computes the
// message first and sums it after.  A warp reads neighbouring destinations'
// edge ranges, which are contiguous in the CSC order.
//
// K3's lane form edge_sum_lanes computes the same sum for C lanes at once,
// out[c, j] = sum over in-edges e of j of x[c, src[e]] * wgt[e].  It replaces
// the vmapped segment_sum of the batched frontier round (multi-RHS solves and
// continuous-batching serving) in the JAX package
//   src/repro/api/session.py     : _batch_fns._round (the sum at :114-116)
// Zero padding lanes must leave the real lanes bit for bit as they are, and
// serving replays must be bit-exact, so again no atomics.
//
// What bounds it: the edge bytes read once (8 bytes an edge) and the lanes'
// x read and out written once, 8·C bytes a node; one multiply-add an edge
// and lane is far below the flop/byte balance.  What holds it back on the
// card is not those bytes: the x gathers are 4-byte loads scattered over
// C rows, several 32-byte sectors a warp's load, and their trips through
// L1 and L2 (on an H100, builds of this file without the gathers took
// under half the time, and with a quarter of the rows or of the loads two
// thirds: PERF.md holds the measurements).  The first design, a thread a
// (destination, lane), also walked every edge once a lane: each lane's
// warp loaded the edge list again, one dependent load pair at a time.
//
// What the design does about it: a block owns a tile of consecutive
// destinations (256 / G of them for G groups of kLanes lanes), stages the
// tile's edges [indptr[j0], indptr[j0 + T]) in shared memory with coalesced
// cp.async copies, and reads each edge from memory once a launch (once a
// kLaneBlock lanes).  Blocks are persistent: while a block sums tile i, the
// copies of tile i + 1's edges and tile i + 2's indptr are in flight; a
// tile of more than kEdgeStage edges (a hub) streams the rest through in
// chunks.  A thread carries kLanes lanes' sums in registers for one
// destination and walks its edges from shared memory in CSC order, kUnroll
// edges' gathers issued together, then added in edge order with K3's
// arithmetic (__fmul_rn, then __fadd_rn): lane c is bit-equal to K3
// launched on row c, a zero lane gives a zero row, and the result does not
// depend on C.  A warp takes 32 neighbouring destinations of one lane
// group, so its gathers fall on one row of x and its stores on one row of
// out.  The gathers read x lane-major as the caller holds it: on
// host-ordered graphs, whose sources lie near their destinations, that beat
// a node-major copy of x staged by a first kernel, which was faster only
// where the node order has no locality (PERF.md holds both).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
edge_sum_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ src,
                const float* __restrict__ wgt, const float* __restrict__ x,
                float* __restrict__ out, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int64_t lo = indptr[j], hi = indptr[j + 1];
  float acc = 0.0f;
  for (int64_t e = lo; e < hi; ++e)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(x + __ldg(src + e)), __ldg(wgt + e)));
  out[j] = acc;
}

constexpr int kLaneThreads = 256;  // threads a block of the lane form
constexpr int kLaneBlocks = 4;     // its blocks an SM (64 registers a thread)
constexpr int kLanes = 4;          // lanes a thread sums
constexpr int kLaneBlock = 64;     // lanes a block at most (gridDim.y above)
constexpr int kEdgeStage = 2048;   // edges a stage holds
constexpr int kUnroll = 2;         // edges whose gathers a thread issues together
constexpr int kMaxDevices = 64;    // devices whose resident block count is kept

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t saddr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t saddr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(saddr), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

struct LaneArgs {
  const int64_t* __restrict__ indptr;
  const int32_t* __restrict__ src;
  const float* __restrict__ wgt;
  const float* __restrict__ x;  // [lanes, x_len]
  float* __restrict__ out;
  int64_t n, x_len, lanes, n_tiles;
  int tile;    // destinations a tile
  int groups;  // lane groups of kLanes a block
};

struct LaneStage {
  int64_t ptr[3][kLaneThreads + 1];  // indptr of three tiles (a ring)
  int32_t src[2][kEdgeStage];        // edges of two tiles (a ring)
  float wgt[2][kEdgeStage];
};

// starts the copy of tile t's indptr [j0, j0 + tn] into ptr
__device__ __forceinline__ void fetch_ptr(const LaneArgs& a, int64_t* ptr, int64_t t) {
  const int64_t j0 = t * a.tile;
  const int tn = (int)min((int64_t)a.tile, a.n - j0);
  for (int i = threadIdx.x; i <= tn; i += kLaneThreads) cp_async8(ptr + i, a.indptr + j0 + i);
}

// starts the copy of the first kEdgeStage edges of the tile whose indptr
// is ptr (already in shared memory)
__device__ __forceinline__ void fetch_edges(const LaneArgs& a, const int64_t* ptr, int64_t t,
                                            int32_t* s_src, float* s_wgt) {
  const int tn = (int)min((int64_t)a.tile, a.n - t * a.tile);
  const int64_t e0 = ptr[0];
  const int len = (int)min((int64_t)kEdgeStage, ptr[tn] - e0);
  for (int i = threadIdx.x; i < len; i += kLaneThreads) {
    cp_async4(s_src + i, a.src + e0 + i);
    cp_async4(s_wgt + i, a.wgt + e0 + i);
  }
}

// source s's kLanes lanes of this thread's group (zeros past the last lane)
__device__ __forceinline__ void gather(const float* const* xl, int nl, int64_t s, float* v) {
#pragma unroll
  for (int l = 0; l < kLanes; ++l) v[l] = l < nl ? __ldg(xl[l] + s) : 0.0f;
}

// adds edges [k, end) of a staged chunk into acc, kUnroll edges' gathers
// issued together, each edge's lanes added in edge order (K3's arithmetic)
__device__ __forceinline__ void walk(const int32_t* s_src, const float* s_wgt, int k, int end,
                                     const float* const* xl, int nl, float* acc) {
  for (; k + kUnroll <= end; k += kUnroll) {
    float v[kUnroll][kLanes];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) gather(xl, nl, s_src[k + u], v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        acc[l] = __fadd_rn(acc[l], __fmul_rn(v[u][l], s_wgt[k + u]));
  }
  for (; k < end; ++k) {
    float v[kLanes];
    gather(xl, nl, s_src[k], v);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) acc[l] = __fadd_rn(acc[l], __fmul_rn(v[l], s_wgt[k]));
  }
}

// Persistent blocks: block (bx, by) takes tiles bx, bx + gridDim.x, ... of
// a.tile destinations each, lanes [by·kLaneBlock, +4·groups); thread (d, g)
// sums lanes 4g.. of destination d of the tile.  While it sums tile i, the
// copies of tile i + 1's edges and tile i + 2's indptr are in flight
// (cp.async); a tile with more than kEdgeStage edges loads the rest in
// chunks after its first.
__global__ void __launch_bounds__(kLaneThreads, kLaneBlocks)
edge_sum_lanes_kernel(const LaneArgs a) {
  __shared__ LaneStage st;
  const int tid = threadIdx.x;
  // a warp takes neighbouring destinations of one lane group: its gathers
  // fall on one row of x and its stores on one row of out
  const int d = tid % a.tile, g = tid / a.tile;
  const int64_t c0 = (int64_t)blockIdx.y * kLaneBlock + g * kLanes;
  const int nl = (int)min((int64_t)kLanes, a.lanes - c0);  // <= 0: no lanes
  const bool has_lanes = d < a.tile && g < a.groups && nl > 0;
  const float* xl[kLanes];  // each lane's row of x, clamped to a real lane
#pragma unroll
  for (int l = 0; l < kLanes; ++l) xl[l] = a.x + (c0 + (l < nl ? l : 0)) * a.x_len;
  const int64_t step = gridDim.x;
  int64_t t = blockIdx.x;
  if (t >= a.n_tiles) return;
  fetch_ptr(a, st.ptr[0], t);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  fetch_edges(a, st.ptr[0], t, st.src[0], st.wgt[0]);
  if (t + step < a.n_tiles) fetch_ptr(a, st.ptr[1], t + step);
  cp_async_commit();
  for (int i = 0; t < a.n_tiles; ++i, t += step) {
    const int pb = i % 3, eb = i & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t's edges and tile t + step's indptr are in
    if (t + step < a.n_tiles)
      fetch_edges(a, st.ptr[(i + 1) % 3], t + step, st.src[eb ^ 1], st.wgt[eb ^ 1]);
    if (t + 2 * step < a.n_tiles) fetch_ptr(a, st.ptr[(i + 2) % 3], t + 2 * step);
    cp_async_commit();
    const int64_t* ptr = st.ptr[pb];
    const int64_t j0 = t * a.tile;
    const int tn = (int)min((int64_t)a.tile, a.n - j0);
    const bool mine = has_lanes && d < tn;
    const int64_t e0 = ptr[0], e1 = ptr[tn];
    const int64_t lo = mine ? ptr[d] : 0, hi = mine ? ptr[d + 1] : 0;
    float acc[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) acc[l] = 0.0f;
    for (int64_t cs = e0; cs < e1; cs += kEdgeStage) {
      const int len = (int)min((int64_t)kEdgeStage, e1 - cs);
      if (cs != e0) {  // a long tile: the next chunk, loaded here
        __syncthreads();
        for (int q = tid; q < len; q += kLaneThreads) {
          st.src[eb][q] = __ldg(a.src + cs + q);
          st.wgt[eb][q] = __ldg(a.wgt + cs + q);
        }
        __syncthreads();
      }
      if (mine)
        walk(st.src[eb], st.wgt[eb], (int)(max(lo, cs) - cs), (int)(min(hi, cs + len) - cs), xl,
             nl, acc);
    }
    if (mine) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        if (l < nl) a.out[(c0 + l) * a.n + j0 + d] = acc[l];
    }
  }
}

// persistent blocks: as many as stay resident on the card, no more than
// there are tiles.  The resident count is asked of the runtime once a
// device and kept (a launch costs a cudaGetDevice, no attribute query).
cudaError_t lane_grid(int64_t n_tiles, int64_t* grid_x) {
  static std::atomic<int64_t> resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int64_t blocks = dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (blocks == 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_sum_lanes_kernel,
                                                          kLaneThreads, 0);
    if (err != cudaSuccess) return err;
    blocks = (int64_t)(per_sm < 1 ? 1 : per_sm) * n_sm;
    if (dev < kMaxDevices) resident[dev].store(blocks, std::memory_order_relaxed);
  }
  *grid_x = n_tiles < blocks ? n_tiles : blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// indptr: [n + 1] over the destination-sorted edges; src, wgt: [n_edges];
// x, out: [n].
int edge_sum(const void* indptr, const void* src, const void* wgt, const void* x, void* out,
             int64_t n, void* stream) {
  if (n == 0) return cudaSuccess;
  const int64_t grid = (n + kThreads - 1) / kThreads;
  edge_sum_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int32_t*)src, (const float*)wgt, (const float*)x,
      (float*)out, n);
  return cudaGetLastError();
}

// indptr: [n + 1]; src, wgt: [n_edges]; x: [lanes, x_len] (row-major); out:
// [lanes, n].
int edge_sum_lanes(const void* indptr, const void* src, const void* wgt, const void* x,
                   void* out, int64_t n, int64_t x_len, int64_t lanes, void* stream) {
  if (n == 0 || lanes == 0) return cudaSuccess;
  const int64_t c4 = (lanes + 3) / 4 * 4;
  const int groups = (int)((lanes < kLaneBlock ? c4 : kLaneBlock) / kLanes);
  const int tile = kLaneThreads / groups;
  const int64_t n_tiles = (n + tile - 1) / tile;
  const int64_t grid_y = (lanes + kLaneBlock - 1) / kLaneBlock;
  if (grid_y > 65535) return cudaErrorInvalidConfiguration;
  int64_t grid_x = 0;
  const cudaError_t err = lane_grid(n_tiles, &grid_x);
  if (err != cudaSuccess) return err;
  const LaneArgs a{(const int64_t*)indptr, (const int32_t*)src, (const float*)wgt,
                   (const float*)x, (float*)out, n, x_len, lanes, n_tiles, tile, groups};
  edge_sum_lanes_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y), kLaneThreads, 0,
                          (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
