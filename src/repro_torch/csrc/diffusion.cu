// Block-sparse (BSR) diffusion kernels for Hopper (sm_90a), plain C interface.
//
// K1 frontier_round_bsr replaces the TPU kernel
//   src/repro/kernels/diffusion/kernel.py : frontier_round_bsr_pallas
//   (bodies _frontier_kernel / _frontier_kernel_dma).
// K2 bsr_spmm replaces
//   src/repro/kernels/diffusion/kernel.py : bsr_spmm_pallas (body _kernel),
//   and takes a visit table (visit_block, visit_col, row_ptr) so the engine's
//   bsr_gather_spmm_pallas can later run on the same kernel.
//
// What bounds them on an H100: the tile bytes.  Each [bs, bs] f32 tile is read
// once per round (64 KiB at bs = 128) against bs * C fluid values, so at C = 1
// a round does 2 flops per 4-byte weight: 0.5 flop/byte, far below the card's
// ~20 flop/byte f32 balance point.  Only the HBM rate matters.
//
// What the design does about it:
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 4;

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

__device__ __forceinline__ void block_l1(const float* __restrict__ acc_s, float* __restrict__ out,
                                         float* __restrict__ red_s, float* __restrict__ row_l1,
                                         int m, int tid, int warp, int lane) {
  float l1 = 0.0f;
  for (int i = tid; i < m; i += kThreads) {
    const float v = acc_s[i];
    out[i] = v;
    l1 += fabsf(v);
  }
  l1 = warp_sum(l1);
  if (lane == 0) red_s[warp] = l1;
  __syncthreads();
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
  block_l1(acc_s, f_new + (size_t)r * m, red_s, row_l1 + r, m, tid, warp, lane);
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

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// f, f_new: [n_row_blocks, bs, C]; wt: [n_row_blocks, bs]; row_l1: [n_row_blocks];
// blocks: [n_blocks, bs, bs] sorted by block row; block_col: [n_blocks];
// row_ptr: [n_row_blocks + 1]; col_active: [n_row_blocks].
int frontier_round_bsr(const void* blocks, const void* block_col, const void* row_ptr,
                       const void* col_active, const void* f, const void* wt, void* f_new,
                       void* row_l1, int n_row_blocks, int bs, int C, void* stream) {
  const size_t smem = (2 * (size_t)bs * C + kWarps) * sizeof(float);
  cudaError_t err = prepare(frontier_round_kernel, smem);
  if (err != cudaSuccess || n_row_blocks == 0) return err;
  frontier_round_kernel<<<n_row_blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int32_t*)block_col, (const int64_t*)row_ptr,
      (const int32_t*)col_active, (const float*)f, (const float*)wt, (float*)f_new,
      (float*)row_l1, bs, C);
  return cudaGetLastError();
}

// x: [n_col_blocks, bs, C]; out: [n_row_blocks, bs, C]; visits sorted by
// destination row, row_ptr: [n_row_blocks + 1] over the visits.
int bsr_spmm(const void* blocks, const void* visit_block, const void* visit_col,
             const void* row_ptr, const void* x, void* out, int n_row_blocks, int bs, int C,
             void* stream) {
  const size_t smem = 2 * (size_t)bs * C * sizeof(float);
  cudaError_t err = prepare(bsr_spmm_kernel, smem);
  if (err != cudaSuccess || n_row_blocks == 0) return err;
  bsr_spmm_kernel<<<n_row_blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int32_t*)visit_block, (const int32_t*)visit_col,
      (const int64_t*)row_ptr, (const float*)x, (float*)out, bs, C);
  return cudaGetLastError();
}

}  // extern "C"
