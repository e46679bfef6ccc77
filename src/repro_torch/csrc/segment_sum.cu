// Sorted, optionally weighted and optionally gathered segment sum for Hopper
// (sm_90a), plain C interface.
//
// K5 segment_sum computes, for ids seg sorted ascending and data: [*, D]
// float32,
//   out[s] = sum over rows e with seg[e] == s of w[e] * data[r(e)]   (s < n)
// where r(e) = e (the contiguous form) or rows[e] (the gather form: with
// rows = a graph's sources and data = the node states it is one GIN
// aggregation, h[src] never made), and w is optional (absent: 1).
// Segments that receive no row are 0; rows whose id lies outside [0, n)
// contribute nothing (the 2**30 sentinel of padded edges); a rows[e]
// outside [0, n_data) reads as a zero row.  The product is rounded before
// the add (__fmul_rn, __fadd_rn), as the reference multiplies the messages
// by the mask first.
// It replaces the TPU kernel and its epilogue
//   src/repro/kernels/segment/kernel.py : segment_sum_tiles (stage 1)
//   src/repro/kernels/segment/ops.py    : segment_sum_sorted (stage 2)
// whose one-hot matmul exists because the TPU has no scatter; it is not
// carried over.
//
// What bounds it on an H100: the bytes of the rows.  Each row is read once
// and takes one multiply-add per element, far below the card's flop/byte
// balance.  For GIN at the ogb_products cell (E=61,859,328, D=64) the
// contiguous form reads 15.8 GB, about 5 ms at 3.35 TB/s; the gather form
// reads the same 15.8 GB of rows from the 0.63 GB node table, as much of
// it from L2 as the sources repeat.
//
// What the design does about it:
// * Edge-balanced work.  A CTA takes a fixed chunk of kChunk sorted rows,
//   whatever the segments' lengths (power-law in-degrees), and splits it
//   into walkers: groups of G lanes, each lane one vector of VEC floats of
//   the row (D=64: 16 lanes of float4, a 256-byte row per walker step),
//   each walker a contiguous run of kChunk / walkers rows.  A grid column
//   per G * VEC columns covers any D; VEC is the widest of 4, 2, 1 that
//   divides D (and the data's alignment), so every D >= 1 runs here.
// * Deep streaming.  A CTA first loads its chunk's ids, weights and (in the
//   gather form) row indices into a table in shared memory, coalesced,
//   once.  Then each lane copies its own vector of each of its walker's
//   rows (gather: from data + rows[e] * D) into its own slots of a ring of
//   kStages x kRows rows in shared memory (cp.async: 16 bytes a lane at
//   D % 4 == 0), kStages - 1 ahead of the row it adds.  A thread reads back
//   only what it copied, so the loop needs no barrier.  The table exists
//   because small copies, not bytes, limit a lane: a 4-byte copy of each
//   row's id and weight per lane beside its vector made the weighted form
//   1.7x slower than the unweighted one.
// * Deterministic boundaries, no float atomics.  A walker writes every
//   segment that lies wholly inside its run (and zeroes the empty ones
//   between); its first and last segment go to the CTA's merge, which adds
//   them in walker order.  The chunk's first segment, when it began in an
//   earlier chunk, and its last, when it goes on into the next, are
//   partial: the last goes to carry[chunk], the first to out, and a second
//   small kernel (segment_sum_carry) sets
//   out[s] = (carry[a] + ... + carry[b-1]) + out[s] in chunk order.
//   Relaunches are bit-identical.
// kChunk and kStages are what tools/k5_probe.py found fastest at GIN's
// ogb_products layer (the gather form runs best at four CTAs an SM); the
// probe builds this file with other values to time them.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // sorted rows a CTA, a multiple of kThreads
constexpr int kStages = 2;    // ring stages a walker keeps in flight
constexpr int kRows = 4;      // rows a walker copies per ring stage
constexpr int kNone = INT_MIN;
static_assert(kChunk % kThreads == 0, "a walker's run is kChunk / walkers rows");

template <int VEC>
struct alignas(4 * VEC) Vec {
  float v[VEC];
};

struct Args {
  const int64_t* ptr;  // [n + 1] row ranges of the sorted ids
  const int* plan;     // [n_chunks + 1] segment of each chunk's first row
  const int* seg;      // [E] sorted ids
  const void* rows;    // [E] int32 / int64 row of data, or null
  const float* data;   // [n_data, d]
  const float* w;      // [E] or null
  float* out;          // [n, d]
  float* carry;        // [n_chunks, d]
  int64_t n_rows, n_data;
  int n, d, lanes, units;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES from src into shared dst; with ok false nothing is read and dst
// gets zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok = true) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int VEC>
__device__ __forceinline__ void put(float* p, const Vec<VEC>& x) {
  *reinterpret_cast<Vec<VEC>*>(p) = x;
}

// read past L1: other CTAs wrote it
template <int VEC>
__device__ __forceinline__ Vec<VEC> get_cg(const float* p) {
  Vec<VEC> x;
#pragma unroll
  for (int i = 0; i < VEC; ++i) x.v[i] = __ldcg(p + i);
  return x;
}

template <int VEC>
__device__ __forceinline__ void add(Vec<VEC>& acc, const Vec<VEC>& x) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc.v[i] = __fadd_rn(acc.v[i], x.v[i]);
}

template <int VEC>
__device__ __forceinline__ Vec<VEC> zero() {
  Vec<VEC> x;
#pragma unroll
  for (int i = 0; i < VEC; ++i) x.v[i] = 0.0f;
  return x;
}

// out[t] = 0 for the empty segments t in [from, to) that lie in [0, n)
template <int VEC>
__device__ __forceinline__ void zero_fill(const Args& a, int from, int to, int col) {
  const int hi = min(to, a.n);
  for (int t = max(from, 0); t < hi; ++t) put(a.out + (int64_t)t * a.d + col, zero<VEC>());
}

// out[s] = (carry[from] + ... + carry[to - 1]) + out[s], in chunk order
template <int VEC>
__device__ void combine(const Args& a, int s, int64_t from, int64_t to, int col) {
  Vec<VEC> acc = get_cg<VEC>(a.carry + from * a.d + col);
  for (int64_t k = from + 1; k < to; ++k) add(acc, get_cg<VEC>(a.carry + k * a.d + col));
  float* o = a.out + (int64_t)s * a.d + col;
  add(acc, get_cg<VEC>(o));
  put(o, acc);
}

template <int IDX>
__device__ __forceinline__ int64_t row_of(const Args& a, int64_t e) {
  if constexpr (IDX == 4) return __ldg(static_cast<const int*>(a.rows) + e);
  if constexpr (IDX == 8) return __ldg(static_cast<const int64_t*>(a.rows) + e);
  return e;
}

// Places one segment of the CTA's merge: the chunk's last, when it goes on
// into the next chunk, in carry[c]; any other in out (segment_sum_carry
// adds to it the carries of a segment begun in an earlier chunk).
template <int VEC>
__device__ void emit(const Args& a, int s, const Vec<VEC>& v, bool last, int64_t c, int col) {
  if (s < 0 || s >= a.n) return;
  if (last && s == __ldg(a.plan + c + 1))
    put(a.carry + c * a.d + col, v);
  else
    put(a.out + (int64_t)s * a.d + col, v);
}

// Shared memory of a CTA: the chunk's ids, weights and row indices (one
// table, read by every lane), then the rows' ring, per thread and
// slot-major (ring[slot][kThreads]).
__host__ __device__ constexpr int table_bytes(bool weighted, bool gather) {
  return kChunk * 4 * (1 + (weighted ? 1 : 0) + (gather ? 1 : 0));
}

template <int VEC, int IDX>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(const Args a) {
  using V = Vec<VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int piece_seg[3][kThreads];  // a walker's first / last id, count
  const bool weighted = a.w != nullptr;
  int* t_seg = reinterpret_cast<int*>(smem);
  float* t_w = reinterpret_cast<float*>(t_seg + kChunk);
  int* t_row = reinterpret_cast<int*>(t_seg + kChunk * (weighted ? 2 : 1));
  V* ring = reinterpret_cast<V*>(smem + table_bytes(weighted, IDX != 0));
  const int tid = threadIdx.x;
  const int G = a.lanes, walkers = kThreads / G;
  const int walker = tid / G, lane = tid % G;
  const int unit = blockIdx.y * G + lane;
  const bool active = unit < a.units;
  const int col = unit * VEC;
  const int64_t c = blockIdx.x;
  const int64_t r0 = c * kChunk;
  const int len = (int)min((int64_t)kChunk, a.n_rows - r0);
  const int per = kChunk / walkers;
  const int lo = min(walker * per, len), hi = min(lo + per, len);

  // the chunk's table, loaded once: ids clamped to [-1, n], rows outside
  // [0, n_data) marked -1
  for (int i = tid; i < len; i += kThreads) {
    t_seg[i] = min(max(__ldg(a.seg + r0 + i), -1), a.n);
    if (weighted) t_w[i] = __ldg(a.w + r0 + i);
    if constexpr (IDX != 0) {
      const int64_t r = row_of<IDX>(a, r0 + i);
      t_row[i] = r >= 0 && r < a.n_data ? (int)r : -1;
    }
  }
  __syncthreads();

  if (active) {
    const int n_steps = (hi - lo + kRows - 1) / kRows;
    auto fetch = [&](int step) {
      const int base = (step % kStages) * kRows;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = lo + step * kRows + u;
        if (step < n_steps && i < hi) {
          const int64_t r = IDX == 0 ? r0 + i : t_row[i];
          cp_async<4 * VEC>(ring + (base + u) * kThreads + tid,
                            r >= 0 ? a.data + r * a.d + col : a.data, r >= 0);
        }
      }
      cp_commit();  // an empty group past the end keeps the count uniform
    };
    for (int st = 0; st < kStages - 1; ++st) fetch(st);

    int cur = kNone, n_closed = 0, head_seg = kNone;
    V acc = zero<VEC>(), head = zero<VEC>();
    for (int k = 0; k < n_steps; ++k) {
      fetch(k + kStages - 1);
      cp_wait<kStages - 1>();  // stage k has landed for this thread
      const int base = (k % kStages) * kRows;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = lo + k * kRows + u;
        if (i >= hi) break;
        const int s = t_seg[i];
        const float wt = weighted ? t_w[i] : 1.0f;
        const V x = ring[(base + u) * kThreads + tid];
        if (s != cur) {
          if (cur != kNone) {
            if (n_closed++ == 0) {
              head = acc;
              head_seg = cur;
            } else if (cur >= 0 && cur < a.n) {
              put(a.out + (int64_t)cur * a.d + col, acc);
            }
            zero_fill<VEC>(a, cur + 1, s, col);
          }
          cur = s;
          acc = zero<VEC>();
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc.v[j] = __fadd_rn(acc.v[j], __fmul_rn(wt, x.v[j]));
      }
    }
    cp_wait<0>();
    // the walker's pieces: values in this thread's own ring slots 0 and 1
    const int count = cur == kNone ? 0 : n_closed == 0 ? 1 : 2;
    piece_seg[2][tid] = count;
    if (count == 1) {
      ring[tid] = acc;
      piece_seg[0][tid] = cur;
    } else if (count == 2) {
      ring[tid] = head;
      piece_seg[0][tid] = head_seg;
      ring[kThreads + tid] = acc;
      piece_seg[1][tid] = cur;
    }
  }
  __syncthreads();
  if (tid >= G || !active) return;

  // walker 0's lanes merge the pieces in walker order
  int run = kNone;
  V racc = zero<VEC>();
  for (int wk = 0; wk < walkers; ++wk) {
    const int t = wk * G + lane;
    const int count = piece_seg[2][t];
    for (int p = 0; p < count; ++p) {
      const int s = piece_seg[p][t];
      const V v = ring[p * kThreads + t];
      if (s == run) {
        add(racc, v);
        continue;
      }
      if (run != kNone) {
        emit<VEC>(a, run, racc, false, c, col);
        // between two walkers (a walker filled the gaps inside its run)
        if (p == 0) zero_fill<VEC>(a, run + 1, s, col);
      } else if (c == 0) {
        zero_fill<VEC>(a, 0, s, col);  // the segments before the first row
      }
      run = s;
      racc = v;
    }
  }
  if (run == kNone) return;
  emit<VEC>(a, run, racc, true, c, col);
  // the empty segments up to the next chunk's first (all, after the last)
  zero_fill<VEC>(a, run + 1, __ldg(a.plan + c + 1), col);
}

// The carry pass: one walker a chunk; the chunk that owns a segment begun
// in an earlier chunk completes it.
template <int VEC>
__global__ void __launch_bounds__(kThreads) segment_carry_kernel(const Args a,
                                                                 int64_t n_chunks) {
  const int G = a.lanes;
  const int64_t c = (int64_t)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int unit = blockIdx.y * G + threadIdx.x % G;
  if (c >= n_chunks || unit >= a.units) return;
  const int s = __ldg(a.plan + c);
  if (s < 0 || s >= a.n || __ldg(a.plan + c + 1) == s) return;
  const int64_t begin = __ldg(a.ptr + s);
  if (begin >= c * kChunk) return;
  combine<VEC>(a, s, begin / kChunk, c, unit * VEC);
}

template <int VEC, int IDX>
int launch_main(const Args& a, int64_t n_chunks, int tiles, cudaStream_t stream) {
  const int smem = table_bytes(a.w != nullptr, IDX != 0) + kStages * kRows * kThreads * 4 * VEC;
  auto kern = segment_sum_kernel<VEC, IDX>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)n_chunks, (unsigned)tiles), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int VEC>
int by_index(const Args& a, int idx_bytes, int64_t n_chunks, int tiles, cudaStream_t stream) {
  switch (idx_bytes) {
    case 0: return launch_main<VEC, 0>(a, n_chunks, tiles, stream);
    case 4: return launch_main<VEC, 4>(a, n_chunks, tiles, stream);
    case 8: return launch_main<VEC, 8>(a, n_chunks, tiles, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Checks what the kernels assume and fills the arguments; 0 or an error.
int make_args(Args& a, const void* ptr, const void* plan, const void* seg, const void* rows,
              const void* data, const void* w, void* out, void* carry, int64_t n,
              int64_t n_rows, int64_t n_data, int d, int vec, int chunk, int lanes) {
  if (n <= 0 || n >= INT_MAX || d <= 0 || n_rows <= 0 || chunk != kChunk || lanes <= 0 ||
      lanes > 32 || kThreads % lanes != 0 || (vec != 1 && vec != 2 && vec != 4) ||
      d % vec != 0 || (rows != nullptr && n_data > INT_MAX))
    return cudaErrorInvalidValue;
  a = Args{(const int64_t*)ptr, (const int*)plan, (const int*)seg, rows,
           (const float*)data,  (const float*)w, (float*)out,     (float*)carry,
           n_rows,              n_data,          (int)n,          d,
           lanes,               d / vec};
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One launch of K5 over ceil(n_rows / kChunk) chunks.  ptr: [n + 1] int64;
// plan: [n_chunks + 1] int32, made for chunk rows a chunk (chunk must be
// kChunk); seg: [n_rows] int32 sorted; rows: [n_rows] of idx_bytes (4 or
// 8) or null (idx_bytes 0); data: [n_data, d] float32, aligned to 4 * vec
// bytes; w: [n_rows] float32 or null; out: [n, d]; carry: [n_chunks, d]
// float32 scratch.  lanes: G, a power of two <= 32; tiles =
// ceil(d / vec / lanes).
int segment_sum(const void* ptr, const void* plan, const void* seg, const void* rows,
                int idx_bytes, const void* data, const void* w, void* out, void* carry,
                int64_t n, int64_t n_rows, int64_t n_data, int d, int vec, int chunk, int lanes,
                void* stream) {
  Args a;
  int err = make_args(a, ptr, plan, seg, rows, data, w, out, carry, n, n_rows, n_data, d, vec,
                      chunk, lanes);
  if (err != cudaSuccess) return err;
  const int64_t n_chunks = (n_rows + kChunk - 1) / kChunk;
  const int tiles = (a.units + lanes - 1) / lanes;
  if (n_chunks > 0x7fffffff || tiles > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 4: return by_index<4>(a, idx_bytes, n_chunks, tiles, st);
    case 2: return by_index<2>(a, idx_bytes, n_chunks, tiles, st);
    default: return by_index<1>(a, idx_bytes, n_chunks, tiles, st);
  }
}

// The carry pass, after segment_sum when there is more than one chunk, with
// the same arguments.
int segment_sum_carry(const void* ptr, const void* plan, void* out, void* carry, int64_t n,
                      int64_t n_rows, int d, int vec, int chunk, int lanes, void* stream) {
  Args a;
  int err = make_args(a, ptr, plan, nullptr, nullptr, nullptr, nullptr, out, carry, n, n_rows,
                      0, d, vec, chunk, lanes);
  if (err != cudaSuccess) return err;
  const int64_t n_chunks = (n_rows + kChunk - 1) / kChunk;
  const int tiles = (a.units + lanes - 1) / lanes;
  const int64_t blocks = (n_chunks + kThreads / lanes - 1) / (kThreads / lanes);
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 4:
      segment_carry_kernel<4><<<dim3((unsigned)blocks, (unsigned)tiles), kThreads, 0, st>>>(
          a, n_chunks);
      break;
    case 2:
      segment_carry_kernel<2><<<dim3((unsigned)blocks, (unsigned)tiles), kThreads, 0, st>>>(
          a, n_chunks);
      break;
    default:
      segment_carry_kernel<1><<<dim3((unsigned)blocks, (unsigned)tiles), kThreads, 0, st>>>(
          a, n_chunks);
  }
  return cudaGetLastError();
}

}  // extern "C"
