// Row gather and sorted row scatter-add, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by ops/_build.py; every entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() of its launch.
//
// Row gather (mv_row_gather) replaces the TPU kernel
// multiverso_tpu/ops/table_kernels.py build_row_gather / _gather_kernel:
// out[i] = param[ids[i]]. It copies rows of 2-byte or 4-byte elements
// (float32 and int32 tables, the LDA's bf16 word-count mirror and int16
// doc counts) as bytes.
//
// Sorted row scatter-add (mv_row_scatter_add) replaces
// multiverso_tpu/ops/table_kernels.py build_row_scatter_add /
// _row_scatter_kernel and, with `valid` non-null,
// build_row_scatter_add_masked / _row_scatter_masked_kernel: for ids
// sorted ascending, every run of equal ids adds its (valid) deltas to its
// row, which is read once and written once; rows no id names are not
// touched (the table is updated in place, the counterpart of the TPU
// kernel's input_output_aliases). float32 and int32 tables.
//
// What bounds them: bytes moved. Both do one add per element at most, far
// below the card's rate. A word2vec step (batch 4096, 5 negatives,
// dim 100) gathers B*(1+K) = 24,576 rows of 400 bytes from w_out and
// scatters as many back, so each call moves about 10 MB each way; a
// LightLDA step gathers 512,000 bf16 word-count rows of 2 KB (1 GB).
//
// What the design does about it: one warp per row, 16-byte loads and
// stores when the row's bytes are a multiple of 16 and the pointers are
// 16-byte aligned (a 100-wide float32 row is 25 of them, one per lane),
// narrower accesses otherwise; each warp reads its own ids (no scalar
// prefetch).
//
// The TPU scatter relied on its sequential grid to keep a row resident
// across consecutive equal ids. Hopper blocks run in parallel and in no
// order, so here the warp of lane i works only if i starts a run
// (i == 0 || ids[i] != ids[i-1]). It walks the run 32 lanes at a time
// (a ballot finds where the run ends), adds the deltas of its valid lanes
// in lane order onto the row held in registers, and writes the row once.
// No two warps touch one row, so there are no atomics and the result is
// deterministic: row + d[first] + d[second] + ..., the TPU kernel's order.
// A frequent id (Zipf-skewed words) makes one warp walk a long run alone;
// splitting long runs across warps is left for later work.
//
// The row window. Both entry points take `lo`, the global id of the
// table's first row: a lane's row is ids[i] - lo, and a lane whose row
// falls outside [0, rows) is foreign. A flat table passes lo = 0. A table
// split into shards of `rows` rows launches each shard over the GLOBAL
// lanes with lo = shard * rows; this replaces the in-trace sharded forms
// of multiverso_tpu/ops/table_kernels.py (_sharded_gather_rows,
// _sharded_row_scatter_add), which mask foreign lanes inside a shard_map.
// The reference parks a foreign lane on the shard's last row under a
// write gate. Here that would make a second run of that row (a warp that
// rewrites it unchanged while the real run's warp adds to it: a lost
// update) and a serial walk over every lane below the shard. With a window
// a foreign lane exits at the run-owner and range checks, and sorted
// global ids keep a shard's lanes contiguous, so a shard's walk is the
// flat kernel's walk over the same lanes and its rows come out bit for
// bit the same. The gather writes a foreign lane's out row as zeros when
// `zero_foreign` is set (the flat form, and the first shard of a sharded
// gather into one output), and leaves it untouched otherwise (the other
// shards' lanes of that output).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// V is the access type: the element itself or a 16-byte vector of them.
__device__ __forceinline__ void vadd(float& a, const float& b) { a += b; }
__device__ __forceinline__ void vadd(int32_t& a, const int32_t& b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void vadd(int4& a, const int4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Copies `words` units of type V per row (the row's bytes / sizeof(V)).
template <typename V>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
row_gather_kernel(const V* __restrict__ param, int64_t rows, int64_t words,
                  int64_t lo, int zero_foreign,
                  const int32_t* __restrict__ ids, int64_t n,
                  V* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;
  const int64_t r = (int64_t)ids[i] - lo;
  V* dst = out + i * words;
  if (r < 0 || r >= rows) {  // foreign: a row of zeros, or untouched
    if (zero_foreign)
      for (int64_t c = lane; c < words; c += kWarp) dst[c] = V{};
    return;
  }
  const V* src = param + r * words;
  for (int64_t c = lane; c < words; c += kWarp) dst[c] = src[c];
}

// E is the element type, V the access type (E or a 16-byte vector of E);
// `vcols` counts V units per row.
template <typename E, typename V>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
row_scatter_add_kernel(E* __restrict__ param, int64_t rows, int64_t vcols,
                       int64_t lo, const int32_t* __restrict__ ids,
                       const int64_t* __restrict__ order,
                       const E* __restrict__ deltas,
                       const int32_t* __restrict__ valid, int64_t n) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;
  const int32_t r = ids[i];
  if (i > 0 && ids[i - 1] == r) return;  // the run's first lane owns the row
  const int64_t local = (int64_t)r - lo;
  if (local < 0 || local >= rows) return;  // foreign or out of range
  V* row = reinterpret_cast<V*>(param) + local * vcols;
  const V* dv = reinterpret_cast<const V*>(deltas);
  // one pass per 32 V units of the row
  for (int64_t c = lane; c - lane < vcols; c += kWarp) {
    const bool has_col = c < vcols;
    V acc = has_col ? row[c] : V{};
    for (int64_t j0 = i;; j0 += kWarp) {
      const int64_t j = j0 + lane;
      const bool in_run = j < n && ids[j] == r;
      const unsigned run = __ballot_sync(kFull, in_run);
      // lanes 0..len-1 of this chunk continue the run
      const int len = (~run == 0u) ? kWarp : __ffs(~run) - 1;
      int64_t src = 0;
      int ok = 0;
      if (in_run) {
        src = order != nullptr ? order[j] : j;
        ok = valid == nullptr || valid[src] != 0;
      }
#pragma unroll 4
      for (int k = 0; k < len; ++k) {
        const int64_t s = __shfl_sync(kFull, src, k);
        const int okk = __shfl_sync(kFull, ok, k);
        if (okk && has_col) vadd(acc, dv[s * vcols + c]);
      }
      if (len < kWarp) break;
    }
    if (has_col) row[c] = acc;
  }
}

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename E, typename V4>
int launch_scatter(E* param, int64_t rows, int64_t cols, int64_t lo,
                   const int32_t* ids, const int64_t* order, const E* deltas,
                   const int32_t* valid, int64_t n, cudaStream_t s) {
  const dim3 grid(blocks_for(n)), block(kWarp * kWarpsPerBlock);
  if (cols % 4 == 0 && aligned(param, 16) && aligned(deltas, 16))
    row_scatter_add_kernel<E, V4><<<grid, block, 0, s>>>(
        param, rows, cols / 4, lo, ids, order, deltas, valid, n);
  else
    row_scatter_add_kernel<E, E><<<grid, block, 0, s>>>(
        param, rows, cols, lo, ids, order, deltas, valid, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `elem_bytes` is 2 or 4: the row is cols * elem_bytes bytes. `lo`: the
// global id of param's first row; `zero_foreign`: 1 writes zeros for a lane
// outside [lo, lo + rows), 0 leaves its out row untouched.
int mv_row_gather(const void* param, int64_t rows, int64_t cols,
                  int64_t elem_bytes, int64_t lo, int64_t zero_foreign,
                  const int32_t* ids, int64_t n, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(n)), block(kWarp * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bytes = cols * elem_bytes;
  const int zf = zero_foreign != 0;
  if (bytes % 16 == 0 && aligned(param, 16) && aligned(out, 16))
    row_gather_kernel<uint4><<<grid, block, 0, s>>>(
        static_cast<const uint4*>(param), rows, bytes / 16, lo, zf, ids, n,
        static_cast<uint4*>(out));
  else if (bytes % 4 == 0 && aligned(param, 4) && aligned(out, 4))
    row_gather_kernel<uint32_t><<<grid, block, 0, s>>>(
        static_cast<const uint32_t*>(param), rows, bytes / 4, lo, zf, ids, n,
        static_cast<uint32_t*>(out));
  else
    row_gather_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(param), rows, bytes / 2, lo, zf, ids, n,
        static_cast<uint16_t*>(out));
  return (int)cudaGetLastError();
}

// `is_int`: 0 for float32 tables and deltas, 1 for int32.
// `lo`: the global id of param's first row (lanes outside the window add
// nothing). `order` (nullable): deltas row of sorted lane j is order[j],
// else j. `valid` (nullable): indexed like deltas rows; 0 gates the lane
// off.
int mv_row_scatter_add(void* param, int64_t rows, int64_t cols,
                       int64_t is_int, int64_t lo, const int32_t* ids,
                       const int64_t* order, const void* deltas,
                       const int32_t* valid, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int)
    return launch_scatter<int32_t, int4>(
        static_cast<int32_t*>(param), rows, cols, lo, ids, order,
        static_cast<const int32_t*>(deltas), valid, n, s);
  return launch_scatter<float, float4>(
      static_cast<float*>(param), rows, cols, lo, ids, order,
      static_cast<const float*>(deltas), valid, n, s);
}

}  // extern "C"
