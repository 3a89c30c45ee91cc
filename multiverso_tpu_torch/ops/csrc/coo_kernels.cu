// Sorted COO scatter-add, param[rows[i], cols[i]] += vals[i], for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by ops/_build.py; the
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.
//
// mv_coo_scatter_add replaces the TPU kernels of
// multiverso_tpu/ops/table_kernels.py build_coo_scatter_add / _coo_kernel
// and, with `valid` non-null, build_coo_scatter_add_masked /
// _coo_masked_kernel. Lanes come sorted by row (the host prep or the
// functional wrapper sorts them); a lane whose `valid` is 0, or whose row
// or column is out of range, adds nothing. A tiled [R, C/128, 128] table
// is the same memory as [R, C]. The table is updated in place.
//
// What bounds it: bytes. Each lane reads 12 bytes (row, column, value)
// and makes one add; each touched element is read and written once.
// LightLDA's sweep-end rebuild of the word-topic counts sends one lane per
// token (10M) into a [50,001, 1024] int32 table, and its word ids are
// Zipf-skewed: the top word owns about 14% of the lanes.
//
// What the design does about it.
//
// int32 (LightLDA's counts; exact in any order): the lanes are cut into
// chunks of kChunk, one block each. Within a chunk a run of equal rows
// shorter than kLongRun adds lane by lane with global atomics; a longer
// run (a head word) is summed into a shared-memory row accumulator first
// and its nonzero sums are merged into the table with one global atomic
// each. A run that spans chunks is merged chunk by chunk the same way, so
// no warp walks a long run alone and the head word's 1.4M lanes become at
// most one atomic per touched column per chunk.
//
// float32 (the sgd updater's sparse Add): float sums depend on their
// order, and the plain version (a stable-sorted index_add_ on the CPU)
// adds each element's terms in sorted lane order. So one thread owns each
// run of a row and adds its lanes in lane order: deterministic and equal
// bit for bit to the plain version, the TPU kernel's order too. Long
// float32 runs are walked by one thread; they are not on a hot path.
//
// The row window and the shards (shards.cuh): a lane's row is found
// among the launch's shards; a flat table is one shard whose first row has
// the global id 0, and a lane outside every window is foreign and adds
// nothing. A table split into shards launches
// once per card over the GLOBAL sorted lanes with every shard that card
// holds (mv_coo_scatter_add_mesh), replacing the in-trace
// _sharded_coo_scatter_add of multiverso_tpu/ops/table_kernels.py (masked
// lanes in a shard_map, the foreign ones parked on the shard's last row).
// Shards that share a card then run in one launch, not in turn: their
// long runs overlap. int32: a chunk whose rows meet no window exits
// before it loads anything (the lanes are sorted, so its first and last
// rows decide), and a foreign run is never summed in shared memory.
// float32: a foreign run's owner exits at the window check.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shards.cuh"

namespace {

using mv::Shards;
using mv::shard_row;

constexpr int kThreads = 256;
constexpr int kItems = 16;                    // lanes per thread
constexpr int kChunk = kThreads * kItems;     // lanes per block
constexpr int kAccCols = 4096;                // shared row accumulator (16 KB)
constexpr int kLongRun = 64;                  // runs this long use it

// first index in s[0, len) whose value is >= v (s sorted ascending)
__device__ __forceinline__ int lower_bound(const int32_t* s, int len,
                                           int32_t v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index in s[0, len) whose value is > v
__device__ __forceinline__ int upper_bound(const int32_t* s, int len,
                                           int32_t v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
coo_add_int_kernel(__grid_constant__ const Shards sh, int64_t nrows,
                   int64_t ncols, const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ cols,
                   const int32_t* __restrict__ vals,
                   const int32_t* __restrict__ valid, int64_t n) {
  __shared__ int32_t s_rows[kChunk];
  __shared__ int32_t s_acc[kAccCols];
  __shared__ int s_long[kChunk / kLongRun + 1];  // first lane of each long run
  __shared__ int s_nlong;
  const int64_t base = (int64_t)blockIdx.x * kChunk;
  const int64_t rest = n - base;
  const int len = rest < kChunk ? (int)rest : kChunk;
  // sorted lanes: a chunk whose rows meet no shard's window is foreign
  if (!mv::meets(sh, nrows, rows[base], rows[base + len - 1])) return;
  const bool shared_ok = ncols <= kAccCols;
  if (threadIdx.x == 0) s_nlong = 0;
  for (int i = threadIdx.x; i < len; i += kThreads)
    s_rows[i] = rows[base + i];  // global ids, sorted
  __syncthreads();

  // short runs: one global atomic per lane; long runs: note where they start
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int32_t r = s_rows[i];
    int32_t* dst = shard_row<int32_t>(sh, nrows, ncols, r);
    if (dst == nullptr) continue;  // foreign or out of range
    if (shared_ok) {
      const int run_lo = lower_bound(s_rows, len, r);
      const int run_hi = upper_bound(s_rows, len, r);
      if (run_hi - run_lo >= kLongRun) {
        if (i == run_lo) s_long[atomicAdd(&s_nlong, 1)] = run_lo;
        continue;
      }
    }
    const int64_t j = base + i;
    if (valid != nullptr && valid[j] == 0) continue;
    const int32_t c = cols[j];
    if (c < 0 || c >= ncols) continue;
    atomicAdd(dst + c, vals[j]);
  }
  __syncthreads();

  // long runs, one at a time: sum the chunk's part of the run in shared
  // memory, then merge each nonzero column into the table
  const int nlong = s_nlong;
  for (int k = 0; k < nlong; ++k) {
    const int run_lo = s_long[k];
    const int32_t r = s_rows[run_lo];
    const int run_hi = upper_bound(s_rows, len, r);
    for (int x = threadIdx.x; x < ncols; x += kThreads) s_acc[x] = 0;
    __syncthreads();
    for (int i = run_lo + threadIdx.x; i < run_hi; i += kThreads) {
      const int64_t j = base + i;
      if (valid != nullptr && valid[j] == 0) continue;
      const int32_t c = cols[j];
      if (c < 0 || c >= ncols) continue;
      atomicAdd(&s_acc[c], vals[j]);
    }
    __syncthreads();
    int32_t* dst = shard_row<int32_t>(sh, nrows, ncols, r);  // in a window
    for (int x = threadIdx.x; x < ncols; x += kThreads) {
      const int32_t a = s_acc[x];
      if (a != 0) atomicAdd(dst + x, a);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
coo_add_float_kernel(__grid_constant__ const Shards sh, int64_t nrows,
                     int64_t ncols, const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ vals,
                     const int32_t* __restrict__ valid, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t r = rows[i];
  if (i > 0 && rows[i - 1] == r) return;  // the run's first lane owns it
  float* dst = shard_row<float>(sh, nrows, ncols, r);
  if (dst == nullptr) return;  // foreign or out of range
  for (int64_t j = i; j < n && rows[j] == r; ++j) {
    if (valid != nullptr && valid[j] == 0) continue;
    const int32_t c = cols[j];
    if (c < 0 || c >= ncols) continue;
    dst[c] += vals[j];
  }
}

int coo_add(const Shards& sh, int64_t nrows, int64_t ncols, int64_t is_int,
            const int32_t* rows, const int32_t* cols, const void* vals,
            const int32_t* valid, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int) {
    const unsigned grid = (unsigned)((n + kChunk - 1) / kChunk);
    coo_add_int_kernel<<<grid, kThreads, 0, s>>>(
        sh, nrows, ncols, rows, cols, static_cast<const int32_t*>(vals),
        valid, n);
  } else {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    coo_add_float_kernel<<<grid, kThreads, 0, s>>>(
        sh, nrows, ncols, rows, cols, static_cast<const float*>(vals), valid,
        n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `is_int`: 0 for a float32 table and values, 1 for int32. Lanes whose
// row lies outside [0, nrows) add nothing. `valid` (nullable): per sorted
// lane; 0 gates the lane off.
int mv_coo_scatter_add(void* param, int64_t nrows, int64_t ncols,
                       int64_t is_int, const int32_t* rows,
                       const int32_t* cols, const void* vals,
                       const int32_t* valid, int64_t n, void* stream) {
  return coo_add(mv::one_shard(param), nrows, ncols, is_int, rows, cols,
                 vals, valid, n, stream);
}

// The same over the `count` shards of one card (at most mv::kMaxShards),
// each of `nrows` rows: bases[k] is shard k's row 0, firsts[k] its global
// id; rows are global. Host arrays, copied into the launch.
int mv_coo_scatter_add_mesh(void* const* bases, const int64_t* firsts,
                            int64_t count, int64_t nrows, int64_t ncols,
                            int64_t is_int, const int32_t* rows,
                            const int32_t* cols, const void* vals,
                            const int32_t* valid, int64_t n, void* stream) {
  Shards sh;
  if (!mv::make_shards(sh, bases, firsts, count))
    return (int)cudaErrorInvalidValue;
  return coo_add(sh, nrows, ncols, is_int, rows, cols, vals, valid, n,
                 stream);
}

}  // extern "C"
