// Row gather and sorted row scatter-add for float32 tables, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by ops/_build.py; every
// entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.
//
// Row gather (mv_row_gather) replaces the TPU kernel
// multiverso_tpu/ops/table_kernels.py build_row_gather / _gather_kernel:
// out[i] = param[ids[i]].
//
// Sorted row scatter-add (mv_row_scatter_add) replaces
// multiverso_tpu/ops/table_kernels.py build_row_scatter_add /
// _row_scatter_kernel and, with `valid` non-null,
// build_row_scatter_add_masked / _row_scatter_masked_kernel: for ids
// sorted ascending, every run of equal ids adds its (valid) deltas to its
// row, which is read once and written once; rows no id names are not
// touched (the table is updated in place, the counterpart of the TPU
// kernel's input_output_aliases).
//
// What bounds them: bytes moved. Both do one add per element at most, far
// below the card's float32 rate. A word2vec step (batch 4096, 5 negatives,
// dim 100) gathers B*(1+K) = 24,576 rows of 400 bytes from w_out and
// scatters as many back, so each call moves about 10 MB each way.
//
// What the design does about it: one warp per row, 16-byte float4 loads
// and stores when the row width is a multiple of 4 and the pointers are
// 16-byte aligned (a 100-wide row is 25 float4, one per lane), scalar
// loads otherwise; each warp reads its own ids (no scalar prefetch).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int W>
struct Vec;

template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static void add(T& a, const T& b) { a += b; }
};

template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};

// W floats per lane per access: 4 (float4) or 1 (scalar). `cols` is a
// multiple of W.
template <int W>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
row_gather_kernel(const float* __restrict__ param, int64_t rows, int64_t cols,
                  const int32_t* __restrict__ ids, int64_t n,
                  float* __restrict__ out) {
  using T = typename Vec<W>::T;
  const int lane = threadIdx.x % kWarp;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;
  const int64_t r = ids[i];
  const int64_t vcols = cols / W;
  T* dst = reinterpret_cast<T*>(out + i * cols);
  if (r < 0 || r >= rows) {  // out of range: a row of zeros
    for (int64_t c = lane; c < vcols; c += kWarp) dst[c] = Vec<W>::zero();
    return;
  }
  const T* src = reinterpret_cast<const T*>(param + r * cols);
  for (int64_t c = lane; c < vcols; c += kWarp) dst[c] = src[c];
}

template <int W>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
row_scatter_add_kernel(float* __restrict__ param, int64_t rows, int64_t cols,
                       const int32_t* __restrict__ ids,
                       const int64_t* __restrict__ order,
                       const float* __restrict__ deltas,
                       const int32_t* __restrict__ valid, int64_t n) {
  using T = typename Vec<W>::T;
  const int lane = threadIdx.x % kWarp;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;
  const int32_t r = ids[i];
  if (i > 0 && ids[i - 1] == r) return;  // the run's first lane owns the row
  if (r < 0 || r >= rows) return;         // out of range: dropped
  const int64_t vcols = cols / W;
  T* row = reinterpret_cast<T*>(param + (int64_t)r * cols);
  // one pass per 32*W columns (a single pass for rows up to 128 wide)
  for (int64_t c = lane; c - lane < vcols; c += kWarp) {
    const bool has_col = c < vcols;
    T acc = has_col ? row[c] : Vec<W>::zero();
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
        if (okk && has_col)
          Vec<W>::add(acc, reinterpret_cast<const T*>(deltas + s * cols)[c]);
      }
      if (len < kWarp) break;
    }
    if (has_col) row[c] = acc;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

int mv_row_gather(const float* param, int64_t rows, int64_t cols,
                  const int32_t* ids, int64_t n, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 grid(blocks_for(n)), block(kWarp * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols % 4 == 0 && aligned16(param) && aligned16(out))
    row_gather_kernel<4><<<grid, block, 0, s>>>(param, rows, cols, ids, n, out);
  else
    row_gather_kernel<1><<<grid, block, 0, s>>>(param, rows, cols, ids, n, out);
  return (int)cudaGetLastError();
}

// `order` (nullable): deltas row of sorted lane j is order[j], else j.
// `valid` (nullable): indexed like deltas rows; 0 gates the lane off.
int mv_row_scatter_add(float* param, int64_t rows, int64_t cols,
                       const int32_t* ids, const int64_t* order,
                       const float* deltas, const int32_t* valid, int64_t n,
                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 grid(blocks_for(n)), block(kWarp * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols % 4 == 0 && aligned16(param) && aligned16(deltas))
    row_scatter_add_kernel<4><<<grid, block, 0, s>>>(
        param, rows, cols, ids, order, deltas, valid, n);
  else
    row_scatter_add_kernel<1><<<grid, block, 0, s>>>(
        param, rows, cols, ids, order, deltas, valid, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
