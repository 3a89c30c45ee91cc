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
// What the design does about it: 16-byte loads and stores when the
// row's bytes are a multiple of 16 and the pointers are 16-byte aligned
// (a 100-wide float32 row is 25 of them, one per lane), narrower accesses
// otherwise; the gather is one warp per lane, and each warp reads its own
// ids (no scalar prefetch).
//
// The TPU scatter relied on its sequential grid to keep a row resident
// across consecutive equal ids. Hopper blocks run in parallel and in no
// order, so here lane i works only if it starts a run (i == 0 ||
// ids[i] != ids[i-1]); it finds where the run ends with a galloping search
// over the sorted ids. Each row receives row + d[first] + d[second] + ...,
// its valid deltas in sorted lane order (the TPU kernel's order, and the
// plain version's on the CPU), read once and written once; no two threads
// touch one row, so there are no atomics and the result is deterministic.
// That order is part of the function (it is what keeps sharded tables
// bit-identical to unsharded ones), so a run is never split into partial
// sums: what the design changes is how many loads are in flight while one
// thread per column adds in order.
//
// - A short run (at most kSplit lanes) is one warp's: it gathers its
//   lanes' delta rows into registers kShortLoads at a time, each batch's
//   loads issued before its adds, and adds them in lane order.
// - A long run (a frequent word: Zipf ids put thousands of lanes on the
//   top word) is appended to a list in the caller's workspace, and a
//   second kernel cuts it into 32-byte column slices, a block each. The
//   block stages its slice of the run's delta rows, gathered through
//   `order`, in a ring of shared-memory stages with cp.async (the delta
//   row indices come in the same way, a ring ahead), and the threads that
//   own the slice's columns add the staged rows in lane order from shared
//   memory and write their columns once.
//
// Why slices: one SM pulls scattered rows at a few tens of GB/s, so a
// block that stages whole 400-byte rows of one run is bound by its loads,
// while an add chain from shared memory takes a few cycles a lane; a
// 32-byte slice keeps each block near its chain, and a 100-wide float32
// run spreads over 13 SMs. The chain itself is serial (the order is the
// contract): at 4 cycles a float add, a run of L lanes takes at least
// 4 L cycles.
//
// The row window and the shards (shards.cuh). A lane's row is found among
// the launch's shards: a flat table is one shard whose first row has the
// global id 0, and a lane outside every window is foreign. A table split
// into shards of `rows` rows launches once per card over the GLOBAL lanes
// with every shard that card holds (mv_row_scatter_add_mesh); this
// replaces the in-trace sharded forms of multiverso_tpu/ops/table_kernels.py
// (_sharded_gather_rows, _sharded_row_scatter_add), which mask foreign
// lanes inside a shard_map.
// The reference parks a foreign lane on the shard's last row under a
// write gate. Here that would make a second run of that row (a second
// owner that rewrites it unchanged while the real run's owner adds to
// it: a lost update) and a serial walk over every lane below the shard.
// Here a foreign lane exits at the run-owner and window checks, and
// sorted global ids keep every run inside one shard, so each shard's rows
// come out bit for bit the flat kernel's. The gather takes one window
// (`lo`) a launch; it writes a foreign lane's out row as zeros when
// `zero_foreign` is set (the flat form, and the first shard of a sharded
// gather into one output), and leaves it untouched otherwise (the other
// shards' lanes of that output).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shards.cuh"

namespace {

using mv::Shards;
using mv::shard_row;

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
// A run of more than kSplit lanes gets blocks of its own; a shorter one is
// one warp's (table_kernels.SCATTER_SPLIT holds the same number, to size
// the workspace); ops/scatter_sweep.py times it against 64-256 (PERF.md).
constexpr int64_t kSplit = 32;
// The workspace: [0] the count of long runs, [1] the long-run kernel's
// finished blocks (its last block sets both back to 0, so the workspace is
// zero between calls), then a (first lane, length) pair for each long run.
constexpr int64_t kListHead = 2;
// A long run is cut into column slices of kSliceBytes, one block each (a
// work item): one SM pulls a few tens of GB/s of scattered rows, so a run
// staged by one block is bound by its loads; a 32-byte slice keeps one
// block near its serial add chain. Each block: kLongThreads threads, a
// ring of kStages stages of kStageRows rows of its slice, the rows' flags
// (int32) and, two rings deep, their delta rows (the low 32 bits of
// order[], which holds ids below 2^31). These sizes, the add batch and the
// short-run load depth are the fastest of ops/scatter_sweep.py's variants
// at chip_smoke.py phase 2's cases, or within the spread of one (PERF.md).
constexpr int kLongThreads = 128;
constexpr int kSliceBytes = 32;
constexpr int kStages = 2;
constexpr int kStageRows = 512;
constexpr int kLongSmem = kStages * kStageRows * (kSliceBytes + 4 + 2 * 4);
// within the 48 KB a block gets without opting in
static_assert(kLongSmem <= 48 * 1024, "the long-run ring outgrew 48 KB");
// long-run blocks resident on one SM (kLongSmem each)
constexpr int kLongBlocksPerSM = 4;
// rows a column owner loads before it adds them
constexpr int kBatch = 16;
// the short-run kernel: warps a block, and the delta rows a warp loads
// before it adds them (registers bound how many warps stay resident)
constexpr int kShortWarps = 2;
constexpr int kShortLoads = 8;

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

// The first lane after the run of id r that starts at i (sorted ids), by
// the whole warp: 32 probes at a stride that grows 32-fold while every
// probe still holds r, then 32 probes at strides 32-fold smaller. Sorted
// ids make the probes that hold r a prefix of the lanes.
__device__ __forceinline__ int64_t run_end(const int32_t* __restrict__ ids,
                                           int64_t n, int64_t i, int32_t r,
                                           int lane) {
  int64_t lo = i, stride = 1;  // ids[lo] == r
  for (;;) {
    const int64_t p = lo + stride * (lane + 1);
    const unsigned m = __ballot_sync(kFull, p < n && ids[p] == r);
    if (m != kFull) {
      lo += stride * __popc(m);
      break;
    }
    lo += stride * kWarp;
    stride *= kWarp;
  }
  while (stride > 1) {  // ids[lo] == r; lo + stride is past the run
    stride /= kWarp;
    const int64_t p = lo + stride * (lane + 1);
    lo += stride * __popc(__ballot_sync(kFull, p < n && ids[p] == r));
  }
  return lo + 1;
}

// E is the element type, V the access type (E or a 16-byte vector of E);
// `vcols` counts V units per row. One warp per lane; the owner of a run of
// at most kSplit lanes adds it, a longer run goes to the list in `ws`.
template <typename E, typename V>
__global__ void __launch_bounds__(kWarp * kShortWarps)
scatter_short_kernel(__grid_constant__ const Shards sh, int64_t rows,
                     int64_t vcols,
                     const int32_t* __restrict__ ids,
                     const int64_t* __restrict__ order,
                     const E* __restrict__ deltas,
                     const int32_t* __restrict__ valid, int64_t n,
                     unsigned long long* __restrict__ ws) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i = (int64_t)blockIdx.x * kShortWarps + threadIdx.x / kWarp;
  if (i >= n) return;
  const int32_t r = ids[i];
  if (i > 0 && ids[i - 1] == r) return;  // the run's first lane owns the row
  V* row = shard_row<V>(sh, rows, vcols, r);
  if (row == nullptr) return;  // foreign or out of range
  const int64_t end = run_end(ids, n, i, r, lane);
  if (end - i > kSplit) {
    if (lane == 0) {
      const unsigned long long k = atomicAdd(ws, 1ull);
      ws[kListHead + 2 * k] = (unsigned long long)i;
      ws[kListHead + 2 * k + 1] = (unsigned long long)(end - i);
    }
    return;
  }
  const V* dv = reinterpret_cast<const V*>(deltas);
  // one pass per 32 V units of the row
  for (int64_t c = lane; c - lane < vcols; c += kWarp) {
    const bool has_col = c < vcols;
    V acc = has_col ? row[c] : V{};
    for (int64_t j0 = i; j0 < end; j0 += kWarp) {
      const int64_t j = j0 + lane;
      const int m = end - j0 < kWarp ? (int)(end - j0) : kWarp;
      int64_t src = 0;
      bool ok = false;
      if (j < end) {
        src = order != nullptr ? order[j] : j;
        ok = valid == nullptr || valid[src] != 0;
      }
      const unsigned okm = __ballot_sync(kFull, ok);
      // kShortLoads loads of the chunk before their adds
      for (int k0 = 0; k0 < m; k0 += kShortLoads) {
        V buf[kShortLoads];
#pragma unroll
        for (int k = 0; k < kShortLoads; ++k) {
          if (k0 + k >= m) break;
          const int64_t s = __shfl_sync(kFull, src, k0 + k);
          if (has_col && ((okm >> (k0 + k)) & 1u)) buf[k] = dv[s * vcols + c];
        }
#pragma unroll
        for (int k = 0; k < kShortLoads; ++k) {
          if (k0 + k >= m) break;
          if (has_col && ((okm >> (k0 + k)) & 1u)) vadd(acc, buf[k]);
        }
      }
    }
    if (has_col) row[c] = acc;
  }
}

// cp.async of one V unit from device memory into shared memory
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The work items of the long runs in `ws`: (run, column slice), taken by
// the blocks in turn. Per item: stage t's rows of the slice are added in
// lane order by the slice's column owners, one element each (threads
// 0..7 of the first warp: one add chain a thread), while the other warps
// copy stage t + kStages - 1 in with cp.async, in V units, and with it the
// delta rows of stage t + 2 kStages - 1, so no load of the loop waits on
// another. Masked lanes' rows are copied too; their flags (valid[],
// copied beside them) keep them out of the sum. The last block to finish
// zeroes the workspace's head for the next call on the stream.
template <typename E, typename V>
__global__ void __launch_bounds__(kLongThreads)
scatter_long_kernel(__grid_constant__ const Shards sh, int64_t rows,
                    int64_t vcols,
                    const int32_t* __restrict__ ids,
                    const int64_t* __restrict__ order,
                    const E* __restrict__ deltas,
                    const int32_t* __restrict__ valid,
                    unsigned long long* __restrict__ ws) {
  constexpr int kUnits = kSliceBytes / (int)sizeof(V);  // V units a slice
  constexpr int kLanes = kSliceBytes / (int)sizeof(E);  // its elements
  constexpr int kSrcSlots = 2 * kStages;
  const int64_t slices = (vcols + kUnits - 1) / kUnits;
  const int64_t items = (int64_t)ws[0] * slices;
  const V* dv = reinterpret_cast<const V*>(deltas);
  extern __shared__ __align__(16) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);
  int* ring_ok = reinterpret_cast<int*>(
      smem + kStages * kStageRows * kSliceBytes);
  int* ring_src = ring_ok + kStages * kStageRows;
  const int tid = threadIdx.x;
  const int ptid = tid - kWarp;  // producers: the warps after the first
  constexpr int kProducers = kLongThreads - kWarp;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t run = item / slices, c0 = (item % slices) * kUnits;
    const int64_t start = (int64_t)ws[kListHead + 2 * run];
    const int64_t len = (int64_t)ws[kListHead + 2 * run + 1];
    const int w = vcols - c0 < kUnits ? (int)(vcols - c0) : kUnits;
    const int owners = w * (int)(sizeof(V) / sizeof(E));
    E* row = reinterpret_cast<E*>(shard_row<V>(sh, rows, vcols, ids[start])
                                  + c0);  // listed: in a shard
    const int64_t stages = (len + kStageRows - 1) / kStageRows;
    auto rows_in = [&](int64_t t) {
      return len - t * kStageRows < kStageRows ? (int)(len - t * kStageRows)
                                               : kStageRows;
    };
    // the delta rows of stage t into their slot (async, or stored when
    // there is no permutation)
    auto fetch_src = [&](int64_t t, int from, int step) {
      if (t >= stages) return;
      int* dst = ring_src + (int)(t % kSrcSlots) * kStageRows;
      const int64_t j0 = start + t * kStageRows;
      for (int r = from; r < rows_in(t); r += step) {
        if (order != nullptr)
          copy_async(dst + r, order + j0 + r, 4);  // the low word
        else
          dst[r] = (int)(j0 + r);
      }
    };
    auto issue = [&](int64_t t) {
      if (ptid >= 0 && t < stages) {
        const int slot = (int)(t % kStages);
        const int rn = rows_in(t);
        V* dst = ring + slot * kStageRows * kUnits;
        const int* src = ring_src + (int)(t % kSrcSlots) * kStageRows;
        for (int x = ptid; x < rn * w; x += kProducers) {
          const int r = x / w, u = x - r * w;
          const int64_t d = src[r];
          copy_async(dst + r * kUnits + u, dv + d * vcols + c0 + u,
                     (int)sizeof(V));
          if (valid != nullptr && u == 0)
            copy_async(ring_ok + slot * kStageRows + r, valid + d, 4);
        }
      }
      if (ptid >= 0) fetch_src(t + kStages, ptid, kProducers);
      commit_copies();  // an empty group too: the count stays uniform
    };
    for (int t = 0; t < kStages; ++t) fetch_src(t, tid, kLongThreads);
    commit_copies();
    wait_copies<0>();
    __syncthreads();
    for (int t = 0; t < kStages - 1; ++t) issue(t);
    E acc = tid < owners ? row[tid] : E{};
    for (int64_t t = 0; t < stages; ++t) {
      wait_copies<kStages - 2>();  // stage t and its successors' rows
      __syncthreads();
      if (tid < owners) {
        const int slot = (int)(t % kStages);
        const int rn = rows_in(t);
        const E* src = reinterpret_cast<const E*>(ring) +
                       slot * kStageRows * kLanes + tid;
        const int* ok = ring_ok + slot * kStageRows;
        int r = 0;
        // kBatch loads in flight, then their adds in lane order
        for (; r + kBatch <= rn; r += kBatch) {
          E d[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) d[k] = src[(r + k) * kLanes];
          if (valid == nullptr) {
#pragma unroll
            for (int k = 0; k < kBatch; ++k) acc += d[k];
          } else {
#pragma unroll
            for (int k = 0; k < kBatch; ++k)
              if (ok[r + k]) acc += d[k];
          }
        }
        for (; r < rn; ++r)
          if (valid == nullptr || ok[r]) acc += src[r * kLanes];
      }
      // into the slot every thread finished with at round t - 1
      issue(t + kStages - 1);
    }
    if (tid < owners) row[tid] = acc;
    wait_copies<0>();
    __syncthreads();  // the rings are free for the next item
  }
  __syncthreads();  // every thread of the block has read ws[0]
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(ws + 1, 1ull) == gridDim.x - 1) {  // the last block
      ws[0] = 0;
      ws[1] = 0;
    }
  }
}

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

inline unsigned blocks_for(int64_t n, int warps = kWarpsPerBlock) {
  return (unsigned)((n + warps - 1) / warps);
}

// The current device's SM count, read once per device.
cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int cached[kDevices];  // 0 until read
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) cached[dev] = *sms;
  return err;
}

template <typename E, typename V>
int launch_scatter_as(const Shards& sh, int64_t rows, int64_t vcols,
                      const int32_t* ids, const int64_t* order,
                      const E* deltas, const int32_t* valid, int64_t n,
                      unsigned long long* ws, cudaStream_t s) {
  scatter_short_kernel<E, V><<<blocks_for(n, kShortWarps),
                               kWarp * kShortWarps, 0, s>>>(
      sh, rows, vcols, ids, order, deltas, valid, n, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // one block per work item, at most as many as stay resident: a block
  // takes items in turn (blocks past the items exit)
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  constexpr int kUnits = kSliceBytes / (int)sizeof(V);
  const int64_t items = (n / kSplit + 1) * ((vcols + kUnits - 1) / kUnits);
  const int64_t resident = (int64_t)sms * kLongBlocksPerSM;
  scatter_long_kernel<E, V><<<(unsigned)(items < resident ? items : resident),
                              kLongThreads, kLongSmem, s>>>(
      sh, rows, vcols, ids, order, deltas, valid, ws);
  return (int)cudaGetLastError();
}

template <typename E, typename V4>
int launch_scatter(const Shards& sh, int64_t rows, int64_t cols,
                   const int32_t* ids, const int64_t* order, const void* d,
                   const int32_t* valid, int64_t n, void* ws,
                   cudaStream_t s) {
  const E* deltas = static_cast<const E*>(d);
  auto* list = static_cast<unsigned long long*>(ws);
  bool vec = cols % 4 == 0 && aligned(deltas, 16);
  for (int k = 0; k < sh.count; ++k) vec = vec && aligned(sh.base[k], 16);
  if (vec)
    return launch_scatter_as<E, V4>(sh, rows, cols / 4, ids, order, deltas,
                                    valid, n, list, s);
  return launch_scatter_as<E, E>(sh, rows, cols, ids, order, deltas, valid,
                                 n, list, s);
}

int scatter(const Shards& sh, int64_t rows, int64_t cols, int64_t is_int,
            const int32_t* ids, const int64_t* order, const void* deltas,
            const int32_t* valid, int64_t n, void* ws, int64_t ws_words,
            void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (ws == nullptr || ws_words < kListHead + 2 * (n / kSplit + 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int)
    return launch_scatter<int32_t, int4>(sh, rows, cols, ids, order, deltas,
                                         valid, n, ws, s);
  return launch_scatter<float, float4>(sh, rows, cols, ids, order, deltas,
                                       valid, n, ws, s);
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

// `is_int`: 0 for float32 tables and deltas, 1 for int32. Ids outside
// [0, rows) add nothing. `order` (nullable): deltas row of sorted lane j
// is order[j], else j. `valid` (nullable): indexed like deltas rows; 0
// gates the lane off. `workspace`: `ws_words` int64 on the card, zero before the first
// call and left zero by each call on the stream; at least
// 2 + 2 * (n / kSplit + 1) (the long-run list), or the call fails.
int mv_row_scatter_add(void* param, int64_t rows, int64_t cols,
                       int64_t is_int, const int32_t* ids,
                       const int64_t* order, const void* deltas,
                       const int32_t* valid, int64_t n, void* workspace,
                       int64_t ws_words, void* stream) {
  return scatter(mv::one_shard(param), rows, cols, is_int, ids, order,
                 deltas, valid, n, workspace, ws_words, stream);
}

// The same over the `count` shards of one card (at most mv::kMaxShards),
// each of `rows` rows: bases[k] is shard k's row 0, firsts[k] its global
// id; ids are global. Host arrays, copied into the launch.
int mv_row_scatter_add_mesh(void* const* bases, const int64_t* firsts,
                            int64_t count, int64_t rows, int64_t cols,
                            int64_t is_int, const int32_t* ids,
                            const int64_t* order, const void* deltas,
                            const int32_t* valid, int64_t n, void* workspace,
                            int64_t ws_words, void* stream) {
  Shards sh;
  if (!mv::make_shards(sh, bases, firsts, count))
    return (int)cudaErrorInvalidValue;
  return scatter(sh, rows, cols, is_int, ids, order, deltas, valid, n,
                 workspace, ws_words, stream);
}

}  // extern "C"
