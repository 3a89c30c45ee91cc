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
// The mesh gather (mv_row_gather_mesh) serves every shard one card holds
// in one launch. It replaces build_row_gather_sharded (:962; a gather per
// shard under shard_map, then jnp.take through `inv`) and the in-trace
// _sharded_gather_rows (:1220; masked partial rows per shard, psum'd), in
// both of which each shard is a kernel of its own. It has two lane forms:
// global ids (the in-trace form: a lane finds its shard by the row
// windows), and the host-sliced form (caller lane j reads k = inv[j], the
// flat index s * L + pos of the (S, L) lane slices, then shard s's LOCAL
// id ids_s[pos]), which writes each caller lane's row where it belongs,
// so no (S, L, C) buffer and no unpermute remain. What bounds it: bytes,
// plus a chain of dependent loads before the first row byte moves (inv,
// then ids, then the row, with the shard lookup in between). What the
// design does about it: a warp takes kGatherLanes lanes; each of its
// threads resolves one lane's indices, so the warp's index loads are in
// flight together, and the warp then copies its lanes' rows as one flat
// run of 16-byte units (the out rows of consecutive lanes are
// contiguous), kGatherLoads loads a thread issued through the read-only
// path before their stores, the row base of each unit taken from the
// thread that resolved it by __shfl_sync. Few lanes a warp beat many:
// 24,576 lanes at 32 a warp fill fewer blocks than the card has SMs.
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
// The shards (shards.cuh). A lane's row is found among the launch's
// shards: a flat table is one shard whose first row has the global id 0,
// and a lane outside every window is foreign. A table split into shards of
// `rows` rows launches once per card with every shard that card holds:
// the gather as above, the scatter over the GLOBAL lanes
// (mv_row_scatter_add_mesh, for the in-trace _sharded_row_scatter_add,
// :1248, which masks foreign lanes inside a shard_map) or over each
// shard's own real lanes (mv_row_scatter_add_shards, for
// build_row_scatter_add_sharded, :1039, a masked scatter per shard).
// The reference parks a foreign lane on the shard's last row under a
// write gate. Here that would make a second run of that row (a second
// owner that rewrites it unchanged while the real run's owner adds to
// it: a lost update) and a serial walk over every lane below the shard.
// Here a foreign lane exits at the run-owner and window checks, and
// sorted global ids keep every run inside one shard, so each shard's rows
// come out bit for bit the flat kernel's.
//
// The scatter's lanes (GlobalLanes, ShardLanes) come in segments. The
// flat and mesh forms have one segment of global ids, read through
// `order`. The host-sliced form has a segment a shard: that shard's real
// lanes in its own arrays, LOCAL ids, the pads after them never launched
// (with Zipf ids the shards' pads are runs of thousands of one id: walked,
// they would be the serial chain of the KV probe's padding fault). A run
// never crosses a segment, so two shards' equal local ids stay two runs.
// The gather writes a foreign lane's out row as zeros when `zero_foreign`
// is set (the first launch into an output) and leaves it untouched
// otherwise (a card's second group of shards).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shards.cuh"

namespace {

using mv::Shards;
using mv::aligned;
using mv::shard_row;
using mv::sm_count;

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
// the mesh gather: warps a block, lanes a warp (at most kWarp: a thread
// resolves one lane) and units each thread loads before it stores them;
// the fastest of ops/gather_sweep.py's variants at chip_smoke.py phase 2's
// shapes (PERF.md), where streaming stores gained nothing
constexpr int kGatherWarps = 8;
constexpr int kGatherLanes = 4;
constexpr int kGatherLoads = 4;
static_assert(kGatherLanes <= kWarp, "a thread resolves one lane");

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

// Copies `words` units of type V per row (the row's bytes / sizeof(V));
// an id outside [0, rows) gets a row of zeros.
template <typename V>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
row_gather_kernel(const V* __restrict__ param, int64_t rows, int64_t words,
                  const int32_t* __restrict__ ids, int64_t n,
                  V* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;
  const int64_t r = ids[i];
  V* dst = out + i * words;
  if (r < 0 || r >= rows) {
    for (int64_t c = lane; c < words; c += kWarp) dst[c] = V{};
    return;
  }
  const V* src = param + r * words;
  for (int64_t c = lane; c < words; c += kWarp) dst[c] = src[c];
}

// Where the mesh gather's lanes find their rows. `inv` null: ids[0][j] is
// lane j's GLOBAL id. Otherwise lane j reads k = inv[j], the flat index
// s * L + pos of the host-sliced (S, L) lanes, and the LOCAL id
// ids[m][pos] of the launch's shard m whose first global row is s * rows
// (ids[m] is that shard's row of the slices).
struct GatherLanes {
  const int32_t* ids[mv::kMaxShards];
  const int32_t* inv;
  int64_t L;
};

// Lane j's row, or nullptr when no shard of the launch holds it.
template <typename V>
__device__ __forceinline__ const V* gather_src(const Shards& sh,
                                               const GatherLanes& gl,
                                               int64_t rows, int64_t words,
                                               int64_t j) {
  if (gl.inv == nullptr)
    return shard_row<const V>(sh, rows, words, __ldg(gl.ids[0] + j));
  const unsigned k = __ldg(gl.inv + j);  // below 2^31: 32-bit division
  const int64_t s = k / (unsigned)gl.L;
  const int32_t* ids = nullptr;
  const V* base = nullptr;
#pragma unroll
  for (int m = 0; m < mv::kMaxShards; ++m) {
    if (m >= sh.count) break;
    if (sh.first[m] == s * rows) {
      ids = gl.ids[m];
      base = static_cast<const V*>(sh.base[m]);
    }
  }
  if (ids == nullptr) return nullptr;
  const int64_t local = __ldg(ids + (k - s * gl.L));
  return local >= 0 && local < rows ? base + local * words : nullptr;
}

// A warp per kGatherLanes lanes: thread t resolves lane j0 + t, then the
// warp copies its lanes' rows, which are contiguous in `out`, as one run
// of `m * words` units; unit x is column x % words of the warp's lane
// x / words, whose row base comes from that lane's thread. `words` (V
// units a row) is below 2^31 / kGatherLanes, so the warp's unit indices
// take 32-bit arithmetic.
template <typename V>
__global__ void __launch_bounds__(kWarp * kGatherWarps)
row_gather_mesh_kernel(__grid_constant__ const Shards sh,
                       __grid_constant__ const GatherLanes gl, int64_t rows,
                       int words, int zero_foreign, int64_t n,
                       V* __restrict__ out) {
  const int t = threadIdx.x % kWarp;
  const int64_t j0 =
      ((int64_t)blockIdx.x * kGatherWarps + threadIdx.x / kWarp) *
      kGatherLanes;
  if (j0 >= n) return;  // the whole warp
  const int m = n - j0 < kGatherLanes ? (int)(n - j0) : kGatherLanes;
  const V* src = t < m ? gather_src<V>(sh, gl, rows, words, j0 + t)
                       : nullptr;
  const unsigned long long mine = reinterpret_cast<unsigned long long>(src);
  V* dst = out + j0 * words;
  const int units = m * words;
  // unit x = x0 + k * kWarp + t is column u of lane q; both advance by
  // kWarp units a step
  int q = t / words, u = t % words;
  const int dq = kWarp / words, du = kWarp % words;
  for (int x0 = 0; x0 < units; x0 += kWarp * kGatherLoads) {
    V buf[kGatherLoads];
    unsigned in_range = 0, found = 0;
#pragma unroll
    for (int k = 0; k < kGatherLoads; ++k) {
      const V* row = reinterpret_cast<const V*>(
          __shfl_sync(kFull, mine, q < m ? q : 0));
      if (x0 + k * kWarp + t < units) {
        in_range |= 1u << k;
        if (row != nullptr) {
          found |= 1u << k;
          buf[k] = __ldg(row + u);
        }
      }
      u += du;
      q += dq;
      if (u >= words) {
        u -= words;
        ++q;
      }
    }
#pragma unroll
    for (int k = 0; k < kGatherLoads; ++k) {
      V* p = dst + x0 + k * kWarp + t;
      if ((found >> k) & 1u)
        *p = buf[k];
      else if (((in_range >> k) & 1u) && zero_foreign)
        *p = V{};
    }
  }
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

// One segment of a scatter launch's lanes: its arrays, its first launch
// lane and its length, and its ids' global offset (-1: the ids are
// global).
struct Segment {
  const int32_t* ids;
  const void* deltas;
  const int32_t* valid;
  int64_t start, n, first;
};

// The lanes of a launch of GLOBAL ids (the flat and mesh forms): one
// segment over every shard of the launch, its deltas rows read through
// `order` (nullable), `valid` nullable (`masked` says which).
struct GlobalLanes {
  const int32_t* ids;
  const int64_t* order;
  const void* deltas;
  const int32_t* valid;
  int64_t n;
  int masked;
  __device__ __forceinline__ Segment segment(const Shards&, int64_t) const {
    return Segment{ids, deltas, valid, 0, n, -1};
  }
  int64_t lanes() const { return n; }
  bool deltas_aligned(unsigned bytes) const;
};

// The lanes of a launch of the host-sliced form: segment k is shard k's
// real lanes [start[k], start[k + 1]) of the launch, in their own arrays
// ids[k] (LOCAL ids), deltas[k] (a row a lane) and valid[k] (every one
// null, or none: `masked` says which); no permutation. Its own type, so
// that the flat and mesh launches do not carry these arrays (about 500
// bytes of parameters cost 0.85 us a call).
struct ShardLanes {
  static constexpr const int64_t* order = nullptr;
  const int32_t* ids[mv::kMaxShards];
  const void* deltas[mv::kMaxShards];
  const int32_t* valid[mv::kMaxShards];
  int64_t start[mv::kMaxShards + 1];
  int count;
  int masked;
  // the segment that holds launch lane g (mv::find_segment)
  __device__ __forceinline__ Segment segment(const Shards& sh,
                                             int64_t g) const {
    Segment s;
    mv::find_segment(start, count, g, [&](int k) {
      s = Segment{ids[k], deltas[k], valid[k], start[k],
                  start[k + 1] - start[k], sh.first[k]};
    });
    return s;
  }
  int64_t lanes() const { return start[count]; }
  bool deltas_aligned(unsigned bytes) const;
};

// The global id of a segment's id r: a local id outside [0, rows) maps to
// -1, which no shard holds.
__device__ __forceinline__ int64_t global_id(const Segment& s, int32_t r,
                                             int64_t rows) {
  if (s.first < 0) return r;
  return r >= 0 && r < rows ? s.first + r : -1;
}

// E is the element type, V the access type (E or a 16-byte vector of E);
// `vcols` counts V units per row. One warp per lane; the owner of a run of
// at most kSplit lanes adds it, a longer run goes to the list in `ws`
// (by its first launch lane). A run ends at its segment's end.
template <typename E, typename V, typename L>
__global__ void __launch_bounds__(kWarp * kShortWarps)
scatter_short_kernel(__grid_constant__ const Shards sh,
                     __grid_constant__ const L ln, int64_t rows,
                     int64_t vcols, int64_t n,
                     unsigned long long* __restrict__ ws) {
  const int lane = threadIdx.x % kWarp;
  const int64_t g = (int64_t)blockIdx.x * kShortWarps + threadIdx.x / kWarp;
  if (g >= n) return;
  const Segment seg = ln.segment(sh, g);
  const int32_t* __restrict__ ids = seg.ids;
  const int32_t* __restrict__ valid = seg.valid;
  const int64_t i = g - seg.start;
  const int32_t r = ids[i];
  if (i > 0 && ids[i - 1] == r) return;  // the run's first lane owns the row
  V* row = shard_row<V>(sh, rows, vcols, global_id(seg, r, rows));
  if (row == nullptr) return;  // foreign or out of range
  const int64_t end = run_end(ids, seg.n, i, r, lane);
  if (end - i > kSplit) {
    if (lane == 0) {
      const unsigned long long k = atomicAdd(ws, 1ull);
      ws[kListHead + 2 * k] = (unsigned long long)g;
      ws[kListHead + 2 * k + 1] = (unsigned long long)(end - i);
    }
    return;
  }
  const V* dv = static_cast<const V*>(seg.deltas);
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
        src = ln.order != nullptr ? ln.order[j] : j;
        ok = !ln.masked || valid[src] != 0;
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

// acc + the rn staged rows of one column (`lanes` elements apart) whose
// flags are set (all of them unless kMasked), in lane order: kBatch loads
// in flight, then their adds. The mask is a template argument so that the
// loop holds no branch and the compiler can issue the next batch's loads
// under this one's adds (with the branch inside, the one-id chain took
// 1.8x as long).
template <bool kMasked, int lanes, typename E>
__device__ __forceinline__ E add_staged(E acc, const E* src, const int* ok,
                                        int rn) {
  int r = 0;
  for (; r + kBatch <= rn; r += kBatch) {
    E d[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) d[k] = src[(r + k) * lanes];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (!kMasked || ok[r + k]) acc += d[k];
  }
  for (; r < rn; ++r)
    if (!kMasked || ok[r]) acc += src[r * lanes];
  return acc;
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
template <typename E, typename V, typename L>
__global__ void __launch_bounds__(kLongThreads)
scatter_long_kernel(__grid_constant__ const Shards sh,
                    __grid_constant__ const L ln, int64_t rows,
                    int64_t vcols, unsigned long long* __restrict__ ws) {
  constexpr int kUnits = kSliceBytes / (int)sizeof(V);  // V units a slice
  constexpr int kLanes = kSliceBytes / (int)sizeof(E);  // its elements
  constexpr int kSrcSlots = 2 * kStages;
  const int64_t slices = (vcols + kUnits - 1) / kUnits;
  const int64_t items = (int64_t)ws[0] * slices;
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
    const int64_t g = (int64_t)ws[kListHead + 2 * run];
    const int64_t len = (int64_t)ws[kListHead + 2 * run + 1];
    const Segment seg = ln.segment(sh, g);
    const int64_t start = g - seg.start;  // in the segment
    const int32_t* __restrict__ valid = seg.valid;
    const V* dv = static_cast<const V*>(seg.deltas);
    const int w = vcols - c0 < kUnits ? (int)(vcols - c0) : kUnits;
    const int owners = w * (int)(sizeof(V) / sizeof(E));
    E* row = reinterpret_cast<E*>(
        shard_row<V>(sh, rows, vcols,
                     global_id(seg, seg.ids[start], rows)) +
        c0);  // listed: in a shard
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
        if (ln.order != nullptr)
          copy_async(dst + r, ln.order + j0 + r, 4);  // the low word
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
          if (ln.masked && u == 0)
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
        acc = ln.masked ? add_staged<true, kLanes>(acc, src, ok, rn)
                        : add_staged<false, kLanes>(acc, src, ok, rn);
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

inline unsigned blocks_for(int64_t n, int warps = kWarpsPerBlock) {
  return (unsigned)((n + warps - 1) / warps);
}

bool GlobalLanes::deltas_aligned(unsigned bytes) const {
  return aligned(deltas, bytes);
}

bool ShardLanes::deltas_aligned(unsigned bytes) const {
  bool ok = true;
  for (int k = 0; k < count; ++k) ok = ok && aligned(deltas[k], bytes);
  return ok;
}

template <typename E, typename V, typename L>
int launch_scatter_as(const Shards& sh, const L& ln, int64_t rows,
                      int64_t vcols, int64_t n, unsigned long long* ws,
                      cudaStream_t s) {
  scatter_short_kernel<E, V, L><<<blocks_for(n, kShortWarps),
                                  kWarp * kShortWarps, 0, s>>>(
      sh, ln, rows, vcols, n, ws);
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
  scatter_long_kernel<E, V, L>
      <<<(unsigned)(items < resident ? items : resident), kLongThreads,
         kLongSmem, s>>>(sh, ln, rows, vcols, ws);
  return (int)cudaGetLastError();
}

template <typename E, typename V4, typename L>
int launch_scatter(const Shards& sh, const L& ln, int64_t rows, int64_t cols,
                   int64_t n, void* ws, cudaStream_t s) {
  auto* list = static_cast<unsigned long long*>(ws);
  bool vec = cols % 4 == 0 && ln.deltas_aligned(16);
  for (int k = 0; k < sh.count; ++k) vec = vec && aligned(sh.base[k], 16);
  if (vec)
    return launch_scatter_as<E, V4>(sh, ln, rows, cols / 4, n, list, s);
  return launch_scatter_as<E, E>(sh, ln, rows, cols, n, list, s);
}

template <typename L>
int scatter(const Shards& sh, const L& ln, int64_t rows, int64_t cols,
            int64_t is_int, void* ws, int64_t ws_words, void* stream) {
  const int64_t n = ln.lanes();
  if (n <= 0) return (int)cudaSuccess;
  if (ws == nullptr || ws_words < kListHead + 2 * (n / kSplit + 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int)
    return launch_scatter<int32_t, int4>(sh, ln, rows, cols, n, ws, s);
  return launch_scatter<float, float4>(sh, ln, rows, cols, n, ws, s);
}

GlobalLanes global_lanes(const int32_t* ids, const int64_t* order,
                         const void* deltas, const int32_t* valid,
                         int64_t n) {
  return GlobalLanes{ids, order, deltas, valid, n, valid != nullptr};
}

// The gather's access type: 16-byte units when the row's bytes and every
// pointer allow them, else 4-byte, else 2-byte.
template <typename V>
int launch_gather_as(const Shards& sh, const GatherLanes& gl, int64_t rows,
                     int64_t bytes, int64_t zero_foreign, int64_t n,
                     void* out, cudaStream_t s) {
  const int64_t warps = (n + kGatherLanes - 1) / kGatherLanes;
  row_gather_mesh_kernel<V><<<blocks_for(warps, kGatherWarps),
                              kWarp * kGatherWarps, 0, s>>>(
      sh, gl, rows, (int)(bytes / (int64_t)sizeof(V)), zero_foreign != 0,
      n, static_cast<V*>(out));
  return (int)cudaGetLastError();
}

bool all_aligned(const Shards& sh, const void* out, int64_t bytes,
                 unsigned unit) {
  bool ok = bytes % unit == 0 && aligned(out, unit);
  for (int k = 0; k < sh.count; ++k) ok = ok && aligned(sh.base[k], unit);
  return ok;
}

}  // namespace

extern "C" {

// `elem_bytes` is 2 or 4: the row is cols * elem_bytes bytes. An id
// outside [0, rows) gets a row of zeros.
int mv_row_gather(const void* param, int64_t rows, int64_t cols,
                  int64_t elem_bytes, const int32_t* ids, int64_t n,
                  void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(n)), block(kWarp * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bytes = cols * elem_bytes;
  if (bytes % 16 == 0 && aligned(param, 16) && aligned(out, 16))
    row_gather_kernel<uint4><<<grid, block, 0, s>>>(
        static_cast<const uint4*>(param), rows, bytes / 16, ids, n,
        static_cast<uint4*>(out));
  else if (bytes % 4 == 0 && aligned(param, 4) && aligned(out, 4))
    row_gather_kernel<uint32_t><<<grid, block, 0, s>>>(
        static_cast<const uint32_t*>(param), rows, bytes / 4, ids, n,
        static_cast<uint32_t*>(out));
  else
    row_gather_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(param), rows, bytes / 2, ids, n,
        static_cast<uint16_t*>(out));
  return (int)cudaGetLastError();
}

// The gather over the `count` shards of one card (at most mv::kMaxShards),
// each of `rows` rows of cols * elem_bytes bytes (elem_bytes 2 or 4):
// bases[k] is shard k's row 0, firsts[k] its global id; host arrays,
// copied into the launch. `inv` null: ids[0] holds the n lanes' GLOBAL
// ids. Otherwise lane j's row is row ids[m][pos] of the shard m whose
// first row is s * rows, for inv[j] = s * L + pos (ids[m]: that shard's
// row of the (S, L) LOCAL ids). A lane no shard of the launch holds gets
// a row of zeros when zero_foreign is 1, and keeps its out row when 0.
int mv_row_gather_mesh(void* const* bases, const int64_t* firsts,
                       int64_t count, int64_t rows, int64_t cols,
                       int64_t elem_bytes, const int32_t* const* ids,
                       const int32_t* inv, int64_t L, int64_t zero_foreign,
                       int64_t n, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Shards sh;
  if (!mv::make_shards(sh, bases, firsts, count) ||
      (elem_bytes != 2 && elem_bytes != 4) || (inv != nullptr && L <= 0) ||
      cols * elem_bytes / 2 > INT32_MAX / kGatherLanes)
    return (int)cudaErrorInvalidValue;
  GatherLanes gl{};
  for (int64_t k = 0; k < (inv == nullptr ? 1 : count); ++k)
    gl.ids[k] = ids[k];
  gl.inv = inv;
  gl.L = L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bytes = cols * elem_bytes;
  if (all_aligned(sh, out, bytes, 16))
    return launch_gather_as<uint4>(sh, gl, rows, bytes, zero_foreign, n,
                                   out, s);
  if (all_aligned(sh, out, bytes, 4))
    return launch_gather_as<uint32_t>(sh, gl, rows, bytes, zero_foreign, n,
                                      out, s);
  return launch_gather_as<uint16_t>(sh, gl, rows, bytes, zero_foreign, n,
                                    out, s);
}

// `is_int`: 0 for float32 tables and deltas, 1 for int32. Ids outside
// [0, rows) add nothing. `order` (nullable): deltas row of sorted lane j
// is order[j], else j. `valid` (nullable): indexed like deltas rows; 0
// gates the lane off. `workspace`: `ws_words` int64 on the card, zero
// before the first call and left zero by each call on the stream; at
// least 2 + 2 * (n / kSplit + 1) for the n lanes launched (the long-run
// list), or the call fails.
int mv_row_scatter_add(void* param, int64_t rows, int64_t cols,
                       int64_t is_int, const int32_t* ids,
                       const int64_t* order, const void* deltas,
                       const int32_t* valid, int64_t n, void* workspace,
                       int64_t ws_words, void* stream) {
  return scatter(mv::one_shard(param), global_lanes(ids, order, deltas,
                                                    valid, n),
                 rows, cols, is_int, workspace, ws_words, stream);
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
  return scatter(sh, global_lanes(ids, order, deltas, valid, n), rows, cols,
                 is_int, workspace, ws_words, stream);
}

// The same over each shard's own lanes (the host-sliced form): shard k's
// lanes[k] lanes (at least 1) are ids[k] (LOCAL ids, sorted ascending),
// deltas[k] (a row each) and valid[k] (all null or none); no permutation.
// Host arrays of `count` entries, copied into the launch.
int mv_row_scatter_add_shards(void* const* bases, const int64_t* firsts,
                              int64_t count, int64_t rows, int64_t cols,
                              int64_t is_int, const int32_t* const* ids,
                              const void* const* deltas,
                              const int32_t* const* valid,
                              const int64_t* lanes, void* workspace,
                              int64_t ws_words, void* stream) {
  Shards sh;
  if (!mv::make_shards(sh, bases, firsts, count))
    return (int)cudaErrorInvalidValue;
  ShardLanes ln{};
  ln.masked = valid[0] != nullptr;
  for (int64_t k = 0; k < count; ++k) {
    if (lanes[k] < 1 || (valid[k] != nullptr) != (ln.masked != 0))
      return (int)cudaErrorInvalidValue;
    ln.ids[k] = ids[k];
    ln.deltas[k] = deltas[k];
    ln.valid[k] = valid[k];
    ln.start[k + 1] = ln.start[k] + lanes[k];
  }
  ln.count = (int)count;
  return scatter(sh, ln, rows, cols, is_int, workspace, ws_words, stream);
}

}  // extern "C"
