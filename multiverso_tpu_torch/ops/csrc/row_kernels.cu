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
// Row scatter-add (mv_row_scatter_add) replaces
// multiverso_tpu/ops/table_kernels.py build_row_scatter_add /
// _row_scatter_kernel and, with `valid` non-null,
// build_row_scatter_add_masked / _row_scatter_masked_kernel: every run of
// equal ids adds its (valid) deltas to its row, which is read once and
// written once; rows no id names are not touched (the table is updated in
// place, the counterpart of the TPU kernel's input_output_aliases).
// float32 and int32 tables. One call queues its plan (csrc/row_plan.cu's
// stable sort by row, which replaces the XLA argsort that feeds the TPU
// kernel, then the run scan here) and the scatter that walks it. The plan
// is bound by latency, not bytes (12 bytes a lane a pass): its kernels
// chain their tiles by decoupled look-back, wait on no counter of
// finished blocks but the run scan's, and are launched as programmatic
// dependents of one another (mv::launch_dependent), the scatter too, so
// the gaps between the call's five launches are hidden.
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
// order, so the call first plans the runs (csrc/row_plan.cuh): the stable
// permutation of the lanes by row, then, from the sorted lanes, the table
// of runs (each run's first and last lane and its row, numbered in lane
// order by an exclusive scan with look-back, no search) and the list of
// long runs. The scatter walks that table; each row receives row +
// d[first] + d[second] + ..., its valid deltas in sorted lane order (the
// TPU kernel's order, and the plain version's on the CPU), read once and
// written once; no two threads touch one row, so there are no atomics and
// the result is deterministic. That order is part of the function (it is
// what keeps sharded tables bit-identical to unsharded ones), so a run is
// never split into partial sums: what the design changes is how many loads
// are in flight while one thread per column adds in order.
//
// The scatter is one persistent launch (at most kLongBlocksPerSM blocks an
// SM): each block first takes long-run items, then its warps take short
// runs, so a call with no long run costs one launch, not two.
// - A short run (at most kSplit lanes) is one warp's: it gathers its
//   lanes' delta rows into registers kShortLoads at a time, each batch's
//   loads issued before its adds, and adds them in lane order.
// - A long run (a frequent word: Zipf ids put thousands of lanes on the
//   top word) is cut into 32-byte column slices, a block each. The block
//   stages its slice of the run's delta rows, gathered through `order`,
//   in a ring of shared-memory stages with cp.async (the delta row indices
//   come in the same way, a ring ahead), and the threads that own the
//   slice's columns add the staged rows in lane order from shared memory
//   and write their columns once.
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
// Here a foreign lane's run is passed over at the window check (the mesh
// form plans once, on the ids' card, and every card walks that plan), and
// sorted global ids keep every run inside one shard, so each shard's rows
// come out bit for bit the flat kernel's.
//
// The scatter's lanes (GlobalLanes, ShardLanes) come in segments. The
// flat and mesh forms have one segment of global ids, read through the
// plan's `order` (the masked form's ids come sorted: no sort, lane j's
// row is j). The host-sliced form has a segment a shard: that shard's real
// lanes in its own arrays, LOCAL ids, the pads after them never launched
// (with Zipf ids the shards' pads are runs of thousands of one id: walked,
// they would be the serial chain of the KV probe's padding fault). A run
// never crosses a segment (the run scan starts a run at each segment's
// first lane), so two shards' equal local ids stay two runs; the
// host-sliced form's lanes come sorted a shard, so it runs the run scan
// alone.
// The gather writes a foreign lane's out row as zeros when `zero_foreign`
// is set (the first launch into an output) and leaves it untouched
// otherwise (a card's second group of shards).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_plan.cuh"
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
// A long run is cut into column slices of kSliceBytes, one block each (a
// work item): one SM pulls a few tens of GB/s of scattered rows, so a run
// staged by one block is bound by its loads; a 32-byte slice keeps one
// block near its serial add chain. Each block: kLongThreads threads, a
// ring of kStages stages of kStageRows rows of its slice, the rows' flags
// (int32) and, two rings deep, their delta rows (order[] entries). These
// sizes, the add batch and the short-run load depth are the fastest of
// ops/scatter_sweep.py's variants at chip_smoke.py phase 2's cases, or
// within the spread of one (PERF.md).
constexpr int kLongThreads = 128;
constexpr int kSliceBytes = 32;
constexpr int kStages = 2;
constexpr int kStageRows = 512;
constexpr int kLongSmem = kStages * kStageRows * (kSliceBytes + 4 + 2 * 4);
// within the 48 KB a block gets without opting in
static_assert(kLongSmem <= 48 * 1024, "the long-run ring outgrew 48 KB");
// scatter blocks resident on one SM (kLongSmem each)
constexpr int kLongBlocksPerSM = 4;
// rows a column owner loads before it adds them
constexpr int kBatch = 16;
// a scatter block's warps, each of which takes short runs in turn, and the
// delta rows a warp loads before it adds them
constexpr int kScatterWarps = kLongThreads / 32;
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
// segment over every shard of the launch. `ids` are sorted: the plan's
// keys, or the masked form's ids, which come sorted; only the run scan
// reads them. Delta rows are read through `order` (the plan's
// permutation; null: lane j's row is j), `valid` nullable (`masked` says
// which).
struct GlobalLanes {
  const int32_t* ids;
  const int32_t* order;
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
// ids[k] (LOCAL ids, sorted), deltas[k] (a row a lane) and valid[k]
// (every one null, or none: `masked` says which); no permutation. Its own
// type, so that the flat and mesh launches do not carry these arrays
// (about 500 bytes of parameters cost 0.85 us a call).
struct ShardLanes {
  static constexpr const int32_t* order = nullptr;
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

// The plan a scatter walks (csrc/row_plan.cuh): counts[0] runs and
// counts[1] long runs; run k is launch lanes [first[k], end[k]) of the
// row with global id row[k]; longs[] lists the long runs in run order.
struct Plan {
  const uint32_t* counts;
  const int32_t* first;
  const int32_t* end;
  const int32_t* row;
  const int32_t* longs;
};

// Where the run scan writes the plan, and its scratch.
struct RunsOut {
  int32_t* first;
  int32_t* end;
  int32_t* row;
  int32_t* longs;
  mv::RunScratch scratch;
};

template <typename T>
T* at(void* ws, int64_t words) {
  return reinterpret_cast<T*>(static_cast<uint32_t*>(ws) + words);
}

// The plan that starts at `plan` (offsets from there).
Plan plan_at(const void* plan, const mv::PlanLayout& lay) {
  void* w = const_cast<void*>(plan);
  return Plan{at<uint32_t>(w, lay.counts), at<int32_t>(w, lay.first),
              at<int32_t>(w, lay.end), at<int32_t>(w, lay.row),
              at<int32_t>(w, lay.longs)};
}

// The table of runs (the plan's second half) over a launch's sorted
// lanes. A lane starts a run when its id names a row (in [0, R): the
// table's rows, or a shard's for the host-sliced form) and differs from
// the lane before it in its segment, and ends one when it differs from
// the lane after it. A run is long when the lane kSplit after its first
// still holds its id: the lanes are sorted, so that lane lies in the run
// exactly when the run has more than kSplit lanes, and no search is
// needed. Runs and long runs are numbered in lane order: a thread takes
// kPlanItems consecutive lanes, a block a tile, an exclusive sum over the
// block and a look-back over the earlier tiles (as in a sort pass) give
// each its numbers (mv::number_runs: tile blockIdx.x a block). The last
// tile writes the counts; block 0 zeroes the sort's digit counts for the
// next call, and the last block to finish the look-back words and its
// counter (mv::finish_runs).
template <typename L>
__global__ void __launch_bounds__(mv::kPlanThreads)
plan_runs_kernel(__grid_constant__ const Shards sh,
                 __grid_constant__ const L ln, int64_t R, int64_t n,
                 __grid_constant__ const RunsOut out) {
  const int tid = threadIdx.x;
  const int64_t t = blockIdx.x;
  mv::let_next_start();
  mv::wait_prior();
  const int64_t g0 = t * mv::kPlanTile + (int64_t)tid * mv::kPlanItems;
  unsigned starts = 0, ends = 0, longs = 0;  // bit k: lane g0 + k
  int32_t gid[mv::kPlanItems];
  // every load unconditional on another's value, so all are in flight at
  // once
#pragma unroll
  for (int k = 0; k < mv::kPlanItems; ++k) {
    const int64_t g = g0 + k;
    const Segment seg = ln.segment(sh, g);
    const int32_t* __restrict__ ids = seg.ids;
    const int64_t i = g - seg.start;
    const bool in = g < n;
    const int32_t r = in ? ids[i] : -1;
    const int32_t r_before = in && i > 0 ? ids[i - 1] : 0;
    const int32_t r_after = in && i + 1 < seg.n ? ids[i + 1] : 0;
    const int32_t r_far = in && i + kSplit < seg.n ? ids[i + kSplit] : 0;
    const bool real = in && r >= 0 && r < R;
    gid[k] = (int32_t)((seg.first < 0 ? 0 : seg.first) + r);
    if (real && (i == 0 || r_before != r)) {
      starts |= 1u << k;
      if (i + kSplit < seg.n && r_far == r) longs |= 1u << k;
    }
    if (real && (i + 1 == seg.n || r_after != r)) ends |= 1u << k;
  }
  mv::RunNumbers num = mv::number_runs(out.scratch, __popc(starts),
                                       __popc(longs));
#pragma unroll
  for (int k = 0; k < mv::kPlanItems; ++k) {
    const int64_t g = g0 + k;
    if ((starts >> k) & 1u) {
      out.first[num.run] = (int32_t)g;
      out.row[num.run] = gid[k];
      if ((longs >> k) & 1u) out.longs[num.lng++] = (int32_t)num.run;
      ++num.run;
    }
    if ((ends >> k) & 1u) out.end[num.run - 1] = (int32_t)(g + 1);
  }
  mv::finish_runs(out.scratch);
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

// The short runs of a plan (at most kSplit lanes), a warp each, taken by
// the launch's warps in turn: the warp gathers its lanes' delta rows into
// registers kShortLoads at a time, each batch's loads issued before its
// adds, and adds them in lane order, one pass per 32 V units of the row.
template <typename E, typename V, typename L>
__device__ __forceinline__ void short_runs(const Shards& sh, const L& ln,
                                           int64_t rows, int64_t vcols,
                                           const Plan& plan) {
  const int lane = threadIdx.x % kWarp;
  const int64_t runs = plan.counts[0];
  const int64_t step = (int64_t)gridDim.x * kScatterWarps;
  for (int64_t k = (int64_t)blockIdx.x * kScatterWarps + threadIdx.x / kWarp;
       k < runs; k += step) {
    const int64_t g = plan.first[k], g_end = plan.end[k];
    if (g_end - g > kSplit) continue;  // a long run: blocks take it
    V* row = shard_row<V>(sh, rows, vcols, plan.row[k]);
    if (row == nullptr) continue;  // another card's row
    const Segment seg = ln.segment(sh, g);
    const int32_t* __restrict__ valid = seg.valid;
    const int64_t i = g - seg.start, end = g_end - seg.start;
    const V* dv = static_cast<const V*>(seg.deltas);
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
          for (int q = 0; q < kShortLoads; ++q) {
            if (k0 + q >= m) break;
            const int64_t s = __shfl_sync(kFull, src, k0 + q);
            if (has_col && ((okm >> (k0 + q)) & 1u)) buf[q] = dv[s * vcols + c];
          }
#pragma unroll
          for (int q = 0; q < kShortLoads; ++q) {
            if (k0 + q >= m) break;
            if (has_col && ((okm >> (k0 + q)) & 1u)) vadd(acc, buf[q]);
          }
        }
      }
      if (has_col) row[c] = acc;
    }
  }
}

// The long runs of a plan as work items (run, column slice), taken by the
// blocks in turn. Per item: stage t's rows of the slice are added in lane
// order by the slice's column owners, one element each (threads 0..7 of
// the first warp: one add chain a thread), while the other warps copy
// stage t + kStages - 1 in with cp.async, in V units, and with it the
// delta rows of stage t + 2 kStages - 1, so no load of the loop waits on
// another. Masked lanes' rows are copied too; their flags (valid[],
// copied beside them) keep them out of the sum.
template <typename E, typename V, typename L>
__device__ __forceinline__ void long_runs(const Shards& sh, const L& ln,
                                          int64_t rows, int64_t vcols,
                                          const Plan& plan) {
  constexpr int kUnits = kSliceBytes / (int)sizeof(V);  // V units a slice
  constexpr int kLanes = kSliceBytes / (int)sizeof(E);  // its elements
  constexpr int kSrcSlots = 2 * kStages;
  const int64_t slices = (vcols + kUnits - 1) / kUnits;
  const int64_t items = (int64_t)plan.counts[1] * slices;
  extern __shared__ __align__(16) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);
  int* ring_ok = reinterpret_cast<int*>(
      smem + kStages * kStageRows * kSliceBytes);
  int* ring_src = ring_ok + kStages * kStageRows;
  const int tid = threadIdx.x;
  const int ptid = tid - kWarp;  // producers: the warps after the first
  constexpr int kProducers = kLongThreads - kWarp;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t run = plan.longs[item / slices];
    const int64_t c0 = (item % slices) * kUnits;
    V* row_v = shard_row<V>(sh, rows, vcols, plan.row[run]);
    if (row_v == nullptr) continue;  // another card's row (block-uniform)
    const int64_t g = plan.first[run];
    const int64_t len = plan.end[run] - g;
    const Segment seg = ln.segment(sh, g);
    const int64_t start = g - seg.start;  // in the segment
    const int32_t* __restrict__ valid = seg.valid;
    const V* dv = static_cast<const V*>(seg.deltas);
    const int w = vcols - c0 < kUnits ? (int)(vcols - c0) : kUnits;
    const int owners = w * (int)(sizeof(V) / sizeof(E));
    E* row = reinterpret_cast<E*>(row_v + c0);
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
          copy_async(dst + r, ln.order + j0 + r, 4);
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
}

// The scatter along a plan (E the element type, V the access type: E or a
// 16-byte vector of E; `vcols` V units a row), one persistent launch: each
// block takes long-run items first (the long chains start at once), then
// its warps take short runs. A run whose row no shard of the launch holds
// is passed over: the mesh form shares one plan among its cards.
template <typename E, typename V, typename L>
__global__ void __launch_bounds__(kLongThreads, kLongBlocksPerSM)
scatter_kernel(__grid_constant__ const Shards sh,
               __grid_constant__ const L ln, int64_t rows, int64_t vcols,
               __grid_constant__ const Plan plan) {
  mv::wait_prior();
  long_runs<E, V>(sh, ln, rows, vcols, plan);
  short_runs<E, V>(sh, ln, rows, vcols, plan);
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

// The run scan over `ln` (R: the rows a lane's id must name) into the
// workspace laid out as `lay`.
template <typename L>
int plan_runs(const Shards& sh, const L& ln, int64_t R, void* ws,
              int64_t ws_words, const mv::PlanLayout& lay, cudaStream_t s) {
  void* plan = at<uint32_t>(ws, lay.plan);
  const RunsOut out{
      at<int32_t>(plan, lay.first), at<int32_t>(plan, lay.end),
      at<int32_t>(plan, lay.row), at<int32_t>(plan, lay.longs),
      mv::RunScratch{at<uint32_t>(ws, 2 * ws_words), at<uint32_t>(ws, lay.ctl),
                     at<uint32_t>(ws, lay.digits), lay.digit_words(),
                     at<uint32_t>(plan, lay.counts)}};
  return (int)mv::launch_dependent(plan_runs_kernel<L>, (unsigned)lay.tiles,
                                   mv::kPlanThreads, 0, s, sh, ln, R,
                                   ln.lanes(), out);
}

// The whole plan of GLOBAL ids over R rows: the sort, then the run scan
// over its keys; `ln` is left reading the deltas through its order.
int plan_global(const int32_t* ids, int64_t n, int64_t R, void* ws,
                int64_t ws_words, const mv::PlanLayout& lay,
                GlobalLanes* ln, cudaStream_t s) {
  const cudaError_t err = mv::sort_keys(
      mv::SortKeys{{ids, nullptr}, {R, 0}, 1}, n, static_cast<uint32_t*>(ws),
      at<uint32_t>(ws, 2 * ws_words), lay, s);
  if (err != cudaSuccess) return (int)err;
  ln->ids = at<int32_t>(ws, lay.keys);
  ln->order = at<int32_t>(ws, lay.plan + lay.order);
  return plan_runs(Shards{}, *ln, R, ws, ws_words, lay, s);
}

// A workspace of ws_words int64 holds the layout for n lanes.
bool fits(const void* ws, int64_t ws_words, int64_t n) {
  return ws != nullptr && n < mv::kMaxPlanLanes &&
         2 * ws_words >= mv::PlanLayout(n, kSplit).words;
}

template <typename E, typename V, typename L>
int launch_scatter_as(const Shards& sh, const L& ln, int64_t rows,
                      int64_t vcols, int64_t n, const Plan& plan,
                      cudaStream_t s) {
  // enough blocks for a warp a run or a block a long-run item, at most as
  // many as stay resident (a block takes its work in turn)
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  constexpr int kUnits = kSliceBytes / (int)sizeof(V);
  const int64_t items = (n / (kSplit + 1)) * ((vcols + kUnits - 1) / kUnits);
  const int64_t warps = (n + kScatterWarps - 1) / kScatterWarps;
  const int64_t want = items > warps ? items : warps;
  const int64_t resident = (int64_t)sms * kLongBlocksPerSM;
  return (int)mv::launch_dependent(
      scatter_kernel<E, V, L>,
      (unsigned)(want < resident ? want : resident), kLongThreads,
      kLongSmem, s, sh, ln, rows, vcols, plan);
}

template <typename E, typename V4, typename L>
int launch_scatter(const Shards& sh, const L& ln, int64_t rows, int64_t cols,
                   const Plan& plan, cudaStream_t s) {
  const int64_t n = ln.lanes();
  bool vec = cols % 4 == 0 && ln.deltas_aligned(16);
  for (int k = 0; k < sh.count; ++k) vec = vec && aligned(sh.base[k], 16);
  if (vec)
    return launch_scatter_as<E, V4>(sh, ln, rows, cols / 4, n, plan, s);
  return launch_scatter_as<E, E>(sh, ln, rows, cols, n, plan, s);
}

template <typename L>
int scatter(const Shards& sh, const L& ln, int64_t rows, int64_t cols,
            int64_t is_int, const Plan& plan, cudaStream_t s) {
  if (is_int)
    return launch_scatter<int32_t, int4>(sh, ln, rows, cols, plan, s);
  return launch_scatter<float, float4>(sh, ln, rows, cols, plan, s);
}

GlobalLanes global_lanes(const int32_t* ids, const int32_t* order,
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
// [0, rows) add nothing. `sorted` 0: the ids come in any order, and the
// call plans them (the sort, then the run scan) before the scatter reads
// each sorted lane's delta row through the plan's permutation; 1: the ids
// come sorted ascending, the run scan takes them as they are and lane j
// reads delta row j. `valid` (nullable): indexed like delta rows; 0
// gates the lane off. `workspace`: `ws_words` int64 on the card, zero
// when first used, and left by each call as the next call on the stream
// needs it (csrc/row_plan.cuh); at least the layout for n lanes, or the
// call fails and nothing launches.
int mv_row_scatter_add(void* param, int64_t rows, int64_t cols,
                       int64_t is_int, const int32_t* ids, int64_t sorted,
                       const void* deltas, const int32_t* valid, int64_t n,
                       void* workspace, int64_t ws_words, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (!fits(workspace, ws_words, n) || rows < 1 || rows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const mv::PlanLayout lay(n, kSplit);
  GlobalLanes ln = global_lanes(ids, nullptr, deltas, valid, n);
  const int err =
      sorted ? plan_runs(Shards{}, ln, rows, workspace, ws_words, lay, s)
             : plan_global(ids, n, rows, workspace, ws_words, lay, &ln, s);
  if (err != 0) return err;
  return scatter(mv::one_shard(param), ln, rows, cols, is_int,
                 plan_at(at<uint32_t>(workspace, lay.plan), lay), s);
}

// The plan alone of n ids in any order over a table of R rows (global
// ids: a sharded table's rows all together), into `workspace` as for
// mv_row_scatter_add; the mesh form shares it among its cards.
int mv_row_scatter_plan(const int32_t* ids, int64_t n, int64_t R,
                        void* workspace, int64_t ws_words, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (!fits(workspace, ws_words, n) || R < 1 || R > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  GlobalLanes ln = global_lanes(ids, nullptr, nullptr, nullptr, n);
  return plan_global(ids, n, R, workspace, ws_words,
                     mv::PlanLayout(n, kSplit), &ln,
                     static_cast<cudaStream_t>(stream));
}

// The scatter of n lanes (deltas in request order, a row each) along the
// plan that mv_row_scatter_plan left at `plan` (the plan_words of its
// workspace that start at its plan offset, here on this card), over the `count` shards of one card (at
// most mv::kMaxShards), each of `rows` rows: bases[k] is shard k's row 0,
// firsts[k] its global id. Host arrays, copied into the launch. A run
// whose row no shard of the launch holds adds nothing.
int mv_row_scatter_add_mesh(void* const* bases, const int64_t* firsts,
                            int64_t count, int64_t rows, int64_t cols,
                            int64_t is_int, const void* plan,
                            const void* deltas, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Shards sh;
  if (!mv::make_shards(sh, bases, firsts, count) || plan == nullptr ||
      n >= mv::kMaxPlanLanes)
    return (int)cudaErrorInvalidValue;
  const mv::PlanLayout lay(n, kSplit);
  const GlobalLanes ln = global_lanes(
      nullptr, at<int32_t>(const_cast<void*>(plan), lay.order), deltas,
      nullptr, n);
  return scatter(sh, ln, rows, cols, is_int, plan_at(plan, lay),
                 static_cast<cudaStream_t>(stream));
}

// The same over each shard's own lanes (the host-sliced form): shard k's
// lanes[k] lanes (at least 1) are ids[k] (LOCAL ids, sorted ascending),
// deltas[k] (a row each) and valid[k] (all null or none); no permutation.
// Host arrays of `count` entries, copied into the launch. The run scan
// takes each shard's lanes as a segment of their own, so two shards'
// equal local ids stay two runs.
int mv_row_scatter_add_shards(void* const* bases, const int64_t* firsts,
                              int64_t count, int64_t rows, int64_t cols,
                              int64_t is_int, const int32_t* const* ids,
                              const void* const* deltas,
                              const int32_t* const* valid,
                              const int64_t* lanes, void* workspace,
                              int64_t ws_words, void* stream) {
  Shards sh;
  if (!mv::make_shards(sh, bases, firsts, count) || rows < 1 ||
      rows > INT32_MAX)
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
  const int64_t n = ln.lanes();
  if (!fits(workspace, ws_words, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const mv::PlanLayout lay(n, kSplit);
  const int err = plan_runs(sh, ln, rows, workspace, ws_words, lay, s);
  if (err != 0) return err;
  return scatter(sh, ln, rows, cols, is_int,
                 plan_at(at<uint32_t>(workspace, lay.plan), lay), s);
}

}  // extern "C"
