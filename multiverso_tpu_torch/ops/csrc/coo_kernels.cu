// COO scatter-add, param[rows[i], cols[i]] += vals[i], for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by ops/_build.py; each entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() of its launch.
//
// mv_coo_scatter_add replaces the TPU kernels of
// multiverso_tpu/ops/table_kernels.py build_coo_scatter_add / _coo_kernel
// and, with `valid` non-null, build_coo_scatter_add_masked /
// _coo_masked_kernel. A lane whose `valid` is 0, whose row lies outside
// every shard window of the launch, or whose column lies outside [0, C),
// adds nothing. A tiled [R, C/128, 128] table is the same memory as
// [R, C]. The table is updated in place. The TPU kernel needs its lanes
// sorted by row, because it keeps one row resident in VMEM per run.
//
// What bounds it: bytes. Each lane reads 12 bytes (row, column, value)
// and makes one 4-byte add; each touched element is read and written
// once. Into a table that L2 does not hold (LightLDA's [50,001, 1024] int32
// word-topic counts are 205 MB), a random add moves a 32-byte sector in
// and out, so the sectors the lanes touch bound it first. LightLDA's
// sweep-end rebuild sends one lane per token (10M) in token order, and its
// word ids are Zipf-skewed: the top word owns about 14% of the lanes.
//
// What the design does about it.
//
// int32 (LightLDA's counts): integer adds commute and wrap the same way in
// any order, so the table ends bit-identical to the plain version whatever
// the lane order, and the lanes need no sort. A grid-stride launch sized
// from the SM count (kBlocksPerSM) fills the card; a thread loads kVec
// lanes as 16-byte vectors where every lane array is aligned. Equal
// elements are combined before they reach the table: a block-private
// open-addressing table in shared memory (2^kHashBits slots keyed by the
// element's address) takes a lane's value when the element holds, or
// claims, its one slot, else the lane adds with a global atomic; the block
// flushes each nonzero slot once at its end. A zero value adds nothing
// (LightLDA's padded lanes carry 0). So a Zipf head element that thousands
// of a block's lanes hit costs the block one atomic, not thousands
// serialized on one L2 address, while a cold element costs one shared
// probe more than a bare atomic. ops/coo_sweep.py times the constants on
// LightLDA's lanes; PERF.md keeps what it measured, the designs that lost
// included (more probes a lane, a warp's combining of equal elements).
// The mask is a byte a lane (4 lanes' bytes in one load), so that a
// SparseMatrixTable add passes its host prep's (shards, L) bool mask as it
// lies: widening it to int32 took a kernel every call that cost about as
// much as the add (chip_smoke.py phase 11's split; PERF.md).
//
// float32 (the sgd updater's sparse Add): float sums depend on their
// order, and the plain version (a stable-sorted index_add_ on the CPU)
// adds each element's terms in lane order, the TPU kernel's order too:
// element e receives e + v[first] + v[second] + ..., its lanes in input
// order, a left fold. Different elements never interact, so the order
// that matters is within one element. The call plans its lanes (csrc/
// row_plan.cuh's workspace, a COO layout of its own) and then walks the
// plan, all its kernels queued back to back as programmatic dependents
// (mv::launch_dependent) by one entry point:
// - keys (coo_keys_kernel): lane g's element as a sort key, or a key that
//   sorts after every real lane when it adds nothing (`valid` 0, a row
//   outside every shard of the launch, a column outside [0, C));
// - the stable LSD radix sort of csrc/row_plan.cu (mv::sort_keys) by
//   element: the permutation of a stable argsort of row * C + column;
// - the run scan (coo_runs_kernel): one run per touched element, its
//   first and last sorted lane and its (row, column), numbered in lane
//   order by a block sum and a look-back over the tiles (as the row
//   scatter's run scan: no search, no atomics);
// - the walk (coo_walk_kernel): a thread a run folds its lanes' values in
//   registers in sorted lane order, reading each through the permutation,
//   and writes the element once. No float atomics and no partial sums of
//   a run: the bits are the plain version's.
// The key. The element key row * C + column when it fits 31 bits (R * C
// below 2^31: LightLDA's [50,001, 1024] needs 26, 4 passes of 6-7 bits);
// otherwise two words, the column low and the row high, sorted word by
// word (mv::sort_keys reads the high word's first pass through the low
// word's permutation), so that any table the int32 lane ids can address
// sorts without torch.sort and without a key wider than 32 bits stored.
// Keying (run index, column) on lanes that already come row-sorted (the
// masked and segment forms) was the other way; it saves no pass at
// LightLDA's widths and needs a row scan ahead of the sort, so every form
// takes the element key.
// What bounds it: latency, not bytes (20 bytes a lane: 10 MB at 512,000
// lanes, 3 us at 3.35 TB/s): the plan is a chain of dependent kernels (the
// keys, a digit count, a kernel a pass, the run scan), each a look-back
// from tile to tile; the walk is as long as the longest element run, whose
// lanes one thread adds in order (a Zipf-1.1 call of 512,000 lanes into
// [50,001, 1024] puts about 100 on its top element; every lane on one
// element stays one chain). The walk loads a batch of kWalkBatch lanes'
// positions and values before it adds them, the next batch's positions
// in flight under this one's adds, so the chain waits on its adds and on
// one value load a batch.
//
// The shards (shards.cuh): a lane's row is found among the launch's
// shards; a flat table is one shard whose first row has the global id 0.
// A table split into shards launches once per card over the GLOBAL lanes
// with every shard that card holds (mv_coo_scatter_add_mesh), replacing
// the in-trace _sharded_coo_scatter_add (masked lanes in a shard_map, the
// foreign ones parked on the shard's last row), or over each shard's own
// real lanes, a segment a shard with LOCAL row ids
// (mv_coo_scatter_add_shards), replacing build_coo_scatter_add_sharded (a
// masked COO kernel per shard). The pads after a shard's real lanes are
// never launched. float32: the mesh form plans once, on the lanes' card,
// over the global rows (mv_coo_scatter_plan), and each card walks that
// plan, passing over the runs of rows it does not hold; the segment form
// plans each card's launch over its segments, segment k's local row r
// keyed as the launch row k * rows + r, so a run never crosses a segment.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_plan.cuh"
#include "shards.cuh"

namespace {

using mv::Shards;
using mv::shard_row;

// int32: threads a block, resident blocks an SM the grid is sized for,
// lanes a thread loads at once (4: one 16-byte vector an array) and the
// shared table (2^kHashBits slots; 0: none). ops/coo_sweep.py times each
// against its neighbours.
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kVec = 4;
constexpr int kHashBits = 11;
constexpr int kHashSlots = kHashBits > 0 ? 1 << kHashBits : 1;
// float32: the walk's threads a block (a thread a run), its resident
// blocks an SM, and the lanes of a run it loads before it adds them
constexpr int kWalkThreads = 256;
constexpr int kWalkBlocksPerSM = 8;
constexpr int kWalkBatch = 8;

// The lanes of one segment: its arrays, its lane count and the first
// launch unit (kVec lanes, or one) that reads it. `base` is the shard's
// row 0 for LOCAL row ids (the host-sliced form: segment k of the
// launch); nullptr (k -1) when the rows are global ids, found among the
// launch's shards.
struct Segment {
  const int32_t* rows;
  const int32_t* cols;
  const void* vals;
  const uint8_t* valid;
  int64_t n, ustart;
  void* base;
  int k;
};

// The flat and mesh forms: one segment of global row ids.
struct GlobalLanes {
  const int32_t* rows;
  const int32_t* cols;
  const void* vals;
  const uint8_t* valid;
  int64_t n, units;
  __device__ __forceinline__ Segment segment(const Shards&, int64_t) const {
    return Segment{rows, cols, vals, valid, n, 0, nullptr, -1};
  }
  int64_t lanes() const { return n; }
  bool aligned(unsigned bytes) const {
    return mv::aligned(rows, bytes) && mv::aligned(cols, bytes) &&
           mv::aligned(vals, bytes) && mv::aligned(valid, bytes / 4);
  }
  void cut(int vec) { units = (n + vec - 1) / vec; }
};

// The host-sliced form: segment k is shard k's n[k] real lanes (LOCAL row
// ids) in its own arrays, launch units [ustart[k], ustart[k + 1]). Its own
// type, so that the flat and mesh launches do not carry these arrays.
struct ShardLanes {
  const int32_t* rows[mv::kMaxShards];
  const int32_t* cols[mv::kMaxShards];
  const void* vals[mv::kMaxShards];
  const uint8_t* valid[mv::kMaxShards];
  int64_t n[mv::kMaxShards];
  int64_t ustart[mv::kMaxShards + 1];
  int64_t units;
  int count;
  // the segment that holds launch unit u (mv::find_segment)
  __device__ __forceinline__ Segment segment(const Shards& sh,
                                             int64_t u) const {
    Segment s;
    mv::find_segment(ustart, count, u, [&](int k) {
      s = Segment{rows[k], cols[k], vals[k], valid[k], n[k], ustart[k],
                  sh.base[k], k};
    });
    return s;
  }
  int64_t lanes() const {
    int64_t total = 0;
    for (int k = 0; k < count; ++k) total += n[k];
    return total;
  }
  bool aligned(unsigned bytes) const {
    bool ok = true;
    for (int k = 0; k < count; ++k)
      ok = ok && mv::aligned(rows[k], bytes) && mv::aligned(cols[k], bytes) &&
           mv::aligned(vals[k], bytes) && mv::aligned(valid[k], bytes / 4);
    return ok;
  }
  void cut(int vec) {
    for (int k = 0; k < count; ++k)
      ustart[k + 1] = ustart[k] + (n[k] + vec - 1) / vec;
    units = ustart[count];
  }
};

// Row r of a segment, as T*, or nullptr when the launch holds no such row.
template <typename T>
__device__ __forceinline__ T* segment_row(const Shards& sh, const Segment& s,
                                          int64_t rows, int64_t cols,
                                          int32_t r) {
  if (s.base == nullptr) return shard_row<T>(sh, rows, cols, r);
  return r >= 0 && r < rows ? static_cast<T*>(s.base) + (int64_t)r * cols
                            : nullptr;
}

// The int32 element a lane adds to, or nullptr when it adds nothing.
__device__ __forceinline__ int32_t* lane_element(const Shards& sh,
                                                 const Segment& s,
                                                 int64_t rows, int64_t cols,
                                                 int32_t r, int32_t c,
                                                 int32_t ok) {
  if (ok == 0 || c < 0 || c >= cols) return nullptr;
  int32_t* row = segment_row<int32_t>(sh, s, rows, cols, r);
  return row == nullptr ? nullptr : row + c;
}

// Launch unit u's VEC lanes: each one's element (nullptr: adds nothing)
// and value. Whole units load as 16-byte vectors (streaming: read once),
// the mask's 4 bytes as one, a segment's ragged last unit lane by lane.
template <int VEC>
__device__ __forceinline__ void load_unit(const Shards& sh, const Segment& s,
                                          int64_t u, int64_t rows,
                                          int64_t cols, int32_t* (&dst)[VEC],
                                          int32_t (&val)[VEC]) {
  const int64_t j0 = (u - s.ustart) * VEC;
  const int32_t* vals = static_cast<const int32_t*>(s.vals);
  if constexpr (VEC == 4) {
    if (j0 + 4 <= s.n) {
      int32_t r[4], c[4], ok[4];
      const int4 rv = __ldcs(reinterpret_cast<const int4*>(s.rows + j0));
      const int4 cv = __ldcs(reinterpret_cast<const int4*>(s.cols + j0));
      const int4 vv = __ldcs(reinterpret_cast<const int4*>(vals + j0));
      const uchar4 ov = s.valid == nullptr
          ? make_uchar4(1, 1, 1, 1)
          : __ldcs(reinterpret_cast<const uchar4*>(s.valid + j0));
      r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
      c[0] = cv.x; c[1] = cv.y; c[2] = cv.z; c[3] = cv.w;
      val[0] = vv.x; val[1] = vv.y; val[2] = vv.z; val[3] = vv.w;
      ok[0] = ov.x; ok[1] = ov.y; ok[2] = ov.z; ok[3] = ov.w;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[k] = lane_element(sh, s, rows, cols, r[k], c[k], ok[k]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int64_t j = j0 + k;
    dst[k] = nullptr;
    val[k] = 0;
    if (j < s.n) {
      val[k] = vals[j];
      dst[k] = lane_element(sh, s, rows, cols, s.rows[j], s.cols[j],
                            s.valid == nullptr ? 1 : s.valid[j]);
    }
  }
}

// Add `val` at `dst` through the block's shared table: true when dst's one
// slot holds it (found, or claimed empty). A slot's key is the element's
// address; 0 marks it empty.
__device__ __forceinline__ bool hash_add(unsigned long long* keys,
                                         int32_t* sums, int32_t* dst,
                                         int32_t val) {
  const unsigned long long key = reinterpret_cast<unsigned long long>(dst);
  constexpr int kShift = 64 - (kHashBits > 0 ? kHashBits : 1);
  const unsigned slot =
      (unsigned)(((key >> 2) * 0x9E3779B97F4A7C15ull) >> kShift);
  unsigned long long k = keys[slot];
  if (k == 0) {
    k = atomicCAS(&keys[slot], 0ull, key);
    if (k == 0) k = key;
  }
  if (k != key) return false;
  atomicAdd(&sums[slot], val);
  return true;
}

// One lane's add: into the block's table or, when its slot holds another
// element, the table itself; nothing for a lane with no element (nullptr)
// or a value of 0.
__device__ __forceinline__ void add_lane(int32_t* dst, int32_t val,
                                         unsigned long long* keys,
                                         int32_t* sums) {
  if (dst == nullptr || val == 0) return;
  if constexpr (kHashBits > 0) {
    if (hash_add(keys, sums, dst, val)) return;
  }
  atomicAdd(dst, val);
}

// The int32 kernel: a grid-stride loop over launch units of VEC lanes.
template <int VEC, typename L>
__global__ void __launch_bounds__(kThreads)
coo_add_int_kernel(__grid_constant__ const Shards sh,
                   __grid_constant__ const L ln, int64_t rows,
                   int64_t cols) {
  __shared__ unsigned long long s_keys[kHashSlots];
  __shared__ int32_t s_sums[kHashSlots];
  if constexpr (kHashBits > 0) {
    for (int i = threadIdx.x; i < kHashSlots; i += kThreads) {
      s_keys[i] = 0;
      s_sums[i] = 0;
    }
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       u < ln.units; u += stride) {
    int32_t* dst[VEC];
    int32_t val[VEC];
    load_unit<VEC>(sh, ln.segment(sh, u), u, rows, cols, dst, val);
#pragma unroll
    for (int k = 0; k < VEC; ++k) add_lane(dst[k], val[k], s_keys, s_sums);
  }
  if constexpr (kHashBits > 0) {
    __syncthreads();
    for (int i = threadIdx.x; i < kHashSlots; i += kThreads) {
      const int32_t sum = s_sums[i];
      if (s_keys[i] != 0 && sum != 0)
        atomicAdd(reinterpret_cast<int32_t*>(s_keys[i]), sum);
    }
  }
}

// -- float32: the plan and its walk -----------------------------------------

template <typename T>
T* at(void* ws, int64_t words) {
  return reinterpret_cast<T*>(static_cast<uint32_t*>(ws) + words);
}

// The COO plan's workspace layout for n lanes: its runs' columns where
// the row scatter keeps its long runs (split 0), digit rows for two key
// words, and two arrays of lane keys.
mv::PlanLayout coo_layout(int64_t n) {
  return mv::PlanLayout(n, 0, mv::kMaxPasses, mv::kMaxWords);
}

// A workspace of ws_words int64 holds the COO layout for n lanes.
bool coo_fits(const void* ws, int64_t ws_words, int64_t n) {
  return ws != nullptr && n < mv::kMaxPlanLanes &&
         2 * ws_words >= coo_layout(n).words;
}

// The sort keys of launch lane g (one a thread, grid-stride): its element
// (row key k, column c) as key0 = k * cols + c (one word), or key0 = c and
// key1 = k (two words); -1 (taken as the word's limit: after every real
// lane) for a lane that adds nothing. The row key is the global id for
// global lanes (in [0, key_rows)), k * rows + r for segment k's local row
// r (in [0, rows)).
template <typename L>
__global__ void __launch_bounds__(mv::kPlanThreads)
coo_keys_kernel(__grid_constant__ const Shards sh,
                __grid_constant__ const L ln, int64_t rows, int64_t cols,
                int64_t key_rows, int two_words, int32_t* __restrict__ key0,
                int32_t* __restrict__ key1) {
  mv::let_next_start();
  mv::wait_prior();
  const int64_t stride = (int64_t)gridDim.x * mv::kPlanThreads;
  for (int64_t g = (int64_t)blockIdx.x * mv::kPlanThreads + threadIdx.x;
       g < ln.units; g += stride) {
    const Segment s = ln.segment(sh, g);
    const int64_t i = g - s.ustart;
    const int32_t r = s.rows[i], c = s.cols[i];
    const int32_t ok = s.valid == nullptr ? 1 : s.valid[i];
    const int64_t limit = s.k < 0 ? key_rows : rows;
    const bool in = ok != 0 && c >= 0 && c < cols && r >= 0 && r < limit;
    const int64_t rk = (s.k < 0 ? 0 : (int64_t)s.k * rows) + r;
    if (two_words) {
      key0[g] = in ? c : -1;
      key1[g] = in ? (int32_t)rk : -1;
    } else {
      key0[g] = in ? (int32_t)(rk * cols + c) : -1;
    }
  }
}

// The plan a walk reads (csrc/row_plan.cuh's plan region, COO layout):
// counts[0] runs; run k is sorted lanes [first[k], end[k]) of the element
// (row[k], col[k]) (row: the plan's row key); order[] the permutation.
struct CooPlan {
  const uint32_t* counts;
  const int32_t* order;
  const int32_t* first;
  const int32_t* end;
  const int32_t* row;
  const int32_t* col;
};

CooPlan coo_plan_at(const void* plan, const mv::PlanLayout& lay) {
  void* w = const_cast<void*>(plan);
  return CooPlan{at<uint32_t>(w, lay.counts), at<int32_t>(w, lay.order),
                 at<int32_t>(w, lay.first), at<int32_t>(w, lay.end),
                 at<int32_t>(w, lay.row), at<int32_t>(w, lay.longs)};
}

struct CooRunsArgs {
  const uint32_t* keys;  // the sort's keys of its last word
  const int32_t* order;
  const int32_t* key0;   // two words: each lane's column
  int32_t* first;
  int32_t* end;
  int32_t* row;
  int32_t* col;
  int64_t n, cols, key_rows;
  int two_words;
  mv::RunScratch scratch;
};

constexpr uint64_t kNoElement = ~0ull;

// The element of sorted lane j as (row key << 32 | column), or kNoElement
// for a lane that adds nothing or j outside [0, n).
__device__ __forceinline__ uint64_t sorted_element(const CooRunsArgs& a,
                                                   int64_t j) {
  if (j < 0 || j >= a.n) return kNoElement;
  const uint32_t key = a.keys[j];
  if (a.two_words)
    return key < a.key_rows
               ? (uint64_t)key << 32 | (uint32_t)a.key0[a.order[j]]
               : kNoElement;
  return key < a.key_rows * a.cols
             ? (uint64_t)(key / (uint32_t)a.cols) << 32 |
                   (key % (uint32_t)a.cols)
             : kNoElement;
}

// The table of element runs over the sorted lanes: a lane starts a run
// when it adds something and its element differs from the lane before
// it, and ends one when it differs from the lane after it. Numbered in
// lane order as the row scatter's run scan numbers its runs
// (mv::number_runs: a thread kPlanItems lanes, tile blockIdx.x a block;
// no long runs), its scratch left zero (mv::finish_runs).
__global__ void __launch_bounds__(mv::kPlanThreads)
coo_runs_kernel(__grid_constant__ const CooRunsArgs a) {
  mv::let_next_start();
  mv::wait_prior();
  const int64_t j0 = (int64_t)blockIdx.x * mv::kPlanTile +
                     (int64_t)threadIdx.x * mv::kPlanItems;
  // lanes j0 - 1 .. j0 + kPlanItems, every load in flight at once
  uint64_t e[mv::kPlanItems + 2];
#pragma unroll
  for (int q = 0; q < mv::kPlanItems + 2; ++q)
    e[q] = sorted_element(a, j0 - 1 + q);
  unsigned starts = 0, ends = 0;  // bit k: lane j0 + k
#pragma unroll
  for (int k = 0; k < mv::kPlanItems; ++k) {
    if (e[k + 1] == kNoElement) continue;
    if (e[k] != e[k + 1]) starts |= 1u << k;
    if (e[k + 2] != e[k + 1]) ends |= 1u << k;
  }
  mv::RunNumbers num = mv::number_runs(a.scratch, __popc(starts), 0);
#pragma unroll
  for (int k = 0; k < mv::kPlanItems; ++k) {
    const int64_t j = j0 + k;
    if ((starts >> k) & 1u) {
      a.first[num.run] = (int32_t)j;
      a.row[num.run] = (int32_t)(e[k + 1] >> 32);
      a.col[num.run] = (int32_t)(uint32_t)e[k + 1];
      ++num.run;
    }
    if ((ends >> k) & 1u) a.end[num.run - 1] = (int32_t)(j + 1);
  }
  mv::finish_runs(a.scratch);
}

// acc + the values of sorted lanes [j, end) in lane order, each read
// through the permutation: whole batches of kWalkBatch with their values
// loaded before their adds and the next batch's positions loaded under
// them, then the rest one by one.
__device__ __forceinline__ float fold_run(float acc,
                                          const float* __restrict__ vals,
                                          const int32_t* __restrict__ order,
                                          int64_t j, int64_t end) {
  const int64_t full = j + (end - j) / kWalkBatch * kWalkBatch;
  int32_t o[kWalkBatch];
  if (j < full) {
#pragma unroll
    for (int q = 0; q < kWalkBatch; ++q) o[q] = order[j + q];
  }
  while (j < full) {
    float v[kWalkBatch];
#pragma unroll
    for (int q = 0; q < kWalkBatch; ++q) v[q] = vals[o[q]];
    j += kWalkBatch;
    if (j < full) {
#pragma unroll
      for (int q = 0; q < kWalkBatch; ++q) o[q] = order[j + q];
    }
#pragma unroll
    for (int q = 0; q < kWalkBatch; ++q) acc += v[q];
  }
  for (; j < end; ++j) acc += vals[order[j]];
  return acc;
}

// Where the walk finds a run's element and its lanes' values: global
// lanes (the flat and mesh forms) read vals[g] and find the row among the
// launch's shards (nullptr: foreign, passed over); the segment form finds
// segment k = row / rows, its shard and its own values.
struct GlobalWalk {
  const float* vals;
  __device__ __forceinline__ float* element(const Shards& sh, int64_t rows,
                                            int64_t cols, int32_t r,
                                            int32_t c,
                                            const float** v) const {
    *v = vals;
    float* row = mv::shard_row<float>(sh, rows, cols, r);
    return row == nullptr ? nullptr : row + c;
  }
};

struct ShardWalk {
  const float* vals[mv::kMaxShards];
  int64_t start[mv::kMaxShards];
  // the segment is selected in an unrolled loop, so that every index into
  // the by-value arrays is a constant
  __device__ __forceinline__ float* element(const Shards& sh, int64_t rows,
                                            int64_t cols, int32_t r,
                                            int32_t c,
                                            const float** v) const {
    const int seg = (int)(r / rows);
    float* dst = nullptr;
#pragma unroll
    for (int k = 0; k < mv::kMaxShards; ++k) {
      if (k >= sh.count) break;
      if (k == seg) {
        *v = vals[k] - start[k];  // lane g's value at (*v)[g]
        dst = static_cast<float*>(sh.base[k]) +
              (r - (int64_t)k * rows) * cols + c;
      }
    }
    return dst;
  }
};

// The walk: a thread a run (grid-stride), its element read once, its
// lanes folded in sorted lane order, written once.
template <typename W>
__global__ void __launch_bounds__(kWalkThreads)
coo_walk_kernel(__grid_constant__ const Shards sh,
                __grid_constant__ const W vw, int64_t rows, int64_t cols,
                __grid_constant__ const CooPlan plan) {
  mv::wait_prior();
  const int64_t runs = plan.counts[0];
  const int64_t stride = (int64_t)gridDim.x * kWalkThreads;
  for (int64_t k = (int64_t)blockIdx.x * kWalkThreads + threadIdx.x;
       k < runs; k += stride) {
    const float* vals = nullptr;
    float* dst = vw.element(sh, rows, cols, plan.row[k], plan.col[k], &vals);
    if (dst == nullptr) continue;
    *dst = fold_run(*dst, vals, plan.order, plan.first[k], plan.end[k]);
  }
}

// The plan of a launch's lanes into the workspace (COO layout): keys, the
// sort, the run scan. key_rows: the row keys' range (global rows, or
// segments x rows).
template <typename L>
int coo_plan(const Shards& sh, L ln, int64_t rows, int64_t cols,
             int64_t key_rows, void* ws, int64_t ws_words, cudaStream_t s) {
  ln.cut(1);
  const int64_t n = ln.units;
  if (!coo_fits(ws, ws_words, n) || rows < 1 || cols < 1 ||
      cols > INT32_MAX || key_rows < 1 || key_rows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const mv::PlanLayout lay = coo_layout(n);
  const bool two = key_rows * cols > INT32_MAX;
  int32_t* key0 = at<int32_t>(ws, lay.lane_keys);
  int32_t* key1 = key0 + mv::round4(n);
  uint32_t* top = at<uint32_t>(ws, 2 * ws_words);
  int sms = 0;
  cudaError_t err = mv::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = (n + mv::kPlanThreads - 1) / mv::kPlanThreads;
  const int64_t most = 4 * (int64_t)sms;
  err = mv::launch_dependent(coo_keys_kernel<L>,
                             (unsigned)(need < most ? need : most),
                             mv::kPlanThreads, 0, s, sh, ln, rows, cols,
                             key_rows, (int)two, key0, key1);
  if (err != cudaSuccess) return (int)err;
  const mv::SortKeys keys =
      two ? mv::SortKeys{{key0, key1}, {cols, key_rows}, 2}
          : mv::SortKeys{{key0, nullptr}, {key_rows * cols, 0}, 1};
  err = mv::sort_keys(keys, n, static_cast<uint32_t*>(ws), top, lay, s);
  if (err != cudaSuccess) return (int)err;
  void* plan = at<uint32_t>(ws, lay.plan);
  CooRunsArgs a{};
  a.keys = at<uint32_t>(ws, lay.keys);
  a.order = at<int32_t>(plan, lay.order);
  a.key0 = key0;
  a.first = at<int32_t>(plan, lay.first);
  a.end = at<int32_t>(plan, lay.end);
  a.row = at<int32_t>(plan, lay.row);
  a.col = at<int32_t>(plan, lay.longs);
  a.n = n;
  a.cols = cols;
  a.key_rows = key_rows;
  a.two_words = two;
  a.scratch = mv::RunScratch{top, at<uint32_t>(ws, lay.ctl),
                             at<uint32_t>(ws, lay.digits), lay.digit_words(),
                             at<uint32_t>(plan, lay.counts)};
  return (int)mv::launch_dependent(coo_runs_kernel, (unsigned)lay.tiles,
                                   mv::kPlanThreads, 0, s, a);
}

// The walk of a plan over n lanes (at most n runs).
template <typename W>
int coo_walk(const Shards& sh, const W& vw, int64_t rows, int64_t cols,
             const void* plan, int64_t n, cudaStream_t s) {
  int sms = 0;
  const cudaError_t err = mv::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = (n + kWalkThreads - 1) / kWalkThreads;
  const int64_t most = (int64_t)sms * kWalkBlocksPerSM;
  return (int)mv::launch_dependent(
      coo_walk_kernel<W>, (unsigned)(need < most ? need : most),
      kWalkThreads, 0, s, sh, vw, rows, cols,
      coo_plan_at(plan, coo_layout(n)));
}

// -- int32 launches ----------------------------------------------------------

template <int VEC, typename L>
int launch_int(const Shards& sh, L ln, int64_t rows, int64_t cols,
               cudaStream_t s) {
  ln.cut(VEC);
  int sms = 0;
  const cudaError_t err = mv::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = (ln.units + kThreads - 1) / kThreads;
  const int64_t resident = (int64_t)sms * kBlocksPerSM;
  coo_add_int_kernel<VEC, L>
      <<<(unsigned)(need < resident ? need : resident), kThreads, 0, s>>>(
          sh, ln, rows, cols);
  return (int)cudaGetLastError();
}

// The int32 add: 16-byte loads where every lane array allows them.
template <typename L>
int coo_add_int(const Shards& sh, L ln, int64_t rows, int64_t cols,
                cudaStream_t s) {
  if (ln.lanes() <= 0) return (int)cudaSuccess;
  if (kVec == 4 && ln.aligned(16))
    return launch_int<kVec>(sh, ln, rows, cols, s);
  return launch_int<1>(sh, ln, rows, cols, s);
}

GlobalLanes global_lanes(const int32_t* rows, const int32_t* cols,
                         const void* vals, const uint8_t* valid, int64_t n) {
  return GlobalLanes{rows, cols, vals, valid, n, 0};
}

}  // namespace

extern "C" {

// `is_int`: 1 for an int32 table and values (lanes in any order; the
// workspace is not read and may be null), 0 for float32 (the call plans
// its lanes in `workspace` and walks the plan). Lanes whose row lies
// outside [0, nrows) or column outside [0, ncols) add nothing. `valid`
// (nullable): a byte per lane (a bool mask, as the tables' host prep makes
// it); 0 gates the lane off. `workspace`: `ws_words`
// int64 on the card, zero when first used and left by each call as the
// next float32 call on the stream needs it (csrc/row_plan.cuh); at least
// the COO layout for n lanes, or the call fails and nothing launches.
int mv_coo_scatter_add(void* param, int64_t nrows, int64_t ncols,
                       int64_t is_int, const int32_t* rows,
                       const int32_t* cols, const void* vals,
                       const uint8_t* valid, int64_t n, void* workspace,
                       int64_t ws_words, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GlobalLanes ln = global_lanes(rows, cols, vals, valid, n);
  if (is_int) return coo_add_int(mv::one_shard(param), ln, nrows, ncols, s);
  const int err = coo_plan(mv::one_shard(param), ln, nrows, ncols, nrows,
                           workspace, ws_words, s);
  if (err != 0) return err;
  return coo_walk(mv::one_shard(param),
                  GlobalWalk{static_cast<const float*>(vals)}, nrows, ncols,
                  at<uint32_t>(workspace, coo_layout(n).plan), n, s);
}

// The float32 plan alone of n lanes in any order over a table of R rows
// (global ids: a sharded table's rows all together) and C columns, into
// `workspace` as for mv_coo_scatter_add; the mesh form shares it among its
// cards.
int mv_coo_scatter_plan(const int32_t* rows, const int32_t* cols,
                        const uint8_t* valid, int64_t n, int64_t R,
                        int64_t C, void* workspace, int64_t ws_words,
                        void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return coo_plan(Shards{}, global_lanes(rows, cols, nullptr, valid, n), R,
                  C, R, workspace, ws_words,
                  static_cast<cudaStream_t>(stream));
}

// The same over the `count` shards of one card (at most mv::kMaxShards),
// each of `nrows` rows: bases[k] is shard k's row 0, firsts[k] its global
// id; rows are global. Host arrays, copied into the launch. float32: the
// walk of n lanes (values in request order) along the plan that
// mv_coo_scatter_plan left at `plan` (the plan words of its workspace,
// here on this card); rows, cols and valid are not read. int32: `plan`
// is not read.
int mv_coo_scatter_add_mesh(void* const* bases, const int64_t* firsts,
                            int64_t count, int64_t nrows, int64_t ncols,
                            int64_t is_int, const int32_t* rows,
                            const int32_t* cols, const void* vals,
                            const uint8_t* valid, int64_t n,
                            const void* plan, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Shards sh;
  if (!mv::make_shards(sh, bases, firsts, count) ||
      (!is_int && (plan == nullptr || n >= mv::kMaxPlanLanes)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int)
    return coo_add_int(sh, global_lanes(rows, cols, vals, valid, n), nrows,
                       ncols, s);
  return coo_walk(sh, GlobalWalk{static_cast<const float*>(vals)}, nrows,
                  ncols, plan, n, s);
}

// The same over each shard's own lanes (the host-sliced form): shard k's
// lanes[k] lanes (at least 1) are rows[k] (LOCAL row ids), cols[k],
// vals[k] and valid[k] (all null or none). Host arrays of `count`
// entries, copied into the launch. float32: the call plans the launch's
// lanes in `workspace` (as for mv_coo_scatter_add), each segment's rows
// keyed apart, and walks the plan; int32: the workspace is not read.
int mv_coo_scatter_add_shards(void* const* bases, const int64_t* firsts,
                              int64_t count, int64_t nrows, int64_t ncols,
                              int64_t is_int, const int32_t* const* rows,
                              const int32_t* const* cols,
                              const void* const* vals,
                              const uint8_t* const* valid,
                              const int64_t* lanes, void* workspace,
                              int64_t ws_words, void* stream) {
  Shards sh;
  if (!mv::make_shards(sh, bases, firsts, count))
    return (int)cudaErrorInvalidValue;
  ShardLanes ln{};
  for (int64_t k = 0; k < count; ++k) {
    if (lanes[k] < 1 || (valid[k] == nullptr) != (valid[0] == nullptr))
      return (int)cudaErrorInvalidValue;
    ln.rows[k] = rows[k];
    ln.cols[k] = cols[k];
    ln.vals[k] = vals[k];
    ln.valid[k] = valid[k];
    ln.n[k] = lanes[k];
  }
  ln.count = (int)count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int) return coo_add_int(sh, ln, nrows, ncols, s);
  const int err = coo_plan(sh, ln, nrows, ncols, count * nrows, workspace,
                           ws_words, s);
  if (err != 0) return err;
  ShardWalk vw{};
  ln.cut(1);
  for (int k = 0; k < ln.count; ++k) {
    vw.vals[k] = static_cast<const float*>(vals[k]);
    vw.start[k] = ln.ustart[k];
  }
  const int64_t n = ln.lanes();
  return coo_walk(sh, vw, nrows, ncols,
                  at<uint32_t>(workspace, coo_layout(n).plan), n, s);
}

}  // extern "C"
