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
//
// float32 (the sgd updater's sparse Add): float sums depend on their
// order, and the plain version (a stable-sorted index_add_ on the CPU)
// adds each element's terms in sorted lane order. So the lanes come sorted
// by row, and one thread owns each run of a row and adds its lanes in lane
// order: deterministic and equal bit for bit to the plain version, the TPU
// kernel's order too. Long float32 runs are walked by one thread; they
// are not on a hot path.
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
// never launched. A float32 run never crosses a segment, and sorted global
// ids keep every run inside one shard, so each shard's elements receive
// their lanes in the flat kernel's order.

#include <cuda_runtime.h>
#include <stdint.h>

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
// float32: threads a block (a thread a lane)
constexpr int kFloatThreads = 256;

// The lanes of one segment: its arrays, its lane count and the first
// launch unit (kVec lanes, or one) that reads it. `base` is the shard's
// row 0 for LOCAL row ids (the host-sliced form); nullptr when the rows
// are global ids, found among the launch's shards.
struct Segment {
  const int32_t* rows;
  const int32_t* cols;
  const void* vals;
  const int32_t* valid;
  int64_t n, ustart;
  void* base;
};

// The flat and mesh forms: one segment of global row ids.
struct GlobalLanes {
  const int32_t* rows;
  const int32_t* cols;
  const void* vals;
  const int32_t* valid;
  int64_t n, units;
  __device__ __forceinline__ Segment segment(const Shards&, int64_t) const {
    return Segment{rows, cols, vals, valid, n, 0, nullptr};
  }
  int64_t lanes() const { return n; }
  bool aligned(unsigned bytes) const {
    return mv::aligned(rows, bytes) && mv::aligned(cols, bytes) &&
           mv::aligned(vals, bytes) && mv::aligned(valid, bytes);
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
  const int32_t* valid[mv::kMaxShards];
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
                  sh.base[k]};
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
           mv::aligned(vals[k], bytes) && mv::aligned(valid[k], bytes);
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
// a segment's ragged last unit lane by lane.
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
      const int4 ov = s.valid == nullptr
          ? make_int4(1, 1, 1, 1)
          : __ldcs(reinterpret_cast<const int4*>(s.valid + j0));
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

// The float32 kernel: a thread a lane; the first lane of each run of a row
// (within its segment) adds the run's lanes in lane order.
template <typename L>
__global__ void __launch_bounds__(kFloatThreads)
coo_add_float_kernel(__grid_constant__ const Shards sh,
                     __grid_constant__ const L ln, int64_t rows,
                     int64_t cols) {
  const int64_t g = (int64_t)blockIdx.x * kFloatThreads + threadIdx.x;
  if (g >= ln.units) return;
  const Segment s = ln.segment(sh, g);
  const int32_t* __restrict__ ids = s.rows;
  const int64_t i = g - s.ustart;
  const int32_t r = ids[i];
  if (i > 0 && ids[i - 1] == r) return;  // the run's first lane owns it
  float* row = segment_row<float>(sh, s, rows, cols, r);
  if (row == nullptr) return;  // foreign or out of range
  const float* vals = static_cast<const float*>(s.vals);
  for (int64_t j = i; j < s.n && ids[j] == r; ++j) {
    if (s.valid != nullptr && s.valid[j] == 0) continue;
    const int32_t c = s.cols[j];
    if (c < 0 || c >= cols) continue;
    row[c] += vals[j];
  }
}

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

template <typename L>
int coo_add(const Shards& sh, L ln, int64_t rows, int64_t cols,
            int64_t is_int, void* stream) {
  if (ln.lanes() <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int) {
    if (kVec == 4 && ln.aligned(16))
      return launch_int<kVec>(sh, ln, rows, cols, s);
    return launch_int<1>(sh, ln, rows, cols, s);
  }
  ln.cut(1);
  coo_add_float_kernel<L><<<(unsigned)((ln.units + kFloatThreads - 1) /
                                       kFloatThreads),
                            kFloatThreads, 0, s>>>(sh, ln, rows, cols);
  return (int)cudaGetLastError();
}

GlobalLanes global_lanes(const int32_t* rows, const int32_t* cols,
                         const void* vals, const int32_t* valid, int64_t n) {
  return GlobalLanes{rows, cols, vals, valid, n, 0};
}

}  // namespace

extern "C" {

// `is_int`: 0 for a float32 table and values, 1 for int32. Lanes whose
// row lies outside [0, nrows) add nothing. int32 lanes come in any order;
// float32 lanes sorted by row. `valid` (nullable): per lane; 0 gates the
// lane off.
int mv_coo_scatter_add(void* param, int64_t nrows, int64_t ncols,
                       int64_t is_int, const int32_t* rows,
                       const int32_t* cols, const void* vals,
                       const int32_t* valid, int64_t n, void* stream) {
  return coo_add(mv::one_shard(param), global_lanes(rows, cols, vals, valid,
                                                    n),
                 nrows, ncols, is_int, stream);
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
  return coo_add(sh, global_lanes(rows, cols, vals, valid, n), nrows, ncols,
                 is_int, stream);
}

// The same over each shard's own lanes (the host-sliced form): shard k's
// lanes[k] lanes (at least 1) are rows[k] (LOCAL row ids; float32: sorted
// ascending), cols[k], vals[k] and valid[k] (non-null). Host arrays of
// `count` entries, copied into the launch.
int mv_coo_scatter_add_shards(void* const* bases, const int64_t* firsts,
                              int64_t count, int64_t nrows, int64_t ncols,
                              int64_t is_int, const int32_t* const* rows,
                              const int32_t* const* cols,
                              const void* const* vals,
                              const int32_t* const* valid,
                              const int64_t* lanes, void* stream) {
  Shards sh;
  if (!mv::make_shards(sh, bases, firsts, count))
    return (int)cudaErrorInvalidValue;
  ShardLanes ln{};
  for (int64_t k = 0; k < count; ++k) {
    if (lanes[k] < 1 || valid[k] == nullptr)
      return (int)cudaErrorInvalidValue;
    ln.rows[k] = rows[k];
    ln.cols[k] = cols[k];
    ln.vals[k] = vals[k];
    ln.valid[k] = valid[k];
    ln.n[k] = lanes[k];
  }
  ln.count = (int)count;
  return coo_add(sh, ln, nrows, ncols, is_int, stream);
}

}  // extern "C"
