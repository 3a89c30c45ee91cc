// KVTable kernels for Hopper (sm_90a): the lookup, and the fused probe +
// claim + updater apply + write as two launches. Plain C interface, loaded
// with ctypes by ops/_build.py; each entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() of its launch.
//
// Storage (KVTable, one device): keys int32 [B, S, 2], the [hi, lo] uint32
// bit patterns of 64-bit keys, an empty slot holding (-1, -1); values
// [B, S, D] (D = 1 for scalar values) of float32, bfloat16 or float16
// (the kernels are templated on it, kv_updaters.cuh); updater state leaves
// shaped like values, of float32 (the updaters make them so). Query lanes carry
// their [hi, lo] key and their bucket id; deltas come as float32 (a
// 2-byte delta converts exactly).
//
// mv_kv_lookup replaces multiverso_tpu/ops/table_kernels.py build_kv_lookup
// / _kv_lookup_kernel and build_kv_lookup_sharded (:920; the flat kernel
// per shard under shard_map, then jnp.take through `inv`): per lane, match
// the query against its bucket's S key pairs, take sum over slots of
// (match ? v : 0) in slot order from +0 (the reference's where-sum: a
// stored -0.0 comes back +0.0, a NaN in another slot is masked out), write
// `found`, and fill default_value where not found. A lane whose bucket is
// out of range is not found. One launch serves every shard one card holds
// (up to mv::kMaxShards), on the model of mv_row_gather_mesh's host-sliced
// form (row_kernels.cu): caller lane j reads k = inv[j], the flat index
// s * L + pos of the (S, L) lane slices, finds shard s among the launch's
// shards and computes that shard's lane pos into picked[j] / found[j], so
// no (S, L) result buffer and no unpermute remain. A lane of a shard
// outside the launch is foreign: zero bits on a card's first launch, left
// as it is on a later one (a second card's partial is OR-merged by the
// wrapper). The flat lookup is one segment with no `inv`: lane j is lane j.
// One thread per (lane, column); what bounds it is bytes: per lane its
// operands, and its bucket's key row of S slots and S x D values, read at
// random.
//
// mv_kv_probe + mv_kv_commit replace build_kv_probe_update /
// _kv_probe_kernel (_probe_lane, _apply_write) and the sharded pair
// build_kv_probe_update_sharded's _kv_probe_only_kernel /
// _kv_commit_kernel: the TPU walked the bucket-sorted lanes twice in one
// sequential grid (pass 0 probe, pass 1 write if nothing overflowed), one
// grid per shard. Here the two passes are two launches on one stream, with
// the overflow count left on the device between them, and each pair of
// launches serves every shard of one card (up to mv::kMaxShards): shard
// k's real lanes are segment k of the launch, in arrays of its own with
// LOCAL bucket ids (mv::find_segment, shards.cuh), its keys, values and
// state leaves its own base pointers. A flat table is one segment.
//
// - mv_kv_probe: a group of kLaneThreads threads per lane. Lanes come
//   sorted by bucket, and within a bucket the valid lanes come first, in
//   batch order (the host prep sorts them stably and parks the padding
//   lanes at the end, on the last bucket). Each group loads its lane's
//   operands and its neighbours' bucket and valid at once; the group of a
//   run's head walks the run in lane order, the others leave. For each
//   lane the group reads the PRE-batch key row once, in chunks of kChunk
//   slots, each thread its share with 8-byte loads issued together (a
//   row of 16 slots is one chunk); a chunk's match and empty masks come
//   from that one load, OR-ed over the group by __shfl_xor_sync. A lane
//   takes its first matching slot, else the (claims+1)-th empty slot of
//   the row, `claims` the run's new keys placed so far; a new key past
//   the row's empties overflows. slot == S marks a lane that writes
//   nothing. Overflowing lanes (every lane of an out-of-range bucket too)
//   are summed over the warp and added to *n_over with one atomic. A
//   padding lane (valid == 0) writes its own slot = S: it never claims
//   and never counts; no group walks the padding, and the sharded wrapper
//   launches only each shard's real lanes. Fewer threads a lane keep
//   more lanes in flight, and a lane waits on two round trips (its
//   operands, then its row): ops/kv_sweep.py measured 4 threads a lane
//   fastest at 16 slots (with 2), 16 threads twice as slow.
// - mv_kv_commit: a group of T threads (the power of two at or above
//   min(D, 32)) per lane, thread c taking columns c, c + T, ... (shifts,
//   no divide), the gate loaded with the lane's slot and bucket. If
//   *gate == 0 and the lane has a slot, it writes the key (thread 0),
//   reads the old value and state, applies the updater (kv_updaters.cuh)
//   and writes them back. Any overflow leaves every shard untouched (the
//   reference's all-or-nothing): the gate is the card's count, or the sum
//   of every card's. Writes never conflict: a batch holds distinct keys
//   and new keys claim distinct slots. A table replicated over a mesh's
//   data axis (R replicas) hands the commit each shard's R copies by
//   value: the lane writes its key and value to every copy, and its state
//   to every copy or, under shard_update (each replica holding a block of
//   nb / R buckets of the shard's state), to the block that owns its
//   bucket; no slot the batch does not touch is written, and the probe
//   reads replica 0's keys (every replica's are the same).
// - The overflow count is zeroed by the wrapper, one fill a card (about
//   0.001 ms on the card): a probe that zeroed it itself would race with
//   its own blocks' adds unless a grid-wide step came between them.
//
// What bounds them (PERF.md): the commit, the random 32-byte sectors of
// the value and state leaves it reads and writes, one a lane and a leaf
// (about 0.017 ms a leaf at the sparse-LR step's 159,000 real lanes, S
// 16, D 2, on an H100), which no thread mapping removes; the probe, the
// round trips a lane waits on over the lanes in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_updaters.cuh"
#include "shards.cuh"

namespace {

constexpr int kThreads = 256;
// The probe reads a key row in chunks of kChunk slots, kLaneThreads
// threads a lane, each holding kChunk / kLaneThreads slots of a chunk
// (ops/kv_sweep.py times the choices on the sparse-LR step's lanes).
constexpr int kChunk = 16;
constexpr int kLaneThreads = 4;

// The lanes of one lookup launch, its shards' keys in an mv::Shards table
// (base: the shard's [nb, S, 2] keys; first: its first GLOBAL bucket,
// s * nb). `inv` null: lane j is lane j of query[0] / buckets[0].
struct LookupLanes {
  const void* values[mv::kMaxShards];      // the shard's [nb, S, D] of V
  const int32_t* query[mv::kMaxShards];    // its row of the queries, [L, 2]
  const int32_t* buckets[mv::kMaxShards];  // its row of LOCAL bucket ids
  const int32_t* inv;
  int64_t L;
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
kv_lookup_shards_kernel(__grid_constant__ const mv::Shards sh,
                        __grid_constant__ const LookupLanes ln, int64_t nb,
                        int S, int D, int64_t n, float default_value,
                        int zero_foreign, V* __restrict__ picked,
                        uint8_t* __restrict__ found) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * D) return;
  const int64_t lane = idx / D;
  const int c = (int)(idx - lane * D);
  // the lane's shard of the launch and its position in that shard's lane
  // row; a __grid_constant__ parameter is indexed by `shard` in place
  int shard = 0;
  int64_t pos = lane;
  if (ln.inv != nullptr) {
    const unsigned k = __ldg(ln.inv + lane);  // below 2^31: 32-bit division
    const int64_t s = k / (unsigned)ln.L;
    pos = k - s * ln.L;
    shard = -1;
#pragma unroll
    for (int i = 0; i < mv::kMaxShards; ++i) {
      if (i >= sh.count) break;
      if (sh.first[i] == s * nb) shard = i;
    }
    if (shard < 0) {                    // foreign: another launch's shard
      if (zero_foreign) {
        kv::Elem<V>::store(picked + idx, 0.0f);
        if (c == 0) found[lane] = 0;
      }
      return;
    }
  }
  const int32_t* keys = static_cast<const int32_t*>(sh.base[shard]);
  const V* values = static_cast<const V*>(ln.values[shard]);
  const int32_t* query = ln.query[shard];
  const int32_t* buckets = ln.buckets[shard];
  const int32_t b = buckets[pos];
  const int32_t qh = query[2 * pos], ql = query[2 * pos + 1];
  float acc = 0.0f;
  bool hit = false;
  if (b >= 0 && b < nb) {
    // slot by slot through stepped pointers: with the index multiplied out
    // per slot the multiplies stayed in the loop (SASS: half again its
    // instructions, and slower on an H100)
    const int32_t* row = keys + (int64_t)b * S * 2;
    const V* vals = values + (int64_t)b * S * D + c;
    for (int s = 0; s < S; ++s, row += 2, vals += D) {
      const bool m = row[0] == qh && row[1] == ql;
      acc = __fadd_rn(acc, m ? kv::Elem<V>::load(vals) : 0.0f);
      hit = hit || m;
    }
  }
  // one slot at most matches, so the float32 sum is that value exactly
  kv::Elem<V>::store(picked + idx, hit ? acc : default_value);
  if (c == 0) found[lane] = hit ? 1 : 0;
}

// The lanes of one probe launch: segment k is shard k's n[k] real lanes,
// launch lanes [start[k], start[k] + n[k]); slot[start[k] + i] is lane i's.
struct ProbeLanes {
  const int32_t* keys[mv::kMaxShards];      // the shard's [nb, S, 2]
  const int32_t* buckets[mv::kMaxShards];   // LOCAL bucket ids
  const int32_t* query[mv::kMaxShards];     // [n, 2]
  const uint8_t* valid[mv::kMaxShards];
  int64_t start[mv::kMaxShards];
  int64_t n[mv::kMaxShards];
  int32_t* slot;
  int64_t lanes;
  int count;
};

// The lanes of one commit launch, segments as in ProbeLanes. A table held
// in R replicas gives each segment k R copies: copy r * count + k is
// replica r's shard k (keys and values), and of the state either replica
// r's whole shard (q == nb) or, under shard_update, its block r of the
// shard, buckets [r * q, (r + 1) * q) (q = nb / R). R * count is at most
// mv::kMaxShards.
struct CommitLanes {
  int32_t* keys[mv::kMaxShards];
  void* values[mv::kMaxShards];             // of V
  float* st_a[mv::kMaxShards];              // nullptr: no such leaf
  float* st_b[mv::kMaxShards];
  const int32_t* buckets[mv::kMaxShards];
  const int32_t* query[mv::kMaxShards];
  const float* deltas[mv::kMaxShards];      // [n, D]
  int64_t start[mv::kMaxShards];
  const int32_t* slot;
  int64_t lanes;
  int64_t q;                                // buckets of a state copy
  int count;
  int replicas;
};

// The segment (shard) of launch lane u.
struct ProbeSegment {
  const int32_t* keys;
  const int32_t* buckets;
  const int32_t* query;
  const uint8_t* valid;
  int32_t* slot;
  int64_t i, n;          // u's lane in the segment, the segment's lanes
};

__device__ __forceinline__ ProbeSegment probe_segment(const ProbeLanes& ln,
                                                      int64_t u) {
  ProbeSegment g;
  mv::find_segment(ln.start, ln.count, u, [&](int k) {
    g = ProbeSegment{ln.keys[k], ln.buckets[k], ln.query[k], ln.valid[k],
                     ln.slot + ln.start[k], u - ln.start[k], ln.n[k]};
  });
  return g;
}

// Slot s of a key row as (hi, lo), one 8-byte load.
__device__ __forceinline__ int2 key_at(const int32_t* row, int s) {
  return __ldg(reinterpret_cast<const int2*>(row) + s);
}

// Lane j's query key as (hi, lo), one 8-byte load.
__device__ __forceinline__ int2 query_at(const ProbeSegment& g, int64_t j) {
  return __ldg(reinterpret_cast<const int2*>(g.query) + j);
}

// Whether lane j belongs to the run of bucket b (j inside the segment).
__device__ __forceinline__ bool in_run(const ProbeSegment& g, int64_t j,
                                       int32_t b) {
  return j < g.n && __ldg(g.buckets + j) == b && __ldg(g.valid + j) != 0;
}

// One chunk of kChunk slots of a key row as a group of G threads holds
// it: thread t the V = kChunk / G slots from t * V on, loaded together.
template <int G>
struct Chunk {
  static constexpr int V = kChunk / G;
  int2 k[V];
  int live;        // the chunk's slots inside the row

  __device__ __forceinline__ void load(const int32_t* row, int c0, int S,
                                       int t) {
    live = S - c0 < kChunk ? S - c0 : kChunk;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int s = t * V + v;
      k[v] = s < live ? key_at(row, c0 + s) : make_int2(0, 0);
    }
  }

  // The chunk's slots (bit s for slot c0 + s) whose key is (x, y), in
  // every thread of the group: each thread's V bits, OR-ed over the group.
  __device__ __forceinline__ unsigned mask(int x, int y, int t,
                                           unsigned gmask) const {
    unsigned m = 0;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (t * V + v < live && k[v].x == x && k[v].y == y)
        m |= 1u << (t * V + v);
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      m |= __shfl_xor_sync(gmask, m, off);
    return m;
  }
};

// The position of the n-th (from 0) set bit of m; m holds more than n.
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// The probe of the run that starts at lane g.i, its bucket b inside the
// table, by a group of G threads (thread t of the group, `gmask` the
// group's bits in the warp). `q` is the head's query and `next` whether
// lane g.i + 1 is in the run, both loaded with the head's other operands:
// a run of one lane (the common case) costs one round trip for its
// operands and one for its row (a lane after the head reads the row
// again, from L1). Returns the run's overflowing lanes (the same in every
// thread of the group).
template <int G>
__device__ __forceinline__ int probe_run(const ProbeSegment& g, int32_t b,
                                         int2 q, bool next, int S, int t,
                                         unsigned gmask) {
  const int32_t* row = g.keys + (int64_t)b * S * 2;
  int claims = 0, over = 0;
  for (int64_t j = g.i;; ++j) {
    // one pass over the row's chunks: the first match wins, else the
    // (claims+1)-th empty slot, `seen` the empties of the chunks before
    int sl = -1;
    bool matched = false;
    for (int c0 = 0, seen = 0; c0 < S && !matched; c0 += kChunk) {
      Chunk<G> c;
      c.load(row, c0, S, t);
      const unsigned m = c.mask(q.x, q.y, t, gmask);
      if (m != 0) {
        matched = true;
        sl = c0 + __ffs(m) - 1;
      } else if (sl < 0) {
        const unsigned e = c.mask(-1, -1, t, gmask);
        if (claims < seen + __popc(e)) sl = c0 + nth_set(e, claims - seen);
        seen += __popc(e);
      }
    }
    if (!matched) {
      if (sl >= 0) {
        ++claims;
      } else {
        sl = S;
        ++over;
      }
    }
    if (t == 0) g.slot[j] = sl;
    if (!next) break;
    q = query_at(g, j + 1);
    next = in_run(g, j + 2, b);
  }
  return over;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
kv_probe_kernel(__grid_constant__ const ProbeLanes ln, int64_t nb, int S,
                int32_t* __restrict__ n_over) {
  static_assert(G >= 1 && G <= kChunk && kChunk % G == 0 && kChunk <= 32,
                "a group's threads split a chunk of a row evenly");
  const int64_t u =
      (int64_t)(((uint64_t)blockIdx.x * kThreads + threadIdx.x) / G);
  const int t = threadIdx.x % G;
  const unsigned gmask = (G == 32 ? 0xffffffffu : (1u << G) - 1u)
                         << ((threadIdx.x % 32) & ~(G - 1));
  int over = 0;                         // the group's, kept by thread 0
  if (u < ln.lanes) {
    const ProbeSegment g = probe_segment(ln, u);
    const int64_t i = g.i;
    // the lane's operands, its neighbours' bucket and valid, at once
    const int64_t prev = i > 0 ? i - 1 : i;
    const int64_t after = i + 1 < g.n ? i + 1 : i;
    const bool valid = __ldg(g.valid + i) != 0;
    const int32_t b = __ldg(g.buckets + i);
    const int2 q = query_at(g, i);
    const int32_t bp = __ldg(g.buckets + prev);
    const int32_t bn = __ldg(g.buckets + after);
    const bool vp = __ldg(g.valid + prev) != 0;
    const bool vn = __ldg(g.valid + after) != 0;
    const bool head = i == 0 || bp != b || !vp;
    const bool next = after != i && bn == b && vn;
    if (!valid) {                       // padding: drops, never counts
      if (t == 0) g.slot[i] = S;
    } else if (head) {
      int run_over = 0;
      if (b >= 0 && b < nb) {
        run_over = probe_run<G>(g, b, q, next, S, t, gmask);
      } else {                          // out of range: every lane overflows
        for (int64_t j = i; in_run(g, j, b); ++j) {
          if (t == 0) g.slot[j] = S;
          ++run_over;
        }
      }
      if (t == 0) over = run_over;
    }
  }
  over = __reduce_add_sync(0xffffffffu, over);
  if (threadIdx.x % 32 == 0 && over != 0) atomicAdd(n_over, over);
}

template <typename V, int T>
__global__ void __launch_bounds__(kThreads)
kv_commit_kernel(__grid_constant__ const CommitLanes ln, int64_t nb, int S,
                 int D, const int32_t* __restrict__ gate, int code,
                 kv::Scalars k) {
  const int64_t u =
      (int64_t)(((uint64_t)blockIdx.x * kThreads + threadIdx.x) / T);
  const int c0 = threadIdx.x % T;
  if (u >= ln.lanes) return;
  // the gate comes with the lane's slot and bucket, in one round trip
  const int32_t closed = *gate;
  const int s = ln.slot[u];
  int64_t j = 0;                                // u's lane in its segment
  int seg = 0;
  const int32_t* bk = nullptr;
  const int32_t* query = nullptr;
  const float* deltas = nullptr;
  mv::find_segment(ln.start, ln.count, u, [&](int kk) {
    j = u - ln.start[kk];
    seg = kk;
    bk = ln.buckets[kk];
    query = ln.query[kk];
    deltas = ln.deltas[kk];
  });
  const int32_t b = bk[j];
  if (closed != 0) return;                      // all or nothing
  if (s < 0 || s >= S || b < 0 || b >= nb) return;
  const int64_t cell = (int64_t)b * S + s;
  // the state copy that holds bucket b: every replica's (the first is
  // read), or under shard_update the one block that owns it
  const int owner = ln.q == nb ? 0 : (int)(b / ln.q);
  const int64_t scell = (int64_t)(b - owner * ln.q) * S + s;
  const int sc = owner * ln.count + seg;
  const float* st_a = ln.st_a[sc];
  const float* st_b = ln.st_b[sc];
  const V* value0 = static_cast<const V*>(ln.values[seg]);
  if (c0 == 0) {
    const int2 key = reinterpret_cast<const int2*>(query)[j];
    for (int r = 0; r < ln.replicas; ++r)
      reinterpret_cast<int2*>(ln.keys[r * ln.count + seg])[cell] = key;
  }
  for (int c = c0; c < D; c += T) {
    const int64_t off = cell * D + c, soff = scell * D + c;
    float p = kv::Elem<V>::load(value0 + off);
    float a = st_a != nullptr ? st_a[soff] : 0.0f;
    float bb = st_b != nullptr ? st_b[soff] : 0.0f;
    kv::apply<V>(code, k, deltas[j * D + c], p, a, bb);
    for (int r = 0; r < ln.replicas; ++r)
      kv::Elem<V>::store(static_cast<V*>(ln.values[r * ln.count + seg]) + off,
                         p);
    // the state: the owning block only, or every replica's copy
    const int r0 = ln.q == nb ? 0 : owner;
    const int r1 = ln.q == nb ? ln.replicas : owner + 1;
    for (int r = r0; r < r1; ++r) {
      const int cp = r * ln.count + seg;
      if (st_a != nullptr) ln.st_a[cp][soff] = a;
      if (st_b != nullptr) ln.st_b[cp][soff] = bb;
    }
  }
}

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The element types of values and state leaves (ops/table_kernels.py
// KV_DTYPES): 0 float32, 1 bfloat16, 2 float16.
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// The lookup over the `count` shards of one card (at most mv::kMaxShards),
// each of nb buckets of S slots and D value columns of type `vtype`:
// keys[k] ([nb, S, 2]) and values[k] ([nb, S, D]) are shard k's, firsts[k]
// its first GLOBAL bucket; host arrays, copied into the launch. `inv` null:
// query[0] ([n, 2]) and buckets[0] ([n], LOCAL ids) are the n lanes, of
// shard 0 (the flat lookup). Otherwise caller lane j is lane pos of the
// shard m whose first bucket is s * nb, for inv[j] = s * L + pos
// (query[m], buckets[m]: that shard's row of the (S, L) lane slices).
// Writes picked [n, D] (of vtype) and found [n] (bool bytes); a lane no
// shard of the launch holds gets zero bits when zero_foreign is 1 and
// keeps them when 0.
int mv_kv_lookup(void* const* keys, const int64_t* firsts, int64_t count,
                 int64_t nb, int64_t S, int64_t D, int64_t vtype,
                 const void* const* values, const int32_t* const* query,
                 const int32_t* const* buckets, const int32_t* inv,
                 int64_t L, int64_t zero_foreign, int64_t n,
                 float default_value, void* picked, uint8_t* found,
                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  mv::Shards sh;
  if (!mv::make_shards(sh, keys, firsts, count) || S < 1 || D < 1 ||
      (inv != nullptr && L <= 0) || vtype < kF32 || vtype > kF16)
    return (int)cudaErrorInvalidValue;
  LookupLanes ln{};
  for (int64_t k = 0; k < count; ++k) {
    ln.values[k] = values[k];
    ln.query[k] = query[k];
    ln.buckets[k] = buckets[k];
  }
  ln.inv = inv;
  ln.L = L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n * D);
  const int zf = zero_foreign != 0;
  if (vtype == kF32) {
    kv_lookup_shards_kernel<float><<<blocks, kThreads, 0, st>>>(
        sh, ln, nb, (int)S, (int)D, n, default_value, zf,
        static_cast<float*>(picked), found);
  } else if (vtype == kBF16) {
    kv_lookup_shards_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        sh, ln, nb, (int)S, (int)D, n, default_value, zf,
        static_cast<__nv_bfloat16*>(picked), found);
  } else {
    kv_lookup_shards_kernel<__half><<<blocks, kThreads, 0, st>>>(
        sh, ln, nb, (int)S, (int)D, n, default_value, zf,
        static_cast<__half*>(picked), found);
  }
  return (int)cudaGetLastError();
}

// Pass 0 over the `count` shards of one card (at most mv::kMaxShards),
// each of nb buckets of S slots: shard k's lanes[k] lanes (at least 1) are
// buckets[k] (LOCAL ids, sorted, valid lanes first in each bucket),
// query[k] ([n, 2]) and valid[k] against keys[k]. Writes slot (the launch's
// lanes, shard after shard; S = dropped) and adds the overflowing valid
// lanes to *n_over, which the caller zeroes. Host arrays of `count`
// entries, copied into the launch.
int mv_kv_probe(const int32_t* const* keys, int64_t count, int64_t nb,
                int64_t S, const int32_t* const* buckets,
                const int32_t* const* query, const uint8_t* const* valid,
                const int64_t* lanes, int32_t* slot, int32_t* n_over,
                void* stream) {
  if (count < 1 || count > mv::kMaxShards || S < 1)
    return (int)cudaErrorInvalidValue;
  ProbeLanes ln{};
  for (int64_t k = 0; k < count; ++k) {
    if (lanes[k] < 1 || !mv::aligned(keys[k], 8) ||
        !mv::aligned(query[k], 8))
      return (int)cudaErrorInvalidValue;
    ln.keys[k] = keys[k];
    ln.buckets[k] = buckets[k];
    ln.query[k] = query[k];
    ln.valid[k] = valid[k];
    ln.start[k] = ln.lanes;
    ln.n[k] = lanes[k];
    ln.lanes += lanes[k];
  }
  ln.slot = slot;
  ln.count = (int)count;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kv_probe_kernel<kLaneThreads>
      <<<blocks_for(ln.lanes * kLaneThreads), kThreads, 0, st>>>(
          ln, nb, (int)S, n_over);
  return (int)cudaGetLastError();
}

}  // extern "C"

namespace {

// The commit at value type V, its group width T from D.
template <typename V>
void launch_commit(const CommitLanes& ln, int64_t nb, int S, int D,
                   const int32_t* gate, int code, const kv::Scalars& k,
                   cudaStream_t st) {
  const int t = D > 16 ? 32 : D > 8 ? 16 : D > 4 ? 8 : D > 2 ? 4 : D;
  const unsigned blocks = blocks_for(ln.lanes * t);
  switch (t) {
    case 1:
      kv_commit_kernel<V, 1><<<blocks, kThreads, 0, st>>>(
          ln, nb, S, D, gate, code, k);
      break;
    case 2:
      kv_commit_kernel<V, 2><<<blocks, kThreads, 0, st>>>(
          ln, nb, S, D, gate, code, k);
      break;
    case 4:
      kv_commit_kernel<V, 4><<<blocks, kThreads, 0, st>>>(
          ln, nb, S, D, gate, code, k);
      break;
    case 8:
      kv_commit_kernel<V, 8><<<blocks, kThreads, 0, st>>>(
          ln, nb, S, D, gate, code, k);
      break;
    case 16:
      kv_commit_kernel<V, 16><<<blocks, kThreads, 0, st>>>(
          ln, nb, S, D, gate, code, k);
      break;
    default:
      kv_commit_kernel<V, 32><<<blocks, kThreads, 0, st>>>(
          ln, nb, S, D, gate, code, k);
      break;
  }
}

}  // namespace

extern "C" {

// Pass 1 over the same shards and lanes: if *gate == 0, write each slotted
// lane's key and apply updater `code` to its value and state, in place, on
// each of the `replicas` copies of the table. keys, values, st_a and st_b
// hold replicas * count pointers, copy r * count + k being replica r's of
// shard k (st_a, st_b: null when the updater has no such leaf). A state
// copy is replica r's whole shard (q == nb; the first is read, every one
// written) or, under shard_update, its block of q = nb / replicas buckets
// from r * q (only the block that owns a lane's bucket is read and
// written). Values are of `vtype`, state leaves float32; deltas[k] is
// float32 [lanes[k], D].
int mv_kv_commit(int32_t* const* keys, void* const* values,
                 float* const* st_a, float* const* st_b, int64_t count,
                 int64_t replicas, int64_t nb, int64_t S, int64_t D,
                 int64_t q, int64_t vtype,
                 const int32_t* const* buckets, const int32_t* const* query,
                 const float* const* deltas, const int64_t* lanes,
                 const int32_t* slot, const int32_t* gate, int64_t code,
                 float s0, float s1, float s2, float s3, float s4, float s5,
                 float s6, float s7, void* stream) {
  if (count < 1 || replicas < 1 || count * replicas > mv::kMaxShards ||
      D < 1 || vtype < kF32 || vtype > kF16 || q < 1 ||
      (q != nb && q * replicas != nb))
    return (int)cudaErrorInvalidValue;
  CommitLanes ln{};
  for (int64_t k = 0; k < count; ++k) {
    if (lanes[k] < 1 || !mv::aligned(query[k], 8))
      return (int)cudaErrorInvalidValue;
    ln.buckets[k] = buckets[k];
    ln.query[k] = query[k];
    ln.deltas[k] = deltas[k];
    ln.start[k] = ln.lanes;
    ln.lanes += lanes[k];
  }
  for (int64_t c = 0; c < count * replicas; ++c) {
    if (!mv::aligned(keys[c], 8)) return (int)cudaErrorInvalidValue;
    ln.keys[c] = keys[c];
    ln.values[c] = values[c];
    ln.st_a[c] = st_a != nullptr ? st_a[c] : nullptr;
    ln.st_b[c] = st_b != nullptr ? st_b[c] : nullptr;
  }
  ln.slot = slot;
  ln.q = q;
  ln.count = (int)count;
  ln.replicas = (int)replicas;
  const kv::Scalars k = {{s0, s1, s2, s3, s4, s5, s6, s7}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vtype == kF32)
    launch_commit<float>(ln, nb, (int)S, (int)D, gate, (int)code, k, st);
  else if (vtype == kBF16)
    launch_commit<__nv_bfloat16>(ln, nb, (int)S, (int)D, gate, (int)code, k,
                                 st);
  else
    launch_commit<__half>(ln, nb, (int)S, (int)D, gate, (int)code, k, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
