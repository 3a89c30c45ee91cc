// KVTable kernels for Hopper (sm_90a): the lookup, and the fused probe +
// claim + updater apply + write as two launches. Plain C interface, loaded
// with ctypes by ops/_build.py; each entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() of its launch.
//
// Storage (KVTable, one device): keys int32 [B, S, 2], the [hi, lo] uint32
// bit patterns of 64-bit keys, an empty slot holding (-1, -1); values
// float32 [B, S, D] (D = 1 for scalar values); updater state leaves like
// values. Query lanes carry their [hi, lo] key and their bucket id.
//
// mv_kv_lookup replaces multiverso_tpu/ops/table_kernels.py build_kv_lookup
// / _kv_lookup_kernel: per lane, match the query against its bucket's S key
// pairs, take sum over slots of (match ? v : 0) in slot order from +0 (the
// reference's where-sum: a stored -0.0 comes back +0.0, a NaN in another
// slot is masked out), write `found`, and fill default_value where not
// found. A lane whose bucket is out of range is not found.
//
// mv_kv_probe + mv_kv_commit replace build_kv_probe_update /
// _kv_probe_kernel (_probe_lane, _apply_write): the TPU walked the
// bucket-sorted lanes twice in one sequential grid (pass 0 probe, pass 1
// write if nothing overflowed). Here the two passes are two launches on
// one stream, with the overflow count left on the device between them, as
// the sharded pair _kv_probe_only_kernel / _kv_commit_kernel splits them.
//
// - mv_kv_probe: one thread per run of valid lanes with equal bucket ids.
//   Lanes come sorted by bucket, and within a bucket the valid lanes come
//   first, in batch order (the host prep sorts them stably and parks the
//   padding lanes at the end, on the last bucket). Walking its run in lane
//   order, the thread gives each lane its matching slot, else the
//   (claims+1)-th empty slot of the PRE-batch row, where `claims` counts
//   the run's new keys placed so far; a new key past the row's empties
//   overflows. slot[i] == S marks a lane that writes nothing. Overflowing
//   lanes (and lanes of an out-of-range bucket) are added to *n_over with
//   one atomic per run. A padding lane (valid == 0) writes its own
//   slot = S: it never claims and never counts, and no thread walks the
//   padding, which at the sparse-LR step is 103,144 lanes of one bucket.
// - mv_kv_commit: one thread per (lane, value column). If *n_over == 0 and
//   the lane has a slot, it writes the key (column 0), reads the old value
//   and state, applies the updater (kv_updaters.cuh) and writes them back.
//   Any overflow leaves the table untouched (the reference's
//   all-or-nothing). Writes never conflict: a batch holds distinct keys and
//   new keys claim distinct slots.
//
// What bounds them: bytes, and at the sparse-LR step's widths (2^18 lanes,
// S 16, D 2) the launch latency. The lookup reads per lane one 128-byte key
// row and the S x D values; the probe reads the key row of each lane's
// bucket (mostly one lane per bucket: 159k keys into 2M buckets); the
// commit touches one slot per lane. A run is walked by one thread: runs
// are short (at most S lanes of a run can match or claim), so no shared
// memory or cross-thread scan is needed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_updaters.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool is_empty(const int32_t* key) {
  return key[0] == -1 && key[1] == -1;
}

__global__ void __launch_bounds__(kThreads)
kv_lookup_kernel(const int32_t* __restrict__ keys,
                 const float* __restrict__ values, int64_t nb, int S, int D,
                 const int32_t* __restrict__ query,
                 const int32_t* __restrict__ buckets, int64_t n,
                 float default_value, float* __restrict__ picked,
                 uint8_t* __restrict__ found) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * D) return;
  const int64_t lane = idx / D;
  const int c = (int)(idx - lane * D);
  const int32_t b = buckets[lane];
  const int32_t qh = query[2 * lane], ql = query[2 * lane + 1];
  float acc = 0.0f;
  bool hit = false;
  if (b >= 0 && b < nb) {
    const int32_t* row = keys + (int64_t)b * S * 2;
    const float* vals = values + (int64_t)b * S * D + c;
    for (int s = 0; s < S; ++s) {
      const bool m = row[2 * s] == qh && row[2 * s + 1] == ql;
      acc = __fadd_rn(acc, m ? vals[(int64_t)s * D] : 0.0f);
      hit = hit || m;
    }
  }
  picked[idx] = hit ? acc : default_value;
  if (c == 0) found[lane] = hit ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
kv_probe_kernel(const int32_t* __restrict__ keys, int64_t nb, int S,
                const int32_t* __restrict__ buckets,
                const int32_t* __restrict__ query,
                const uint8_t* __restrict__ valid, int64_t n,
                int32_t* __restrict__ slot, int32_t* __restrict__ n_over) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {                              // padding: drops, never counts
    slot[i] = S;
    return;
  }
  const int32_t b = buckets[i];
  if (i > 0 && buckets[i - 1] == b && valid[i - 1]) return;  // not the head
  const bool in_range = b >= 0 && b < nb;
  const int32_t* row = keys + (in_range ? (int64_t)b * S * 2 : 0);
  int claims = 0, over = 0;
  for (int64_t j = i; j < n && buckets[j] == b && valid[j]; ++j) {
    int sl = S;
    if (!in_range) {
      ++over;
    } else {
      const int32_t qh = query[2 * j], ql = query[2 * j + 1];
      int match = -1, claim = -1, empties = 0;
      for (int s = 0; s < S; ++s) {
        const int32_t* key = row + 2 * s;
        if (match < 0 && key[0] == qh && key[1] == ql) match = s;
        if (is_empty(key)) {
          if (empties == claims && claim < 0) claim = s;
          ++empties;
        }
      }
      if (match >= 0) {
        sl = match;
      } else if (claim >= 0) {
        sl = claim;
        ++claims;
      } else {
        ++over;
      }
    }
    slot[j] = sl;
  }
  if (over) atomicAdd(n_over, over);
}

__global__ void __launch_bounds__(kThreads)
kv_commit_kernel(int32_t* __restrict__ keys, float* __restrict__ values,
                 float* __restrict__ st_a, float* __restrict__ st_b,
                 int64_t nb, int S, int D,
                 const int32_t* __restrict__ buckets,
                 const int32_t* __restrict__ query,
                 const float* __restrict__ deltas,
                 const int32_t* __restrict__ slot,
                 const int32_t* __restrict__ n_over, int64_t n, int code,
                 kv::Scalars k) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * D) return;
  if (*n_over != 0) return;                     // all or nothing
  const int64_t lane = idx / D;
  const int c = (int)(idx - lane * D);
  const int s = slot[lane];
  const int32_t b = buckets[lane];
  if (s < 0 || s >= S || b < 0 || b >= nb) return;
  const int64_t cell = (int64_t)b * S + s;
  if (c == 0) {
    keys[2 * cell] = query[2 * lane];
    keys[2 * cell + 1] = query[2 * lane + 1];
  }
  const int64_t off = cell * D + c;
  float p = values[off];
  float a = st_a != nullptr ? st_a[off] : 0.0f;
  float bb = st_b != nullptr ? st_b[off] : 0.0f;
  kv::apply(code, k, deltas[idx], p, a, bb);
  values[off] = p;
  if (st_a != nullptr) st_a[off] = a;
  if (st_b != nullptr) st_b[off] = bb;
}

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// (keys [nb, S, 2], values [nb, S, D], query [n, 2], buckets [n]) ->
// picked [n, D], found [n] (bool bytes).
int mv_kv_lookup(const int32_t* keys, const float* values, int64_t nb,
                 int64_t S, int64_t D, const int32_t* query,
                 const int32_t* buckets, int64_t n, float default_value,
                 float* picked, uint8_t* found, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  kv_lookup_kernel<<<blocks_for(n * D), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, values, nb, (int)S, (int)D, query, buckets, n, default_value,
      picked, found);
  return (int)cudaGetLastError();
}

// Pass 0: slot [n] (S = dropped) and *n_over += overflowing valid lanes.
// *n_over must be zeroed by the caller.
int mv_kv_probe(const int32_t* keys, int64_t nb, int64_t S,
                const int32_t* buckets, const int32_t* query,
                const uint8_t* valid, int64_t n, int32_t* slot,
                int32_t* n_over, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  kv_probe_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      keys, nb, (int)S, buckets, query, valid, n, slot, n_over);
  return (int)cudaGetLastError();
}

// Pass 1: if *n_over == 0, write each slotted lane's key and apply updater
// `code` to its value and state (st_a, st_b nullable), in place.
int mv_kv_commit(int32_t* keys, float* values, float* st_a, float* st_b,
                 int64_t nb, int64_t S, int64_t D, const int32_t* buckets,
                 const int32_t* query, const float* deltas,
                 const int32_t* slot, const int32_t* n_over, int64_t n,
                 int64_t code, float s0, float s1, float s2, float s3,
                 float s4, float s5, float s6, float s7, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const kv::Scalars k = {{s0, s1, s2, s3, s4, s5, s6, s7}};
  kv_commit_kernel<<<blocks_for(n * D), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, values, st_a, st_b, nb, (int)S, (int)D, buckets, query, deltas,
      slot, n_over, n, (int)code, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
