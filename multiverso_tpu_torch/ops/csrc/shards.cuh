// The shards of one table that one launch serves, passed to a kernel by
// value (csrc/row_kernels.cu, csrc/coo_kernels.cu, the KV lookup of
// csrc/kv_kernels.cu), the segment lookup of their host-sliced launches,
// and the host helpers the sources size their launches with.
//
// A table split over a mesh's model axis holds equal blocks of `rows` rows;
// shard k's first row has the global id first[k]. A launch serves every
// shard that one card holds (at most kMaxShards; the caller launches a card
// with more in groups): a lane whose global id falls in [first[k],
// first[k] + rows) belongs to shard k, and a lane that falls in no window
// is foreign and adds nothing. A flat table is one shard with first = 0.
// Sorted global ids keep every run of equal ids inside one shard, so a
// launch over several shards gives each shard's rows the flat kernel's
// order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mv {

constexpr int kMaxShards = 16;

struct Shards {
  void* base[kMaxShards];     // each shard's row 0
  int64_t first[kMaxShards];  // its global id
  int count;
};

// Row `id`'s first element, as T*, or nullptr when no shard holds it. The
// loop is unrolled so that every index into the by-value struct is a
// constant (no copy of the parameters to local memory), and leaves at the
// (uniform) count.
template <typename T>
__device__ __forceinline__ T* shard_row(const Shards& sh, int64_t rows,
                                        int64_t width, int64_t id) {
#pragma unroll
  for (int k = 0; k < kMaxShards; ++k) {
    if (k >= sh.count) break;
    const int64_t local = id - sh.first[k];
    if (local >= 0 && local < rows)
      return static_cast<T*>(sh.base[k]) + local * width;
  }
  return nullptr;
}

// The segment of a host-sliced launch that holds launch position u:
// segment k (shard k's real lanes, never empty) starts at start[k], and
// u's segment is the last of the `count` that starts at or before u.
// take(k) runs for segment 0 and for each later one that starts at or
// before u, so its last run names u's segment. The loop is unrolled, so
// k is a constant in each run and no index into a kernel's by-value
// parameters copies them to local memory; it leaves at the (uniform)
// count.
template <typename F>
__device__ __forceinline__ void find_segment(const int64_t* start,
                                             int count, int64_t u,
                                             F&& take) {
  take(0);
#pragma unroll
  for (int k = 1; k < kMaxShards; ++k) {
    if (k >= count) break;
    if (u >= start[k]) take(k);
  }
}

// A table of `count` shards: base pointers and first global ids.
inline bool make_shards(Shards& sh, void* const* bases,
                        const int64_t* firsts, int64_t count) {
  if (count < 1 || count > kMaxShards) return false;
  sh = Shards{};
  for (int64_t k = 0; k < count; ++k) {
    sh.base[k] = bases[k];
    sh.first[k] = firsts[k];
  }
  sh.count = (int)count;
  return true;
}

// A flat table: one shard whose row 0 has the global id 0.
inline Shards one_shard(void* base) {
  Shards sh{};
  sh.base[0] = base;
  sh.first[0] = 0;
  sh.count = 1;
  return sh;
}

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The current device's SM count, read once per device.
inline cudaError_t sm_count(int* sms) {
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

}  // namespace mv
