// The row scatter-add's plan: the workspace layout that csrc/row_plan.cu
// (the stable sort of a call's lanes by row) and csrc/row_kernels.cu (the
// table of runs, and the scatter that walks it) share, and the block-wide
// helpers both use. ops/table_kernels.py mirrors the layout
// (plan_layout) to size the workspace; the C entry points refuse one that
// is too small.
//
// A workspace for n lanes, in 32-bit words. At its base,
//   ctl[16]     the run scan's finished-block counter (0 between calls)
//   digits[kMaxPasses * kMaxBins]  each pass's digit counts (0 between
//               calls: the run scan clears them)
// and at its top, counted down from its last word, a row of kStatusWords
// look-back words for each tile of kPlanTile lanes: two sets of kMaxBins
// for the sort passes (pass p uses set p % 2), then the run scan's one
// 64-bit word. A call zeroes the sort words it is about to use one kernel
// ahead (the digit count clears both sets' rows, pass p the set that pass
// p - 1 used), so it reads none that an earlier call left behind, however
// many tiles that call had; the run scan's last block zeroes the words it
// used. After the digits, the plan (what the scatter reads; the mesh form
// copies it whole to another card), its offsets taken from its own start:
//   counts[4]   the number of runs and of long runs (more than kSplit lanes)
//   order[n]    the stable permutation: sorted lane j is request lane
//               order[j] (ids outside [0, R) after every real run)
//   first[n]    run k's first sorted lane, end[n] one past its last,
//   row[n]      its row (a global id)
//   longs[n / (kSplit + 1) + 1]  the long runs' indices, in run order
// then the sort's keys[n], and two key and two lane buffers of n between
// passes. Every region but the look-back rows starts on a multiple of 4
// words (16 bytes); each row's 64-bit word on a multiple of 2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace mv {

// A plan kernel's block: kPlanThreads threads, kPlanItems lanes each (a
// sort pass's scattered stores from one SM bound a tile: 1,024 lanes
// spread 24,576 over 24 SMs).
constexpr int kPlanThreads = 256;
constexpr int kPlanItems = 4;
constexpr int64_t kPlanTile = (int64_t)kPlanThreads * kPlanItems;
// A sort pass takes at most 8 bits of the key; a key of up to 32 bits
// takes at most 4 passes.
constexpr int kMaxBins = 256;
constexpr int kMaxPasses = 4;
// Look-back words keep a count in 30 bits (the sort) or 31 (the runs).
constexpr int64_t kMaxPlanLanes = (int64_t)1 << 30;
// the ctl word of the run scan's finished blocks
constexpr int kRunsDone = 0;

// a tile's look-back words: two sets for the sort passes, then the run
// scan's
constexpr int64_t kStatusWords = 2 * kMaxBins + 4;
constexpr int64_t kRunsWord = 2 * kMaxBins;

inline int64_t round4(int64_t words) { return (words + 3) & ~(int64_t)3; }

struct PlanLayout {
  // from the workspace's base; `words`: all a workspace needs, the
  // look-back rows included
  int64_t ctl, digits, plan, keys, tmp_keys[2], tmp_vals[2], words, tiles;
  // from the plan's start
  int64_t counts, order, first, end, row, longs, plan_words;
  PlanLayout(int64_t n, int64_t split) {
    const int64_t m = round4(n);
    tiles = (n + kPlanTile - 1) / kPlanTile;
    ctl = 0;
    digits = 16;
    plan = digits + kMaxPasses * kMaxBins;
    counts = 0;
    order = 4;
    first = order + m;
    end = first + m;
    row = end + m;
    longs = row + m;
    plan_words = longs + round4(n / (split + 1) + 1);
    keys = plan + plan_words;
    tmp_keys[0] = keys + m;
    tmp_keys[1] = tmp_keys[0] + m;
    tmp_vals[0] = tmp_keys[1] + m;
    tmp_vals[1] = tmp_vals[0] + m;
    words = tmp_vals[1] + m + tiles * kStatusWords;
  }
};

// Tile t's row of look-back words in a workspace whose last word is
// top[-1].
__host__ __device__ __forceinline__ uint32_t* status_row(uint32_t* top,
                                                         int64_t t) {
  return top - (t + 1) * kStatusWords;
}

// The lanes of the calling warp whose `d`-bit digit equals this lane's,
// among the lanes where `ok` holds (0 where it does not): one ballot a
// bit, where __match_any_sync takes several times as long.
__device__ __forceinline__ unsigned digit_peers(uint32_t dig, int d,
                                                bool ok) {
  unsigned peers = __ballot_sync(0xffffffffu, ok);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b >= d) break;
    const bool set = (dig >> b) & 1u;
    const unsigned m = __ballot_sync(0xffffffffu, set);
    peers &= set ? m : ~m;
  }
  return ok ? peers : 0u;
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

__device__ __forceinline__ uint64_t load_volatile(const uint64_t* p) {
  return *reinterpret_cast<const volatile uint64_t*>(p);
}

template <typename W>
__device__ __forceinline__ void store_volatile(W* p, W v) {
  *reinterpret_cast<volatile W*>(p) = v;
}

// Look-back words of a tile read at once.
constexpr int kLookBack = 8;

// The count of tiles [0, t), by decoupled look-back over their words
// (word(j): tile j's; 0 until written, then `flag_p` set if it holds the
// count of tiles [0, j], else tile j's own count, under `counts`): the
// words of kLookBack tiles below are read at once, added from the nearest
// down to the first that holds a prefix, and a window that meets a word
// not yet written is read again from there.
template <typename W, typename F>
__device__ __forceinline__ W look_back(int64_t t, F word, W flag_p,
                                       W counts) {
  W before = 0;
  int64_t j = t - 1;
  while (j >= 0) {
    W s[kLookBack];
#pragma unroll
    for (int q = 0; q < kLookBack; ++q)
      s[q] = j - q >= 0 ? load_volatile(word(j - q)) : flag_p;
    int q = 0;
    for (; q < kLookBack; ++q) {
      if (s[q] == 0) break;
      before += s[q] & counts;
      if (s[q] & flag_p) return before;
    }
    j -= q;
  }
  return before;
}

// Programmatic dependent launch (Hopper): a kernel of the row scatter's
// call is launched so that its blocks may start while the kernel before
// it on the stream finishes (that kernel lets them, let_next_start, as
// soon as its own blocks run). A block then does what touches no global
// memory, and waits (wait_prior) until the kernel before has finished and
// its writes are visible before it reads or writes any: the launch gap
// between the call's kernels is hidden, and the order is kept.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned grid,
                             unsigned block, size_t smem, cudaStream_t s,
                             Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// The sort's key of a lane: its id, or R for an id outside [0, R).
__device__ __forceinline__ uint32_t plan_key(int32_t id, uint32_t R) {
  return id >= 0 && (uint32_t)id < R ? (uint32_t)id : R;
}

// The exclusive sum of v over the block's kPlanThreads threads in thread
// order, and (in *total) the block's sum. Every thread calls it; it
// synchronises the block.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v,
                                                        uint32_t* total) {
  constexpr int kWarps = kPlanThreads / 32;
  __shared__ uint32_t warp_sums[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = warp_sums[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();  // warp_sums is free for the next call
  *total = all;
  return before + x - v;
}

// The stable sort by row of a plan: the lanes' keys (plan_key of ids[i]
// against R) sorted to keys[], their lanes to order[], in the workspace
// `ws` (its last word top[-1]) laid out for n lanes (split: the scatter's
// kSplit). One digit count kernel, then one kernel a pass. R in
// [1, 2^31), n in [1, kMaxPlanLanes).
cudaError_t sort_rows(const int32_t* ids, int64_t n, int64_t R,
                      uint32_t* ws, uint32_t* top, const PlanLayout& lay,
                      cudaStream_t s);

}  // namespace mv
