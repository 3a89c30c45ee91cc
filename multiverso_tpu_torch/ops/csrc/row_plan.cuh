// The plans of the scatter-adds: the workspace layout that csrc/row_plan.cu
// (the stable LSD radix sort of a call's lanes by key), csrc/row_kernels.cu
// (the row scatter's table of runs, and the scatter that walks it) and
// csrc/coo_kernels.cu (the float32 COO add's table of element runs, and its
// walk) share, and the block-wide helpers they use. ops/table_kernels.py
// mirrors the layout (plan_layout) to size the workspace; the C entry
// points refuse one that is too small.
//
// A workspace for n lanes, in 32-bit words. At its base,
//   ctl[16]     the run scan's finished-block counter (0 between calls)
//   digits[passes * kMaxBins]  each pass's digit counts (0 between calls:
//               the run scan clears them); `passes` is kWordPasses for
//               the row scatter's one-word keys, kMaxPasses for the COO
//               add's keys of up to two words
// and at its top, counted down from its last word, a row of kStatusWords
// look-back words for each tile of kPlanTile lanes: two sets of kMaxBins
// for the sort passes (pass p uses set p % 2), then the run scan's one
// 64-bit word. A call zeroes the sort words it is about to use one kernel
// ahead (the digit count clears both sets' rows, pass p the set that pass
// p - 1 used), so it reads none that an earlier call left behind, however
// many tiles that call had; the run scan's last block zeroes the words it
// used. After the digits, the plan (what the scatter reads; the mesh forms
// copy it whole to another card), its offsets taken from its own start:
//   counts[4]   the number of runs and of long runs (more than kSplit lanes)
//   order[n]    the stable permutation: sorted lane j is request lane
//               order[j] (lanes that add nothing after every real run)
//   first[n]    run k's first sorted lane, end[n] one past its last,
//   row[n]      its row (a global id)
//   longs[n / (split + 1) + 1]  the long runs' indices, in run order; the
//               COO plan (split 0) keeps each run's column here
// then the sort's keys[n], two key and two lane buffers of n between
// passes, and `key_words` arrays of n lane keys (the COO add's keys, made
// before the sort). Every region but the look-back rows starts on a
// multiple of 4 words (16 bytes); each row's 64-bit word on a multiple of
// 2. The row scatter and the COO add keep a workspace each: their plans
// lie differently over the words below the look-back rows.

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
// A sort pass takes at most 8 bits of a key word; a word of up to 32 bits
// takes at most kWordPasses passes, a key of up to kMaxWords words at most
// kMaxPasses.
constexpr int kMaxBins = 256;
constexpr int kWordPasses = 4;
constexpr int kMaxWords = 2;
constexpr int kMaxPasses = kWordPasses * kMaxWords;
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
  int64_t ctl, digits, plan, keys, tmp_keys[2], tmp_vals[2], lane_keys,
      words, tiles;
  // from the plan's start
  int64_t counts, order, first, end, row, longs, plan_words;
  // n lanes; split: the scatter's kSplit (0: the COO plan); passes: the
  // digit rows; key_words: the lane-key arrays
  PlanLayout(int64_t n, int64_t split, int passes = kWordPasses,
             int key_words = 0) {
    const int64_t m = round4(n);
    tiles = (n + kPlanTile - 1) / kPlanTile;
    ctl = 0;
    digits = 16;
    plan = digits + passes * kMaxBins;
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
    lane_keys = tmp_vals[1] + m;
    words = lane_keys + key_words * m + tiles * kStatusWords;
  }
  int64_t digit_words() const { return plan - digits; }
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

// A sort's key: up to kMaxWords words, word[0] the least significant.
// Lane l's word w is plan_key(word[w][l], limit[w]): a value in [0,
// limit[w]), or limit[w] for any other (so that a lane keyed limit[w] in
// its last word sorts after every real lane). limit[w] in [1, 2^31).
struct SortKeys {
  const int32_t* word[kMaxWords];
  int64_t limit[kMaxWords];
  int words;
};

// The stable LSD radix sort of n lanes by key: the last word's keys
// sorted to keys[], their lanes to order[], in the workspace `ws` (its last
// word top[-1]) laid out as `lay`. One digit count kernel, then one kernel
// a pass: each word's passes in turn from word 0, each over at most 8 of
// that word's bits; the first pass of a later word reads its keys through
// the permutation the earlier words left. n in [1, kMaxPlanLanes).
cudaError_t sort_keys(const SortKeys& k, int64_t n, uint32_t* ws,
                      uint32_t* top, const PlanLayout& lay, cudaStream_t s);

// A run scan's look-back word: a flag (bits 62-63), the runs (bits
// 31-61) and the long runs (bits 0-30) of one tile or of every tile up
// to it; 0 until written.
constexpr uint64_t kRunsA = 1ull << 62, kRunsP = 2ull << 62;
constexpr uint64_t kRunsCounts = kRunsA - 1;
constexpr int kLongBits = 31;
constexpr uint64_t kLongMask = (1ull << kLongBits) - 1;

// A run scan's scratch: tile t's look-back word (after the sort's sets in
// its row, status_row), the finished-block counter, the digit counts it
// clears for the next call, and the plan's counts[] it writes.
struct RunScratch {
  uint32_t* top;
  uint32_t* ctl;
  uint32_t* digits;
  int64_t digit_words;
  uint32_t* counts;
  __device__ __forceinline__ uint64_t* word(int64_t t) const {
    return reinterpret_cast<uint64_t*>(status_row(top, t) + kRunsWord);
  }
};

// The number of the first run and of the first long run that this
// thread's lanes start, in lane order, given the counts of each it starts
// (`starts`, `longs`; at most kPlanTile a tile): an exclusive sum over
// the block, and over the earlier tiles a look-back as in a sort pass
// (tile blockIdx.x a block; blocks start in index order). The last tile
// writes the totals to counts[0] and counts[1]; block 0 zeroes the digit
// counts. Every thread of the block calls it.
struct RunNumbers {
  int64_t run, lng;
};

__device__ __forceinline__ RunNumbers number_runs(const RunScratch& rs,
                                                  unsigned starts,
                                                  unsigned longs) {
  __shared__ uint64_t s_before;
  const int64_t t = blockIdx.x;
  if (t == 0)
    for (int64_t x = threadIdx.x; x < rs.digit_words; x += kPlanThreads)
      rs.digits[x] = 0;
  // runs in the high half, long runs in the low: at most kPlanTile each
  uint32_t total;
  const uint32_t mine = block_exclusive_sum(starts << 16 | longs, &total);
  if (threadIdx.x == 0) {
    const uint64_t count =
        (uint64_t)(total >> 16) << kLongBits | (total & 0xffffu);
    store_volatile(rs.word(t), (t == 0 ? kRunsP : kRunsA) | count);
    const uint64_t before = look_back<uint64_t>(
        t, [&](int64_t j) { return rs.word(j); }, kRunsP, kRunsCounts);
    if (t > 0) store_volatile(rs.word(t), kRunsP | (before + count));
    if (t == gridDim.x - 1) {
      rs.counts[0] = (uint32_t)((before + count) >> kLongBits);
      rs.counts[1] = (uint32_t)((before + count) & kLongMask);
    }
    s_before = before;
  }
  __syncthreads();
  return RunNumbers{(int64_t)(s_before >> kLongBits) + (mine >> 16),
                    (int64_t)(s_before & kLongMask) + (mine & 0xffffu)};
}

// A run scan's end: every look-back read of this block returned before
// its count goes in, so the last block to finish zeroes the look-back
// words and the counter for the next call. Every thread calls it.
__device__ __forceinline__ void finish_runs(const RunScratch& rs) {
  __shared__ int s_last;
  if (threadIdx.x == 0)
    s_last = atomicAdd(rs.ctl + kRunsDone, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) {
    for (int64_t x = threadIdx.x; x < gridDim.x; x += kPlanThreads)
      *rs.word(x) = 0;
    if (threadIdx.x == 0) rs.ctl[kRunsDone] = 0;
  }
}

}  // namespace mv
