// The scatter-adds' stable sort, for Hopper (sm_90a): the first half of
// the row scatter's plan (csrc/row_plan.cuh; the table of runs and the
// scatter are in csrc/row_kernels.cu) and of the float32 COO add's
// (csrc/coo_kernels.cu, which keys each lane by its element).
//
// What it replaces: no Pallas kernel. The reference feeds its sequential
// _row_scatter_kernel (multiverso_tpu/ops/table_kernels.py:610) ids sorted
// by XLA, jnp.argsort(ids, stable=True) (:1340 for the flat form, :1264
// for _sharded_row_scatter_add); the port called torch.sort in its place,
// which sorts all 32 bits of each key and returns an int64 permutation.
// Here the ids of a table of R rows are sorted on the bits that R needs,
// ceil(log2(R + 1)) (14 for word2vec's 10,001 rows), by an LSD radix sort
// whose passes are stable, so the permutation is the one a stable sort
// has: equal to torch.sort(ids, stable=True)'s for ids in [0, R). An id
// outside [0, R) takes the key R and lands after every real run.
//
// What bounds it: not bytes (n x 12 bytes a pass: 0.3 MB at 24,576 lanes,
// 0.1 us at 3.35 TB/s) but latency: a kernel a pass after a digit count,
// and inside a pass a chain of look-back reads from tile to tile.
//
// What the design does about it: few passes (at most 8 bits each, as
// evenly split as the key allows: 2 passes of 7 bits at R = 10,001; 3 at
// the sparse-LR gradient's 159,007 rows), one kernel per pass in the
// manner of a single-pass "onesweep" radix sort, and nothing on a pass's
// critical path but its look-back. The digit counts of every pass come
// first, from one kernel, so a pass knows where each digit starts. A
// block takes tile blockIdx.x of kPlanTile lanes (blocks start in index
// order, as a chained scan assumes); each warp ranks its 128 lanes in 4
// rounds of 32, the lanes of one digit found by one ballot a bit (a
// warp's histogram in shared memory, advanced in lane order: stable);
// the warps' histograms give each warp its offset; a thread a digit
// publishes the tile's count and looks back over the earlier tiles' words
// for the count before it (decoupled look-back: a tile that has its
// prefix publishes it, so a look-back stops there); then every lane is
// written to its place. Nothing is atomic in the order: the result is
// deterministic. No kernel waits on a counter of finished blocks: the
// look-back words a pass reads were zeroed one kernel earlier in the same
// call (csrc/row_plan.cuh), and the run scan clears the digit counts.
// Each kernel is a programmatic dependent of the one before it
// (mv::launch_dependent), so the launch gaps between them are hidden.
//
// A key of two words (the COO add's (row, column) where row * C + column
// does not fit 31 bits) is sorted word by word, the low word first, as
// LSD passes are: the digit count counts every pass of both words (a
// lane's digits do not depend on its place), and the high word's first
// pass reads each lane's key through the permutation the low word's
// passes left, so no key wider than 32 bits is ever stored.

#include "row_plan.cuh"
#include "shards.cuh"

namespace {

using mv::kMaxBins;
using mv::kMaxPasses;
using mv::kPlanItems;
using mv::kPlanThreads;
using mv::kPlanTile;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kPlanThreads / 32;
// a sort look-back word: 0 not yet written, else a flag and a count
constexpr uint32_t kFlagA = 1u << 30;  // the tile's own count
constexpr uint32_t kFlagP = 2u << 30;  // the count of this and every
                                       // earlier tile
constexpr uint32_t kCount = kFlagA - 1;

// Where each pass of a sort takes its digit: the key word it sorts on and
// the first bit of that word; d bits a pass.
struct PassPlan {
  int word[kMaxPasses];
  int shift[kMaxPasses];
  int d[kMaxPasses];
  int passes;
};

// The digit counts of every pass, added into digits[pass][digit] (zero
// before the call): a block's counts in shared memory, each warp's equal
// digits added once (digit_peers), then one atomic per digit a block.
// Its blocks also zero the look-back rows of the call's `tiles` in both
// sort sets, for passes 0 and 1.
__global__ void __launch_bounds__(kPlanThreads)
digit_count_kernel(__grid_constant__ const mv::SortKeys k, int64_t n,
                   __grid_constant__ const PassPlan pp,
                   uint32_t* __restrict__ digits, uint32_t* top,
                   int64_t tiles) {
  __shared__ uint32_t hist[kMaxPasses * kMaxBins];
  mv::let_next_start();
  for (int x = threadIdx.x; x < kMaxPasses * kMaxBins; x += kPlanThreads)
    hist[x] = 0;
  mv::wait_prior();
  const int64_t all = (int64_t)gridDim.x * kPlanThreads;
  for (int64_t x = (int64_t)blockIdx.x * kPlanThreads + threadIdx.x;
       x < tiles * 2 * kMaxBins; x += all)
    mv::status_row(top, x / (2 * kMaxBins))[x % (2 * kMaxBins)] = 0;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  // the loop is uniform over each warp: i0 is the warp's first lane
  for (int64_t i0 = (int64_t)blockIdx.x * kPlanThreads + (threadIdx.x & ~31);
       i0 < n; i0 += all) {
    const int64_t i = i0 + lane;
    const bool ok = i < n;
    uint32_t key[mv::kMaxWords];
#pragma unroll
    for (int w = 0; w < mv::kMaxWords; ++w)
      key[w] = ok && w < k.words
                   ? mv::plan_key(k.word[w][i], (uint32_t)k.limit[w])
                   : 0;
    for (int p = 0; p < pp.passes; ++p) {
      const uint32_t word = pp.word[p] == 0 ? key[0] : key[1];
      const uint32_t dig = (word >> pp.shift[p]) & ((1u << pp.d[p]) - 1);
      const unsigned peers = mv::digit_peers(dig, pp.d[p], ok);
      if (peers != 0 && lane == __ffs(peers) - 1)
        atomicAdd(hist + p * kMaxBins + dig, (uint32_t)__popc(peers));
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < pp.passes * kMaxBins; x += kPlanThreads) {
    const uint32_t c = hist[x];
    if (c) atomicAdd(digits + x, c);
  }
}

struct PassArgs {
  const int32_t* ids;       // a word's first pass reads the lanes' words
  const uint32_t* in_keys;  // a later pass of a word: its previous pass's
                            // keys (null in a word's first pass)
  const uint32_t* in_vals;  // a pass after the first: the previous pass's
                            // lanes (a later word's first pass reads its
                            // keys through them)
  uint32_t* out_keys;
  uint32_t* out_vals;
  const uint32_t* digits;  // every pass's counts; this pass's at [pass]
  uint32_t* top;           // the workspace's end: the look-back rows below
  int64_t n;
  uint32_t R;              // the word's limit
  int pass, shift, d;
};

// One stable pass on bits [shift, shift + d) of a key word: tile
// blockIdx.x of kPlanTile lanes a block (see the file's note). It reads
// look-back set pass % 2 and zeroes its tile's row of the other set (the
// previous pass's) for the next pass.
__global__ void __launch_bounds__(kPlanThreads)
sort_pass_kernel(__grid_constant__ const PassArgs a) {
  __shared__ uint32_t hist[kWarps][kMaxBins];
  __shared__ uint32_t base[kMaxBins];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bins = 1 << a.d, shift = a.shift;
  const uint32_t mask = (uint32_t)bins - 1;
  const int64_t t = blockIdx.x;
  uint32_t* row = mv::status_row(a.top, t);
  uint32_t* words = row + (a.pass % 2) * kMaxBins;
  mv::let_next_start();
  for (int x = tid; x < kWarps * kMaxBins; x += kPlanThreads)
    (&hist[0][0])[x] = 0;
  mv::wait_prior();
  if (a.pass > 0) row[((a.pass + 1) % 2) * kMaxBins + tid] = 0;
  // the lanes' loads first, so that they are in flight under the digits'
  // read and the scan
  const int64_t lane0 = t * kPlanTile + (int64_t)warp * 32 * kPlanItems;
  uint32_t key[kPlanItems], val[kPlanItems], rank[kPlanItems];
#pragma unroll
  for (int k = 0; k < kPlanItems; ++k) {
    const int64_t i = lane0 + k * 32 + lane;
    const bool ok = i < a.n;
    val[k] = !ok ? 0u : a.in_vals != nullptr ? a.in_vals[i] : (uint32_t)i;
    key[k] = !ok ? 0u
             : a.in_keys != nullptr ? a.in_keys[i]
                                    : mv::plan_key(a.ids[val[k]], a.R);
  }
  // where each digit starts among all the lanes (synchronises the block)
  uint32_t total;
  const uint32_t mine = tid < bins ? a.digits[a.pass * kMaxBins + tid] : 0;
  const uint32_t dstart = mv::block_exclusive_sum(mine, &total);
#pragma unroll
  for (int k = 0; k < kPlanItems; ++k) {
    const bool ok = lane0 + k * 32 + lane < a.n;
    const uint32_t dig = (key[k] >> shift) & mask;
    const unsigned peers = mv::digit_peers(dig, a.d, ok);
    const int leader = peers != 0 ? __ffs(peers) - 1 : lane;
    uint32_t before = 0;
    if (ok && lane == leader) {  // one lane a digit: no two write a word
      before = hist[warp][dig];
      hist[warp][dig] = before + __popc(peers);
    }
    rank[k] = __shfl_sync(kFull, before, leader) +
              __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
  }
  __syncthreads();
  if (tid < bins) {
    // the warps' exclusive offsets and the tile's count of digit tid
    uint32_t count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = hist[w][tid];
      hist[w][tid] = count;
      count += c;
    }
    mv::store_volatile(words + tid, (t == 0 ? kFlagP : kFlagA) | count);
    const int set = (a.pass % 2) * kMaxBins + tid;
    const uint32_t before = mv::look_back<uint32_t>(
        t, [&](int64_t j) { return mv::status_row(a.top, j) + set; },
        kFlagP, kCount);
    if (t > 0) mv::store_volatile(words + tid, kFlagP | (before + count));
    base[tid] = dstart + before;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPlanItems; ++k) {
    const int64_t i = lane0 + k * 32 + lane;
    if (i < a.n) {
      const uint32_t dig = (key[k] >> shift) & mask;
      const uint32_t pos = base[dig] + hist[warp][dig] + rank[k];
      a.out_keys[pos] = key[k];
      a.out_vals[pos] = val[k];
    }
  }
}

}  // namespace

namespace mv {

cudaError_t sort_keys(const SortKeys& k, int64_t n, uint32_t* ws,
                      uint32_t* top, const PlanLayout& lay, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  if (n >= kMaxPlanLanes || k.words < 1 || k.words > kMaxWords)
    return cudaErrorInvalidValue;
  // each word's bits, as evenly split into passes of at most 8 as they go
  PassPlan pp{};
  for (int w = 0; w < k.words; ++w) {
    if (k.limit[w] < 1 || k.limit[w] > INT32_MAX) return cudaErrorInvalidValue;
    const int bits = 32 - __builtin_clz((uint32_t)k.limit[w]);  // 0..limit
    const int passes = (bits + 7) / 8;
    const int d = (bits + passes - 1) / passes;
    for (int q = 0; q < passes; ++q, ++pp.passes) {
      pp.word[pp.passes] = w;
      pp.shift[pp.passes] = q * d;
      pp.d[pp.passes] = d;
    }
  }
  if (pp.passes * kMaxBins > lay.digit_words()) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  // a warp's 32 lanes a thread's warp, at most 4 blocks an SM
  const int64_t warps = (n + kPlanThreads - 1) / kPlanThreads;
  const int64_t count_blocks =
      warps < 4 * (int64_t)sms ? warps : 4 * (int64_t)sms;
  err = launch_dependent(digit_count_kernel, (unsigned)count_blocks,
                         kPlanThreads, 0, s, k, n, pp, ws + lay.digits, top,
                         lay.tiles);
  if (err != cudaSuccess) return err;
  for (int p = 0; p < pp.passes; ++p) {
    PassArgs a{};
    const bool last = p == pp.passes - 1;
    const bool first_of_word = p == 0 || pp.word[p - 1] != pp.word[p];
    a.ids = k.word[pp.word[p]];
    a.in_keys = first_of_word ? nullptr : ws + lay.tmp_keys[(p - 1) % 2];
    a.in_vals = p == 0 ? nullptr : ws + lay.tmp_vals[(p - 1) % 2];
    a.out_keys = last ? ws + lay.keys : ws + lay.tmp_keys[p % 2];
    a.out_vals = last ? ws + lay.plan + lay.order : ws + lay.tmp_vals[p % 2];
    a.digits = ws + lay.digits;
    a.top = top;
    a.n = n;
    a.R = (uint32_t)k.limit[pp.word[p]];
    a.pass = p;
    a.shift = pp.shift[p];
    a.d = pp.d[p];
    err = launch_dependent(sort_pass_kernel, (unsigned)lay.tiles,
                           kPlanThreads, 0, s, a);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace mv
