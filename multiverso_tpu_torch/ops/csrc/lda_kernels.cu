// LightLDA's collapsed-Gibbs sampler kernels for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by ops/_build.py; every entry point
// launches on the caller's stream, allocates nothing and returns the CUDA
// error of its launch.
//
// mv_gibbs_tiled replaces multiverso_tpu/ops/lda_sampler.py
// gibbs_sample_tiled / _kernel: for each token of a batch, the collapsed
// posterior over K = C*128 topics from its gathered doc-count row A and
// word-count row W, with its own count removed, then the two-level
// inverse-CDF draw (lda_draw.cuh). Padded tokens (msk 0) keep their topic
// and add nothing. Also returns nkd[K], the summary-count delta
// sum(onehot(znew) - onehot(zi)) over real tokens.
//
// mv_gibbs_docblock replaces gibbs_sample_docblock / _docblock_kernel and,
// with ndk null, gibbs_sample_docblock_build / _docblock_build_kernel. One
// block per doc block of tb tokens, which owns the [maxd, K] doc counts of
// its whole documents. Read mode loads them from ndk[block]; build mode
// builds them from (drel, zi) of the block's real tokens. Every token
// draws against the counts as they were at block start (the TPU kernel's
// E @ ndk), and only after all draws are the -1/+1 moves applied and the
// rows written back in ndk's type (read mode). A token whose doc row lies
// outside [0, maxd) draws against a zero row and moves nkd only, as the
// TPU kernel's one-hot products do. Given words, it reads each token's
// word row from the bf16 mirror itself: no gathered [B, K] buffer.
//
// What bounds them: bytes, and for the doc-blocked kernel reading a Zipf
// word stream from the mirror, the instruction issue. Per token the
// kernel reads a K-wide word-count row (2 KB of bf16 at K = 1024) and, for
// the tiled kernel, a doc-count row; it does about 7 float operations per
// topic, far below the card's float32 rate. A production step (512,000
// tokens, K = 1024) reads 1.05 GB of gathered W rows; read from the
// mirror, a Zipf-1.1 stream's rows are mostly cache hits and the gathered
// and mirror forms take the same time: the instructions a warp issues per
// token bound it, more of them outside the posterior than in it.
//
// What the tiled kernel's design does about it: one warp per token, 4
// topics per lane per 128-topic chunk, so a warp's loads of a chunk are
// contiguous; the chosen chunk is read a second time (from L1/L2) instead
// of keeping K posteriors in registers. The doc-blocked kernel (redesigned
// for Hopper): a block keeps its doc counts in shared memory (int32 for
// int32 ndk, else float32: 64 KB at maxd 16, K 1024), read as one 16-byte
// load a lane per chunk, conflict-free, with a zero row for tokens outside
// the block's docs; it stages the block's token vectors once. At K = 1024
// it is templated on C: a warp takes a run of the block's tokens and
// issues each token's whole row (C 8-byte loads a lane) during the draw of
// the token before, keeps sinv and the token's C x 4 posteriors in
// registers, sets the token's own topic in the one lane that holds it,
// and draws with lda::draw_regs (9 + 8 shuffles for the chunk sums, not
// 40; the chosen chunk not re-read). ops/docblock_sweep.py times the
// constants of namespace db. The TPU carried nkd across its sequential
// grid; Hopper blocks run in no order, so each block sums its moves in
// shared memory and adds the nonzero ones to nkd (zeroed by the wrapper)
// with integer atomics, exact in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lda_draw.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / lda::kWarp;
constexpr int kTokensPerBlock = 64;     // tiled kernel: tokens per block

template <typename TA, typename TW>
__global__ void __launch_bounds__(kThreads)
gibbs_tiled_kernel(const TA* __restrict__ A, const TW* __restrict__ W,
                   const float* __restrict__ sinv,
                   const int32_t* __restrict__ zi,
                   const int32_t* __restrict__ msk,
                   const float* __restrict__ u1,
                   const float* __restrict__ u2, int64_t b, int C,
                   float alpha, float beta, int32_t* __restrict__ znew,
                   int32_t* __restrict__ nkd) {
  extern __shared__ int32_t s_nkd[];            // [K]
  const int K = C * lda::kLanes;
  const int warp = threadIdx.x / lda::kWarp;
  const int lane = threadIdx.x % lda::kWarp;
  for (int k = threadIdx.x; k < K; k += kThreads) s_nkd[k] = 0;
  __syncthreads();
  const int64_t first = (int64_t)blockIdx.x * kTokensPerBlock;
  const int64_t last = first + kTokensPerBlock < b ? first + kTokensPerBlock
                                                   : b;
  for (int64_t t = first + warp; t < last; t += kWarps) {
    const int32_t z = zi[t];
    int32_t zn = z;
    if (msk[t] > 0) {
      const TA* a = A + t * K;
      const TW* w = W + t * K;
      auto post = [&](int c, float (&p)[lda::kPer]) {
        const int k0 = c * lda::kLanes + lane * lda::kPer;
#pragma unroll
        for (int j = 0; j < lda::kPer; ++j) {
          const int k = k0 + j;
          p[j] = lda::posterior(lda::to_float(a[k]), lda::to_float(w[k]),
                                k == z ? 1.0f : 0.0f, sinv[k], alpha, beta);
        }
      };
      zn = lda::draw(post, C, u1[t], u2[t]);
    }
    if (lane == 0) {
      znew[t] = zn;
      if (zn != z) {
        atomicAdd(&s_nkd[zn], 1);
        if (z >= 0 && z < K) atomicAdd(&s_nkd[z], -1);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads)
    if (s_nkd[k] != 0) atomicAdd(nkd + k, s_nkd[k]);
}

// -- the doc-blocked kernel -------------------------------------------------

namespace db {

// Tuning constants (python -m multiverso_tpu_torch.ops.docblock_sweep
// rebuilds this file with each one changed and times the variants).
constexpr int kWarps = 8;          // warps a block
constexpr int kMinBlocks = 2;      // blocks an SM the register cap allows
constexpr int kOverlap = 1;        // 1: a token's row loads fly during the
                                   // draw of the token before
constexpr int kFloatCounts = 1;    // 0: 16-bit doc counts packed in smem
constexpr int kFastC = 8;          // the register path's chunks (K = 1024)
constexpr int kThreads = kWarps * lda::kWarp;

// The doc counts a block holds in shared memory. int32 ndk: int32. int16
// ndk and build mode: float32, so the draw reads each count as a float
// with no conversion; counts are integers far below 2^24, so float adds
// of +-1 are exact in any order and the write-back's int conversion gives
// the int16 sum (kFloatCounts 0 keeps them as 16-bit pairs instead: the
// ndk type, uint16 in build mode, where a count never exceeds the block's
// tokens, which shared memory keeps below 2^16).
template <typename TN, bool kBuild>
using Count = std::conditional_t<
    sizeof(TN) == 4 && !kBuild, int32_t,
    std::conditional_t<kFloatCounts != 0, float,
                       std::conditional_t<kBuild, uint16_t, TN>>>;

// One lane's 4 topics of a chunk of a word row, as one vector load.
template <typename TW>
using RowVec = std::conditional_t<sizeof(TW) == 2, uint2, uint4>;

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shared memory: counts [maxd + 1, K] (row maxd stays zero: the doc row
// of a token whose drel lies outside the block), tokens {zi, drel, msk,
// row} [tb], uniforms [tb], the nkd delta [K], the new topics [tb].
__host__ __device__ constexpr size_t smem_bytes(size_t count_bytes, int tb,
                                                int maxd, int K) {
  return round16((size_t)(maxd + 1) * K * count_bytes) + (size_t)tb * 16 +
         (size_t)tb * 8 + (size_t)K * 4 + (size_t)tb * 4;
}

__device__ __forceinline__ void unpack(uint2 v, float (&x)[lda::kPer]) {
  x[0] = __uint_as_float(v.x << 16);            // bf16 is float's top half
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void unpack(uint4 v, float (&x)[lda::kPer]) {
  x[0] = __int2float_rn((int)v.x);
  x[1] = __int2float_rn((int)v.y);
  x[2] = __int2float_rn((int)v.z);
  x[3] = __int2float_rn((int)v.w);
}

// 4 int16 as floats
__device__ __forceinline__ void int16x4(uint2 v, float (&x)[lda::kPer]) {
  x[0] = __int2float_rn((int)(int16_t)(v.x & 0xffffu));
  x[1] = __int2float_rn((int)v.x >> 16);
  x[2] = __int2float_rn((int)(int16_t)(v.y & 0xffffu));
  x[3] = __int2float_rn((int)v.y >> 16);
}

// 4 consecutive counts (8- or 16-byte aligned) as floats, one load.
__device__ __forceinline__ void counts4(const int16_t* c,
                                        float (&x)[lda::kPer]) {
  int16x4(*reinterpret_cast<const uint2*>(c), x);
}
__device__ __forceinline__ void counts4(const uint16_t* c,
                                        float (&x)[lda::kPer]) {
  const uint2 v = *reinterpret_cast<const uint2*>(c);
  x[0] = __int2float_rn((int)(v.x & 0xffffu));
  x[1] = __int2float_rn((int)(v.x >> 16));
  x[2] = __int2float_rn((int)(v.y & 0xffffu));
  x[3] = __int2float_rn((int)(v.y >> 16));
}
__device__ __forceinline__ void counts4(const int32_t* c,
                                        float (&x)[lda::kPer]) {
  const int4 v = *reinterpret_cast<const int4*>(c);
  x[0] = __int2float_rn(v.x);
  x[1] = __int2float_rn(v.y);
  x[2] = __int2float_rn(v.z);
  x[3] = __int2float_rn(v.w);
}
__device__ __forceinline__ void counts4(const float* c,
                                        float (&x)[lda::kPer]) {
  const float4 v = *reinterpret_cast<const float4*>(c);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}

__device__ __forceinline__ float count(float x) { return x; }
template <typename T>
__device__ __forceinline__ float count(T x) { return lda::to_float(x); }

// count[i] += d. A float count is an exact integer. A 16-bit count is
// half of a 32-bit word: a CAS loop adds modulo 2^16 (as the plain
// version's cast back to int16 does), so no borrow reaches the other half
// whatever the counts are.
__device__ __forceinline__ void add_count(int32_t* c, int i, int d) {
  atomicAdd(c + i, d);
}
__device__ __forceinline__ void add_count(float* c, int i, int d) {
  atomicAdd(c + i, (float)d);
}
template <typename T16>
__device__ __forceinline__ void add_count(T16* c, int i, int d) {
  unsigned* word = reinterpret_cast<unsigned*>(c) + (i >> 1);
  const int sh = (i & 1) * 16;
  unsigned old = *word, seen;
  do {
    seen = old;
    const unsigned half = ((seen >> sh) + (unsigned)d) & 0xffffu;
    old = atomicCAS(word, seen, (seen & ~(0xffffu << sh)) | (half << sh));
  } while (old != seen);
}

}  // namespace db

// kC: the chunk count when it is db::kFastC (the register path), 0 for
// any other (the generic path, through lda::draw). words: null reads W
// as gathered rows [nb*tb, K] (token t's row t); else W is the mirror
// [V, K] and token t reads row words[t] (a zero row outside [0, V)).
template <typename TN, typename TW, bool kBuild, int kC>
__global__ void __launch_bounds__(db::kThreads,
                                  sizeof(TW) == 2 ? db::kMinBlocks : 1)
gibbs_docblock_kernel(TN* __restrict__ ndk, const TW* __restrict__ W,
                      const int32_t* __restrict__ words, int64_t V,
                      const float* __restrict__ sinv,
                      const int32_t* __restrict__ zi,
                      const int32_t* __restrict__ drel,
                      const int32_t* __restrict__ msk,
                      const float* __restrict__ u1,
                      const float* __restrict__ u2, int tb, int maxd, int C,
                      float alpha, float beta, int32_t* __restrict__ znew,
                      int32_t* __restrict__ nkd) {
  using TS = db::Count<TN, kBuild>;
  using Vec = db::RowVec<TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = (kC ? kC : C) * lda::kLanes;
  const int cells = maxd * K;
  TS* s_cnt = reinterpret_cast<TS*>(smem);
  int4* s_tok = reinterpret_cast<int4*>(
      smem + db::round16((size_t)(cells + K) * sizeof(TS)));
  float2* s_u = reinterpret_cast<float2*>(s_tok + tb);
  int32_t* s_nkd = reinterpret_cast<int32_t*>(s_u + tb);
  int32_t* s_z = s_nkd + K;
  const int warp = threadIdx.x / lda::kWarp;
  const int lane = threadIdx.x % lda::kWarp;
  const int64_t t0 = (int64_t)blockIdx.x * tb;
  TN* blk = kBuild ? nullptr : ndk + (int64_t)blockIdx.x * cells;

  // the block's tokens, once; row -1: a word outside the mirror
  for (int i = threadIdx.x; i < tb; i += db::kThreads) {
    const int64_t t = t0 + i;
    int32_t row = i;
    if (words != nullptr) {
      row = words[t];
      if (row < 0 || row >= V) row = -1;
    }
    s_tok[i] = make_int4(zi[t], drel[t], msk[t], row);
    s_u[i] = make_float2(u1[t], u2[t]);
  }
  // build mode: every count 0; read mode: the zero row, then ndk[block]
  const int zeros = kBuild ? cells + K : K;
  uint4* zero = reinterpret_cast<uint4*>(s_cnt + cells + K - zeros);
  for (int x = threadIdx.x; x < zeros * (int)sizeof(TS) / 16;
       x += db::kThreads)
    zero[x] = make_uint4(0, 0, 0, 0);
  if constexpr (!kBuild && std::is_same_v<TS, TN>) {
    const uint4* g = reinterpret_cast<const uint4*>(blk);
    uint4* c = reinterpret_cast<uint4*>(s_cnt);
    for (int x = threadIdx.x; x < cells * (int)sizeof(TS) / 16;
         x += db::kThreads)
      c[x] = g[x];
  } else if constexpr (!kBuild) {           // int16 -> float, 8 at a time
    const uint4* g = reinterpret_cast<const uint4*>(blk);
    float4* c = reinterpret_cast<float4*>(s_cnt);
    for (int x = threadIdx.x; x < cells / 8; x += db::kThreads) {
      const uint4 v = g[x];
      float a[lda::kPer], b[lda::kPer];
      db::int16x4(make_uint2(v.x, v.y), a);
      db::int16x4(make_uint2(v.z, v.w), b);
      c[2 * x] = make_float4(a[0], a[1], a[2], a[3]);
      c[2 * x + 1] = make_float4(b[0], b[1], b[2], b[3]);
    }
  }
  for (int k = threadIdx.x; k < K; k += db::kThreads) s_nkd[k] = 0;
  __syncthreads();
  if constexpr (kBuild) {
    for (int i = threadIdx.x; i < tb; i += db::kThreads) {
      const int4 tok = s_tok[i];
      if (tok.z > 0 && tok.y >= 0 && tok.y < maxd && tok.x >= 0 &&
          tok.x < K)
        db::add_count(s_cnt, tok.y * K + tok.x, 1);
    }
    __syncthreads();
  }

  // every token draws against the block-start counts; a warp takes a
  // contiguous run of the block's tokens
  const int per = (tb + db::kWarps - 1) / db::kWarps;
  const int i0 = min(warp * per, tb);
  const int n = min(tb, i0 + per) - i0;
  auto row_of = [&](const int4& tok, int i) -> const TW* {
    if (words == nullptr) return W + (t0 + i) * K;
    return tok.w < 0 ? nullptr : W + (int64_t)tok.w * K;
  };
  auto finish = [&](int i, int zn) {
    if (lane == 0) {
      znew[t0 + i] = zn;
      s_z[i] = zn;
    }
  };
  if constexpr (kC > 0) {
    // the register path: this lane's sinv in registers; a token's whole
    // word row (C vector loads a lane) in flight at once; its C x 4
    // posteriors kept for level 2
    float sv[kC][lda::kPer];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(
          sinv + c * lda::kLanes + lda::kPer * lane));
      sv[c][0] = x.x, sv[c][1] = x.y, sv[c][2] = x.z, sv[c][3] = x.w;
    }
    Vec buf[kC];
    auto fetch = [&](int i) {
      const int4 tok = s_tok[i];
      if (tok.z <= 0) return;               // a masked token reads no row
      const TW* row = row_of(tok, i);
      const Vec* v = reinterpret_cast<const Vec*>(row + lda::kPer * lane);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        buf[c] = row == nullptr ? Vec{}
                                : __ldg(v + c * (lda::kLanes / lda::kPer));
    };
    if (n > 0) fetch(i0);
    for (int i = i0; i < i0 + n; ++i) {
      const int4 tok = s_tok[i];
      const int z = tok.x, r = tok.y;
      const bool more = i + 1 < i0 + n;
      int zn = z;
      if (tok.z > 0) {
        const bool rin = r >= 0 && r < maxd;  // else the zero doc row
        const TS* arow = s_cnt + (rin ? r : maxd) * K;
        // the token's own topic: its posterior with own 1, set in the
        // one lane that holds it
        const bool own = z >= 0 && z < K &&
                         lane == (z / lda::kPer) % lda::kWarp;
        float p_own = 0.0f;
        if (z >= 0 && z < K) {
          const TW* row = row_of(tok, i);
          p_own = lda::posterior(
              db::count(arow[z]),
              row == nullptr ? 0.0f : lda::to_float(__ldg(row + z)), 1.0f,
              __ldg(sinv + z), alpha, beta);
        }
        float p[kC][lda::kPer];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          float a[lda::kPer], w[lda::kPer];
          db::counts4(arow + c * lda::kLanes + lda::kPer * lane, a);
          db::unpack(buf[c], w);
#pragma unroll
          for (int j = 0; j < lda::kPer; ++j)
            p[c][j] = lda::posterior0(a[j], w[j], sv[c][j], alpha, beta);
        }
        if (own)
          lda::set_at<kC>(p, (z / lda::kLanes) * lda::kPer + z % lda::kPer,
                          p_own);
        // the row is consumed: the next token's loads fly during the draw
        if (db::kOverlap && more) fetch(i + 1);
        const float2 u = s_u[i];
        zn = lda::draw_regs<kC>(p, u.x, u.y);
      } else if (db::kOverlap && more) {
        fetch(i + 1);
      }
      if (!db::kOverlap && more) fetch(i + 1);
      finish(i, zn);
    }
  } else {
    // the generic path: a chunk at a time through lda::draw, the chosen
    // chunk computed again; vector loads of counts, row and sinv
    for (int i = i0; i < i0 + n; ++i) {
      const int4 tok = s_tok[i];
      const int z = tok.x, r = tok.y;
      int zn = z;
      if (tok.z > 0) {
        const TS* arow = s_cnt + (r >= 0 && r < maxd ? r : maxd) * K;
        const TW* row = row_of(tok, i);
        auto post = [&](int c, float (&p)[lda::kPer]) {
          const int k0 = c * lda::kLanes + lda::kPer * lane;
          float a[lda::kPer], w[lda::kPer] = {0.0f, 0.0f, 0.0f, 0.0f};
          db::counts4(arow + k0, a);
          if (row != nullptr)
            db::unpack(__ldg(reinterpret_cast<const Vec*>(row + k0)), w);
          const float4 s = __ldg(reinterpret_cast<const float4*>(sinv + k0));
          const float sj[lda::kPer] = {s.x, s.y, s.z, s.w};
#pragma unroll
          for (int j = 0; j < lda::kPer; ++j)
            p[j] = lda::posterior(a[j], w[j], k0 + j == z ? 1.0f : 0.0f,
                                  sj[j], alpha, beta);
        };
        const float2 u = s_u[i];
        zn = lda::draw(post, K / lda::kLanes, u.x, u.y);
      }
      finish(i, zn);
    }
  }
  __syncthreads();

  // then the moves: nkd for every real token that moved, the doc counts
  // for those whose doc row lies in the block
  for (int i = threadIdx.x; i < tb; i += db::kThreads) {
    const int4 tok = s_tok[i];
    const int z = tok.x, r = tok.y, zn = s_z[i];
    if (tok.z <= 0 || zn == z) continue;
    const bool had = z >= 0 && z < K;
    atomicAdd(&s_nkd[zn], 1);
    if (had) atomicAdd(&s_nkd[z], -1);
    if constexpr (!kBuild) {
      if (r >= 0 && r < maxd) {
        db::add_count(s_cnt, r * K + zn, 1);
        if (had) db::add_count(s_cnt, r * K + z, -1);
      }
    }
  }
  __syncthreads();
  if constexpr (!kBuild) {
    if constexpr (std::is_same_v<TS, TN>) {
      uint4* g = reinterpret_cast<uint4*>(blk);
      const uint4* c = reinterpret_cast<const uint4*>(s_cnt);
      for (int x = threadIdx.x; x < cells * (int)sizeof(TS) / 16;
           x += db::kThreads)
        g[x] = c[x];
    } else {                                // float -> int16, 8 at a time
      uint4* g = reinterpret_cast<uint4*>(blk);
      const float4* c = reinterpret_cast<const float4*>(s_cnt);
      for (int x = threadIdx.x; x < cells / 8; x += db::kThreads) {
        const float4 a = c[2 * x], b = c[2 * x + 1];
        auto pack = [](float lo, float hi) {
          return ((unsigned)(int)lo & 0xffffu) | ((unsigned)(int)hi << 16);
        };
        g[x] = make_uint4(pack(a.x, a.y), pack(a.z, a.w), pack(b.x, b.y),
                          pack(b.z, b.w));
      }
    }
  }
  for (int k = threadIdx.x; k < K; k += db::kThreads)
    if (s_nkd[k] != 0) atomicAdd(nkd + k, s_nkd[k]);
}

template <typename TA, typename TW>
int launch_tiled(const void* A, const void* W, const float* sinv,
                 const int32_t* zi, const int32_t* msk, const float* u1,
                 const float* u2, int64_t b, int C, float alpha, float beta,
                 int32_t* znew, int32_t* nkd, cudaStream_t s) {
  const unsigned grid = (unsigned)((b + kTokensPerBlock - 1) / kTokensPerBlock);
  const size_t smem = (size_t)C * lda::kLanes * sizeof(int32_t);
  gibbs_tiled_kernel<TA, TW><<<grid, kThreads, smem, s>>>(
      static_cast<const TA*>(A), static_cast<const TW*>(W), sinv, zi, msk,
      u1, u2, b, C, alpha, beta, znew, nkd);
  return (int)cudaGetLastError();
}

template <typename TN, typename TW, bool kBuild, int kC>
int launch_docblock(void* ndk, const void* W, const int32_t* words,
                    int64_t V, const float* sinv, const int32_t* zi,
                    const int32_t* drel, const int32_t* msk, const float* u1,
                    const float* u2, int64_t nb, int tb, int maxd, int C,
                    float alpha, float beta, int32_t* znew, int32_t* nkd,
                    cudaStream_t s) {
  const int K = C * lda::kLanes;
  const size_t smem = db::smem_bytes(sizeof(db::Count<TN, kBuild>), tb,
                                     maxd, K);
  auto kern = gibbs_docblock_kernel<TN, TW, kBuild, kC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)nb, db::kThreads, smem, s>>>(
      static_cast<TN*>(ndk), static_cast<const TW*>(W), words, V, sinv, zi,
      drel, msk, u1, u2, tb, maxd, C, alpha, beta, znew, nkd);
  return (int)cudaGetLastError();
}

template <typename TN, bool kBuild>
int docblock_w(int64_t w_bf16, void* ndk, const void* W,
               const int32_t* words, int64_t V, const float* sinv,
               const int32_t* zi, const int32_t* drel, const int32_t* msk,
               const float* u1, const float* u2, int64_t nb, int tb,
               int maxd, int C, float alpha, float beta, int32_t* znew,
               int32_t* nkd, cudaStream_t s) {
#define MV_DOCBLOCK(TW, KC)                                                \
  launch_docblock<TN, TW, kBuild, KC>(ndk, W, words, V, sinv, zi, drel,   \
                                      msk, u1, u2, nb, tb, maxd, C, alpha, \
                                      beta, znew, nkd, s)
  const bool fast = C == db::kFastC;
  if (w_bf16)
    return fast ? MV_DOCBLOCK(__nv_bfloat16, db::kFastC)
                : MV_DOCBLOCK(__nv_bfloat16, 0);
  return fast ? MV_DOCBLOCK(int32_t, db::kFastC) : MV_DOCBLOCK(int32_t, 0);
#undef MV_DOCBLOCK
}

}  // namespace

extern "C" {

// A: [b, C*128] doc-count rows, int32 (a_int16 0) or int16 (1);
// W: [b, C*128] word-count rows, int32 (w_bf16 0) or bf16 (1);
// sinv: [C*128]; zi, msk, u1, u2, znew: [b]; nkd: [C*128], zeroed.
int mv_gibbs_tiled(const void* A, int64_t a_int16, const void* W,
                   int64_t w_bf16, const float* sinv, const int32_t* zi,
                   const int32_t* msk, const float* u1, const float* u2,
                   int64_t b, int64_t C, float alpha, float beta,
                   int32_t* znew, int32_t* nkd, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (C <= 0 || C > lda::kMaxChunks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = (int)C;
  if (a_int16 && w_bf16)
    return launch_tiled<int16_t, __nv_bfloat16>(A, W, sinv, zi, msk, u1, u2,
                                                b, c, alpha, beta, znew, nkd,
                                                s);
  if (a_int16)
    return launch_tiled<int16_t, int32_t>(A, W, sinv, zi, msk, u1, u2, b, c,
                                          alpha, beta, znew, nkd, s);
  if (w_bf16)
    return launch_tiled<int32_t, __nv_bfloat16>(A, W, sinv, zi, msk, u1, u2,
                                                b, c, alpha, beta, znew, nkd,
                                                s);
  return launch_tiled<int32_t, int32_t>(A, W, sinv, zi, msk, u1, u2, b, c,
                                        alpha, beta, znew, nkd, s);
}

// ndk: [nb, maxd, C*128] doc counts updated in place, int32 (n_int16 0)
// or int16 (1); null selects build mode. W: [nb*tb, C*128] gathered
// word-count rows, int32 (w_bf16 0) or bf16 (1); with words [nb*tb]
// (int32), the mirror [V, C*128] whose row words[t] token t reads. zi,
// drel, msk, u1, u2, znew: [nb*tb]; sinv, nkd (zeroed): [C*128]. ndk, W
// and sinv 16-byte aligned.
int mv_gibbs_docblock(void* ndk, int64_t n_int16, const void* W,
                      int64_t w_bf16, const int32_t* words, int64_t V,
                      const float* sinv, const int32_t* zi,
                      const int32_t* drel, const int32_t* msk,
                      const float* u1, const float* u2, int64_t nb,
                      int64_t tb, int64_t maxd, int64_t C, float alpha,
                      float beta, int32_t* znew, int32_t* nkd,
                      void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (C <= 0 || C > lda::kMaxChunks || tb <= 0 || maxd <= 0 ||
      (words != nullptr && (V <= 0 || V > INT32_MAX)) ||
      (((uintptr_t)ndk | (uintptr_t)W | (uintptr_t)sinv) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = (int)C, t = (int)tb, m = (int)maxd;
  if (ndk == nullptr)
    return docblock_w<int32_t, true>(w_bf16, ndk, W, words, V, sinv, zi,
                                     drel, msk, u1, u2, nb, t, m, c, alpha,
                                     beta, znew, nkd, s);
  if (n_int16)
    return docblock_w<int16_t, false>(w_bf16, ndk, W, words, V, sinv, zi,
                                      drel, msk, u1, u2, nb, t, m, c, alpha,
                                      beta, znew, nkd, s);
  return docblock_w<int32_t, false>(w_bf16, ndk, W, words, V, sinv, zi,
                                    drel, msk, u1, u2, nb, t, m, c, alpha,
                                    beta, znew, nkd, s);
}

}  // extern "C"
