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
// rows written back in ndk's type (read mode).
//
// What bounds them: bytes. Per token the kernel reads a K-wide word-count
// row (2 KB of bf16 at K = 1024) and, for the tiled kernel, a doc-count
// row; it does about 6 float operations per topic, far below the card's
// float32 rate. A production step (512,000 tokens, K = 1024) reads 1.05 GB
// of W rows.
//
// What the design does about it: one warp per token, 4 topics per lane
// per 128-topic chunk, so a warp's loads of a chunk are contiguous; the
// chosen chunk is read a second time (from L1/L2) instead of keeping K
// posteriors in registers. The doc-blocked kernel keeps its block's doc
// counts in shared memory as int32 (64 KB at maxd 16, K 1024: dynamic
// shared memory past 48 KB), so A rows never touch device memory. The TPU
// carried nkd across its sequential grid; Hopper blocks run in no order,
// so each block sums its moves in shared memory and adds the nonzero ones
// to nkd (zeroed by the wrapper) with integer atomics, exact in any order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename TN, typename TW, bool kBuild>
__global__ void __launch_bounds__(kThreads)
gibbs_docblock_kernel(TN* __restrict__ ndk, const TW* __restrict__ W,
                      const float* __restrict__ sinv,
                      const int32_t* __restrict__ zi,
                      const int32_t* __restrict__ drel,
                      const int32_t* __restrict__ msk,
                      const float* __restrict__ u1,
                      const float* __restrict__ u2, int tb, int maxd, int C,
                      float alpha, float beta, int32_t* __restrict__ znew,
                      int32_t* __restrict__ nkd) {
  extern __shared__ int32_t smem[];
  const int K = C * lda::kLanes;
  const int cells = maxd * K;
  int32_t* s_ndk = smem;                        // [maxd, K] block counts
  int32_t* s_nkd = smem + cells;                // [K] summary delta
  int32_t* s_z = s_nkd + K;                     // [tb] new topics
  const int warp = threadIdx.x / lda::kWarp;
  const int lane = threadIdx.x % lda::kWarp;
  const int64_t t0 = (int64_t)blockIdx.x * tb;
  TN* blk = nullptr;
  if constexpr (kBuild) {
    for (int x = threadIdx.x; x < cells; x += kThreads) s_ndk[x] = 0;
  } else {
    blk = ndk + (int64_t)blockIdx.x * cells;
    for (int x = threadIdx.x; x < cells; x += kThreads)
      s_ndk[x] = (int32_t)blk[x];
  }
  for (int k = threadIdx.x; k < K; k += kThreads) s_nkd[k] = 0;
  __syncthreads();
  if constexpr (kBuild) {
    for (int i = threadIdx.x; i < tb; i += kThreads) {
      const int64_t t = t0 + i;
      const int r = drel[t];
      const int z = zi[t];
      if (msk[t] > 0 && r >= 0 && r < maxd && z >= 0 && z < K)
        atomicAdd(&s_ndk[r * K + z], 1);
    }
    __syncthreads();
  }

  // every token draws against the block-start counts
  for (int i = warp; i < tb; i += kWarps) {
    const int64_t t = t0 + i;
    const int32_t z = zi[t];
    const int r = drel[t];
    int32_t zn = z;
    if (msk[t] > 0 && r >= 0 && r < maxd) {
      const int32_t* a = s_ndk + r * K;
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
      s_z[i] = zn;
    }
  }
  __syncthreads();

  // then the moves
  for (int i = threadIdx.x; i < tb; i += kThreads) {
    const int64_t t = t0 + i;
    const int32_t z = zi[t];
    const int32_t zn = s_z[i];
    const int r = drel[t];
    if (msk[t] <= 0 || r < 0 || r >= maxd || zn == z) continue;
    const bool had = z >= 0 && z < K;
    atomicAdd(&s_nkd[zn], 1);
    if (had) atomicAdd(&s_nkd[z], -1);
    if constexpr (!kBuild) {
      atomicAdd(&s_ndk[r * K + zn], 1);
      if (had) atomicAdd(&s_ndk[r * K + z], -1);
    }
  }
  __syncthreads();
  if constexpr (!kBuild) {
    for (int x = threadIdx.x; x < cells; x += kThreads)
      blk[x] = (TN)s_ndk[x];
  }
  for (int k = threadIdx.x; k < K; k += kThreads)
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

template <typename TN, typename TW, bool kBuild>
int launch_docblock(void* ndk, const void* W, const float* sinv,
                    const int32_t* zi, const int32_t* drel,
                    const int32_t* msk, const float* u1, const float* u2,
                    int64_t nb, int tb, int maxd, int C, float alpha,
                    float beta, int32_t* znew, int32_t* nkd,
                    cudaStream_t s) {
  const int K = C * lda::kLanes;
  const size_t smem = ((size_t)maxd * K + K + tb) * sizeof(int32_t);
  auto kern = gibbs_docblock_kernel<TN, TW, kBuild>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)nb, kThreads, smem, s>>>(
      static_cast<TN*>(ndk), static_cast<const TW*>(W), sinv, zi, drel, msk,
      u1, u2, tb, maxd, C, alpha, beta, znew, nkd);
  return (int)cudaGetLastError();
}

template <typename TN, bool kBuild>
int docblock_w(int64_t w_bf16, void* ndk, const void* W, const float* sinv,
               const int32_t* zi, const int32_t* drel, const int32_t* msk,
               const float* u1, const float* u2, int64_t nb, int tb,
               int maxd, int C, float alpha, float beta, int32_t* znew,
               int32_t* nkd, cudaStream_t s) {
  if (w_bf16)
    return launch_docblock<TN, __nv_bfloat16, kBuild>(
        ndk, W, sinv, zi, drel, msk, u1, u2, nb, tb, maxd, C, alpha, beta,
        znew, nkd, s);
  return launch_docblock<TN, int32_t, kBuild>(
      ndk, W, sinv, zi, drel, msk, u1, u2, nb, tb, maxd, C, alpha, beta,
      znew, nkd, s);
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
// or int16 (1); null selects build mode. W: [nb*tb, C*128] as above;
// zi, drel, msk, u1, u2, znew: [nb*tb]; nkd: [C*128], zeroed.
int mv_gibbs_docblock(void* ndk, int64_t n_int16, const void* W,
                      int64_t w_bf16, const float* sinv, const int32_t* zi,
                      const int32_t* drel, const int32_t* msk,
                      const float* u1, const float* u2, int64_t nb,
                      int64_t tb, int64_t maxd, int64_t C, float alpha,
                      float beta, int32_t* znew, int32_t* nkd,
                      void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  if (C <= 0 || C > lda::kMaxChunks || tb <= 0 || maxd <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = (int)C, t = (int)tb, m = (int)maxd;
  if (ndk == nullptr)
    return docblock_w<int32_t, true>(w_bf16, ndk, W, sinv, zi, drel, msk, u1,
                                     u2, nb, t, m, c, alpha, beta, znew, nkd,
                                     s);
  if (n_int16)
    return docblock_w<int16_t, false>(w_bf16, ndk, W, sinv, zi, drel, msk,
                                      u1, u2, nb, t, m, c, alpha, beta, znew,
                                      nkd, s);
  return docblock_w<int32_t, false>(w_bf16, ndk, W, sinv, zi, drel, msk, u1,
                                    u2, nb, t, m, c, alpha, beta, znew, nkd,
                                    s);
}

}  // extern "C"
