// Device functions shared by the LightLDA Gibbs sampler kernels
// (lda_kernels.cu): the collapsed posterior of one topic and the
// two-level inverse-CDF draw of one token by one warp. Both kernels draw
// through the same code, so the doc-blocked kernel's build mode and read
// mode give bit-identical topics for real tokens.
//
// Counterparts of multiverso_tpu/ops/lda_sampler.py _posterior and
// _two_level_draw. The TPU formed the chunk and lane prefix sums as
// triangular matmuls (cumsum has no Pallas TPU lowering); here a warp
// sums and scans with shuffles. The float32 sums are taken in a fixed
// order, which the plain version (ops/lda_sampler.py) repeats op for op;
// against the TPU kernel's order a draw can differ only where a threshold
// ties a CDF boundary in float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lda {

constexpr int kWarp = 32;
constexpr int kLanes = 128;             // topics per chunk (the TPU lane width)
constexpr int kPer = kLanes / kWarp;    // topics per warp lane per chunk
constexpr int kMaxChunks = 2 * kWarp;   // K <= 8192
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(int32_t x) {
  return __int2float_rn(x);
}
__device__ __forceinline__ float to_float(int16_t x) {
  return __int2float_rn((int)x);
}
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// max((a - own + alpha) * (w - own + beta), 0) * sinv: the token's own
// count `own` (0 or 1) leaves both factors; 1/S comes precomputed. The
// _rn intrinsics keep the compiler from fusing a multiply and an add.
__device__ __forceinline__ float posterior(float a, float w, float own,
                                           float sinv, float alpha,
                                           float beta) {
  const float x = __fadd_rn(__fsub_rn(a, own), alpha);
  const float y = __fadd_rn(__fsub_rn(w, own), beta);
  return __fmul_rn(fmaxf(__fmul_rn(x, y), 0.0f), sinv);
}

// One token, one warp (all 32 lanes must call it together). `post(c, p)`
// fills p[0..kPer) with the posteriors of topics c*128 + kPer*lane + j.
//
// Level 1: each chunk's sum, ((p0 + p1) + p2) + p3 per lane and then a
// butterfly over the warp (every lane ends with the same value); their
// inclusive prefix ccdf in chunk order from 0; t1 = u1 * ccdf[C-1];
// chunk = min(#(ccdf < t1), C-1). Lane c keeps ccdf[c] (and lane c-32
// keeps it for c >= 32), so the count is two ballots.
//
// Level 2: the chosen chunk's posteriors again, an inclusive prefix of
// each lane's 4, a Hillis-Steele scan of the lane totals, and
// scdf = (exclusive lane prefix) + (lane's own prefix);
// t2 = u2 * scdf[127]; lane = min(#(scdf < t2), 127).
//
// Returns chunk * 128 + lane.
template <class Post>
__device__ __forceinline__ int draw(const Post& post, int C, float u1,
                                    float u2) {
  const int lane = threadIdx.x % kWarp;
  float p[kPer];
  float run = 0.0f, mine0 = 0.0f, mine1 = 0.0f;
  for (int c = 0; c < C; ++c) {
    post(c, p);
    float s = p[0];
#pragma unroll
    for (int j = 1; j < kPer; ++j) s = __fadd_rn(s, p[j]);
#pragma unroll
    for (int m = kWarp / 2; m >= 1; m >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, m));
    run = __fadd_rn(run, s);
    if (c == lane) mine0 = run;
    if (c == lane + kWarp) mine1 = run;
  }
  const float t1 = __fmul_rn(u1, run);
  int chunk = __popc(__ballot_sync(kFull, lane < C && mine0 < t1)) +
              __popc(__ballot_sync(kFull, lane + kWarp < C && mine1 < t1));
  chunk = min(chunk, C - 1);

  post(chunk, p);
  float q[kPer];
  q[0] = p[0];
#pragma unroll
  for (int j = 1; j < kPer; ++j) q[j] = __fadd_rn(q[j - 1], p[j]);
  float scan = q[kPer - 1];
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const float y = __shfl_up_sync(kFull, scan, d);
    if (lane >= d) scan = __fadd_rn(y, scan);
  }
  float excl = __shfl_up_sync(kFull, scan, 1);
  if (lane == 0) excl = 0.0f;
  const float total = __shfl_sync(kFull, scan, kWarp - 1);
  const float t2 = __fmul_rn(u2, total);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) cnt += __fadd_rn(excl, q[j]) < t2 ? 1 : 0;
#pragma unroll
  for (int m = kWarp / 2; m >= 1; m >>= 1)
    cnt += __shfl_xor_sync(kFull, cnt, m);
  return chunk * kLanes + min(cnt, kLanes - 1);
}

}  // namespace lda
