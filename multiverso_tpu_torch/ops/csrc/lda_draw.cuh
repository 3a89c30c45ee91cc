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
__device__ __forceinline__ float to_float(uint16_t x) {
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

// posterior(a, w, 0, ...): a - 0 is a exactly, so the same value.
__device__ __forceinline__ float posterior0(float a, float w, float sinv,
                                            float alpha, float beta) {
  const float x = __fadd_rn(a, alpha);
  const float y = __fadd_rn(w, beta);
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

// Level 2 of draw() on the chosen chunk's posteriors p (this lane's 4
// topics): the same prefix, scan and thresholds; the lanes below t2 are
// counted with ballots instead of a butterfly (the same integer).
__device__ __forceinline__ int draw_lane(const float (&p)[kPer], float u2) {
  const int lane = threadIdx.x % kWarp;
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
  for (int j = 0; j < kPer; ++j)
    cnt += __popc(__ballot_sync(kFull, __fadd_rn(excl, q[j]) < t2));
  return min(cnt, kLanes - 1);
}

// Runtime indices into register arrays [kC][kPer] (kC <= 8) through a
// switch on the index, each case a constant index: an array indexed at
// run time would live in local memory, and an unrolled select costs an
// instruction per element.
#define LDA_X8(M, b) M(b) M(b + 1) M(b + 2) M(b + 3) M(b + 4) M(b + 5) \
  M(b + 6) M(b + 7)
#define LDA_X32(M) LDA_X8(M, 0) LDA_X8(M, 8) LDA_X8(M, 16) LDA_X8(M, 24)

// q = p[c] (the chunk c is warp-uniform: one case runs)
template <int kC>
__device__ __forceinline__ void pick(const float (&p)[kC][kPer], int c,
                                     float (&q)[kPer]) {
  static_assert(kC <= 8 && kPer == 4, "pick takes up to 8 chunks of 4");
  switch (c) {
#define LDA_PICK(i)                                              \
  case i:                                                        \
    if constexpr ((i) < kC) {                                    \
      q[0] = p[(i) % kC][0], q[1] = p[(i) % kC][1];              \
      q[2] = p[(i) % kC][2], q[3] = p[(i) % kC][3];              \
    }                                                            \
    break;
    LDA_X8(LDA_PICK, 0)
#undef LDA_PICK
  }
}

// p[i / kPer][i % kPer] = v (in the one lane that calls it)
template <int kC>
__device__ __forceinline__ void set_at(float (&p)[kC][kPer], int i,
                                       float v) {
  static_assert(kC * kPer <= 32, "set_at takes up to 32 elements");
  switch (i) {
#define LDA_SET(i)                                                   \
  case i:                                                            \
    if constexpr ((i) < kC * kPer) p[((i) / kPer) % kC][(i) % kPer] = v; \
    break;
    LDA_X32(LDA_SET)
#undef LDA_SET
  }
}

// draw() on posteriors already in registers: p[c][j] is topic
// c*128 + kPer*lane + j, for a chunk count kC fixed at compile time (a
// power of two up to 8). Bit for bit the same topic as draw():
//
// - each chunk's lane sum ((p0 + p1) + p2) + p3 as there;
// - the warp sums by a reduce-scatter butterfly: at the step of xor
//   distance m a lane sends half of the chunk sums it still holds and
//   keeps the other half, so every chunk is summed over the same pairs
//   of lanes, in the same tree, as draw()'s full butterfly (float
//   addition commutes), in 9 shuffles instead of 5 * kC at kC = 8; lane
//   L then holds one chunk's total and 8 more shuffles hand them round;
// - the chunk prefix from 0 in chunk order, the chunk below t1 counted;
// - level 2 on the chosen chunk's registers (pick), not re-read.
template <int kC>
__device__ __forceinline__ int draw_regs(const float (&p)[kC][kPer],
                                         float u1, float u2) {
  static_assert(kC >= 1 && kC <= 8 && (kC & (kC - 1)) == 0,
                "kC must be a power of two up to 8");
  const int lane = threadIdx.x % kWarp;
  float v[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    v[c] = p[c][0];
#pragma unroll
    for (int j = 1; j < kPer; ++j) v[c] = __fadd_rn(v[c], p[c][j]);
  }
#pragma unroll
  for (int st = 0; (kWarp / 2) >> st; ++st) {
    const int m = (kWarp / 2) >> st;
    const int w = kC >> st;               // chunk sums held before the step
    if (w >= 2) {
      const bool hi = (lane & m) != 0;
#pragma unroll
      for (int i = 0; i < w / 2; ++i) {
        const float send = hi ? v[i] : v[i + w / 2];
        const float keep = hi ? v[i + w / 2] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, m));
      }
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], m));
    }
  }
  float run = 0.0f, ccdf[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    int src = 0;                          // a lane that holds chunk c
#pragma unroll
    for (int st = 0; (kWarp / 2) >> st; ++st)
      if ((kC >> st) >= 2 && (c & ((kC >> st) / 2))) src |= (kWarp / 2) >> st;
    run = __fadd_rn(run, __shfl_sync(kFull, v[0], src));
    ccdf[c] = run;
  }
  const float t1 = __fmul_rn(u1, run);
  int chunk = 0;
#pragma unroll
  for (int c = 0; c < kC; ++c) chunk += ccdf[c] < t1 ? 1 : 0;
  chunk = min(chunk, kC - 1);
  float q[kPer];
  pick<kC>(p, chunk, q);
  return chunk * kLanes + draw_lane(q, u2);
}

}  // namespace lda
