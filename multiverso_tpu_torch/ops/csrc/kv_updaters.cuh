// The six updaters of multiverso_tpu_torch/updaters/updaters.py on one
// float32 element, for the KV commit kernel (kv_kernels.cu).
//
// Each repeats its torch op for op and in its order, with the _rn
// intrinsics: nvcc would otherwise contract a*b + c into one FMA, and the
// result would differ in the last bit from the plain version on the CPU,
// which rounds after every op. The scalars that the plain version computes
// once per call (adam's 1 - b1, 1 - b2, 1 - b1^t and 1 - b2^t) come
// computed by the wrapper in float32 on the CPU, so the kernel does only
// correctly rounded + - * / sqrt, abs, sign, max and select.

#pragma once

#include <cuda_runtime.h>

namespace kv {

// the wrapper's updater codes (ops/table_kernels.py KV_UPDATERS)
enum Code : int {
  kDefault = 0,
  kSgd = 1,
  kAdagrad = 2,
  kMomentum = 3,
  kAdam = 4,
  kFtrl = 5,
};

// Per-call float32 scalars, by updater:
//   sgd       s[0] lr
//   adagrad   s[0] lr, s[1] eps
//   momentum  s[0] lr, s[1] mu
//   adam      s[0] lr, s[1] b1, s[2] b2, s[3] eps, s[4] 1-b1, s[5] 1-b2,
//             s[6] 1-b1^t, s[7] 1-b2^t
//   ftrl      s[0] alpha, s[1] beta, s[2] l1, s[3] l2
struct Scalars {
  float s[8];
};

// Apply updater `code` to one element: param p, delta d, state a and b
// (adagrad h in a; momentum v in a; adam m in a, v in b; ftrl z in a, n in
// b). Updates p, a and b in place.
__device__ __forceinline__ void apply(int code, const Scalars& k, float d,
                                      float& p, float& a, float& b) {
  switch (code) {
    case kDefault:                      // param + delta
      p = __fadd_rn(p, d);
      break;
    case kSgd:                          // param - lr * delta
      p = __fsub_rn(p, __fmul_rn(k.s[0], d));
      break;
    case kAdagrad: {                    // h += d*d; p -= lr*d / (sqrt(h) + eps)
      a = __fadd_rn(a, __fmul_rn(d, d));
      const float den = __fadd_rn(__fsqrt_rn(a), k.s[1]);
      p = __fsub_rn(p, __fdiv_rn(__fmul_rn(k.s[0], d), den));
      break;
    }
    case kMomentum:                     // v = mu*v + d; p -= lr*v
      a = __fadd_rn(__fmul_rn(k.s[1], a), d);
      p = __fsub_rn(p, __fmul_rn(k.s[0], a));
      break;
    case kAdam: {
      // m = b1*m + (1-b1)*d; v = b2*v + (1-b2)*d*d;
      // p -= lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)
      a = __fadd_rn(__fmul_rn(k.s[1], a), __fmul_rn(k.s[4], d));
      b = __fadd_rn(__fmul_rn(k.s[2], b), __fmul_rn(__fmul_rn(k.s[5], d), d));
      const float mhat = __fdiv_rn(a, k.s[6]);
      const float vhat = __fdiv_rn(b, k.s[7]);
      const float den = __fadd_rn(__fsqrt_rn(vhat), k.s[3]);
      p = __fsub_rn(p, __fdiv_rn(__fmul_rn(k.s[0], mhat), den));
      break;
    }
    case kFtrl: {
      // n' = n + g*g; sigma = (sqrt(n') - sqrt(n)) / alpha;
      // z' = z + g - sigma*p; w = |z'| <= l1 ? 0
      //   : -(sign(z') * max(|z'| - l1, 0)) / ((beta + sqrt(n')) / alpha + l2)
      const float alpha = k.s[0], beta = k.s[1], l1 = k.s[2], l2 = k.s[3];
      const float n_new = __fadd_rn(b, __fmul_rn(d, d));
      const float sq_new = __fsqrt_rn(n_new);
      const float sigma = __fdiv_rn(__fsub_rn(sq_new, __fsqrt_rn(b)), alpha);
      const float z_new = __fsub_rn(__fadd_rn(a, d), __fmul_rn(sigma, p));
      const float az = fabsf(z_new);
      float w = 0.0f;
      if (!(az <= l1)) {
        const float x = __fsub_rn(az, l1);
        const float clamped = x < 0.0f ? 0.0f : x;   // a NaN stays NaN
        // torch.sign: 0 for a zero and for a NaN
        const float sgn = z_new > 0.0f ? 1.0f : (z_new < 0.0f ? -1.0f : 0.0f);
        const float shrunk = __fmul_rn(sgn, clamped);
        const float den = __fadd_rn(__fdiv_rn(__fadd_rn(beta, sq_new), alpha), l2);
        w = __fdiv_rn(-shrunk, den);
      }
      a = z_new;
      b = n_new;
      p = w;
      break;
    }
    default:
      break;
  }
}

}  // namespace kv
