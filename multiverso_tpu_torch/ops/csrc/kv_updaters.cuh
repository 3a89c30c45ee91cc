// The six updaters of multiverso_tpu_torch/updaters/updaters.py on one
// element, for the KV commit kernel (kv_kernels.cu), with values of type V
// (float, __nv_bfloat16 or __half) and float32 state leaves.
//
// Each repeats its torch op for op and in its order, with the _rn
// intrinsics: nvcc would otherwise contract a*b + c into one FMA, and the
// result would differ in the last bit from the plain version on the CPU,
// which rounds after every op. The scalars that the plain version computes
// once per call (adam's 1 - b1, 1 - b2, 1 - b1^t and 1 - b2^t) come
// computed by the wrapper in float32 on the CPU, so the kernel does only
// correctly rounded + - * / sqrt, abs, sign, max and select.
//
// Two-byte values follow the reference's promotion (JAX, the option
// scalars and the state float32 arrays): every expression that meets a
// float32 operand is float32, so a value is read as float32 exactly and
// rounded once where the reference casts (``.astype(p.dtype)`` of the
// step, then the 2-byte subtraction). A 2-byte op is computed in float32
// and rounded to its type: for + - of 2-byte operands that is the
// correctly rounded result (float32 has more than twice their significand
// bits plus two).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// An element type's load (exact, to float32), store (rounded to nearest
// even) and rounding of a float32 to the nearest value of the type.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ float load(const __half* p) {
    return __half2float(*p);
  }
  static __device__ __forceinline__ void store(__half* p, float x) {
    *p = __float2half_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

// Apply updater `code` to one element: param p (a value of V, as float32),
// delta d, state a and b (adagrad h in a; momentum v in a; adam m in a, v
// in b; ftrl z in a, n in b). Updates p, a and b in place; p leaves as a
// value of V.
template <typename V>
__device__ __forceinline__ void apply(int code, const Scalars& k, float d,
                                      float& p, float& a, float& b) {
  auto rv = [](float x) { return Elem<V>::round(x); };
  switch (code) {
    case kDefault:                      // param + delta.astype(V)
      p = rv(__fadd_rn(p, rv(d)));
      break;
    case kSgd:                          // param - (lr * delta).astype(V)
      p = rv(__fsub_rn(p, rv(__fmul_rn(k.s[0], d))));
      break;
    case kAdagrad: {                    // h += d*d; p -= lr*d / (sqrt(h) + eps)
      a = __fadd_rn(a, __fmul_rn(d, d));
      const float den = __fadd_rn(__fsqrt_rn(a), k.s[1]);
      p = rv(__fsub_rn(p, rv(__fdiv_rn(__fmul_rn(k.s[0], d), den))));
      break;
    }
    case kMomentum:                     // v = mu*v + d; p -= lr*v
      a = __fadd_rn(__fmul_rn(k.s[1], a), d);
      p = rv(__fsub_rn(p, rv(__fmul_rn(k.s[0], a))));
      break;
    case kAdam: {
      // m = b1*m + (1-b1)*d; v = b2*v + (1-b2)*d*d;
      // p -= lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)
      a = __fadd_rn(__fmul_rn(k.s[1], a), __fmul_rn(k.s[4], d));
      b = __fadd_rn(__fmul_rn(k.s[2], b), __fmul_rn(__fmul_rn(k.s[5], d), d));
      const float mhat = __fdiv_rn(a, k.s[6]);
      const float vhat = __fdiv_rn(b, k.s[7]);
      const float den = __fadd_rn(__fsqrt_rn(vhat), k.s[3]);
      p = rv(__fsub_rn(p, rv(__fdiv_rn(__fmul_rn(k.s[0], mhat), den))));
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
      p = rv(w);
      break;
    }
    default:
      break;
  }
}

}  // namespace kv
