// The GELUs of the jitted JAX package on f32 values, as XLA's CPU code
// computes them, bit for bit with the twins of dupl_tpu_torch/ops/gelu.py:
// the exact one (fwd_f32, with XLA's erfc and exp expansions) and the tanh
// one (gelu_tanh_f32, with XLA's rational tanh).  Included by kernel G
// (csrc/gelu_erf.cu) and by Q1's fused fc2 entry (csrc/quantize_rows.cu).
//
// Every rounding is explicit: __fmul_rn / __fadd_rn / __fsub_rn round each
// operation on its own, __fmaf_rn stands exactly where XLA's CPU code
// generator contracts, and __fdiv_rn / __frcp_rn are IEEE divisions.

#pragma once

#include <cuda_runtime.h>

namespace {

// XLA's f32 exp on the CPU: clamp, n = floor(x log2 e + 1/2) in
// [-127, 127], r = x - n ln2 (two parts), 1 + r + r^2 P(r), times 2^n.
__device__ __forceinline__ float exp_xla(float x) {
  x = x < -0x1.5f3334p+6f ? -0x1.5f3334p+6f : x;   // NaN stays NaN
  x = x > 0x1.633334p+6f ? 0x1.633334p+6f : x;
  float n = floorf(__fmaf_rn(x, 0x1.715476p+0f, 0.5f));
  n = n < -127.0f ? -127.0f : n;
  n = n > 127.0f ? 127.0f : n;
  float r = __fmaf_rn(-n, 0x1.63p-1f, x);
  r = __fmaf_rn(-n, -0x1.bd0106p-13f, r);
  float p = __fmaf_rn(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  p = __fmaf_rn(p, r, 0x1.11121p-7f);
  p = __fmaf_rn(p, r, 0x1.555382p-5f);
  p = __fmaf_rn(p, r, 0x1.555554p-3f);
  p = __fmaf_rn(p, r, 0.5f);
  const float y = __fadd_rn(__fmaf_rn(p, __fmul_rn(r, r), r), 1.0f);
  return __fmul_rn(y, __int_as_float((static_cast<int>(n) + 127) << 23));
}

// 1 - z P(z^2), |z| < 1
__device__ __forceinline__ float erfc_small(float z, float z2) {
  float a = __fmaf_rn(z2, 0x1.496a32p-14f, -0x1.a3f7p-11f);
  a = __fmaf_rn(a, z2, 0x1.5405b2p-8f);
  a = __fmaf_rn(a, z2, -0x1.b7f90ep-6f);
  a = __fmaf_rn(a, z2, 0x1.ce2cf8p-4f);
  a = __fmaf_rn(a, z2, -0x1.81273ep-2f);
  a = __fmaf_rn(a, z2, 0x1.20dd74p+0f);
  return __fmaf_rn(-z, a, 1.0f);
}

// exp(-z^2) / |z| * Q or R (1 / z^2), reflected for z < 0; e = exp(-z^2)
__device__ __forceinline__ float erfc_large(float z, float z2, float e) {
  const float az = fabsf(z);
  const float q = __fmul_rn(e, __frcp_rn(az));
  const float w = __frcp_rn(z2);
  float a;
  if (az < 2.0f) {
    a = __fmaf_rn(w, 0x1.7d39e8p-6f, -0x1.1c10dp-3f);
    a = __fmaf_rn(a, w, 0x1.7997ap-2f);
    a = __fmaf_rn(a, w, -0x1.2a39fp-1f);
    a = __fmaf_rn(a, w, 0x1.3df3c6p-1f);
    a = __fmaf_rn(a, w, -0x1.fa518p-2f);
    a = __fmaf_rn(a, w, 0x1.5ca8e2p-2f);
    a = __fmaf_rn(a, w, -0x1.18b1p-2f);
    a = __fmaf_rn(a, w, 0x1.20adccp-1f);
  } else {
    a = __fmaf_rn(w, -0x1.4f4906p+3f, 0x1.9f4538p+3f);
    a = __fmaf_rn(a, w, -0x1.dfb694p+2f);
    a = __fmaf_rn(a, w, 0x1.75e3f4p+1f);
    a = __fmaf_rn(a, w, -0x1.03e86cp+0f);
    a = __fmaf_rn(a, w, 0x1.aff87cp-2f);
    a = __fmaf_rn(a, w, -0x1.20d8bap-2f);
    a = __fmaf_rn(a, w, 0x1.20dd72p-1f);
  }
  float y = __fmul_rn(q, a);
  if (-z2 < -0x1.62e43p+6f) y = 0.0f;
  return z < 0.0f ? __fsub_rn(2.0f, y) : y;
}

// XLA's f32 erfc
__device__ __forceinline__ float erfc_xla(float z) {
  const float z2 = __fmul_rn(z, z);
  if (fabsf(z) < 1.0f) return erfc_small(z, z2);
  return erfc_large(z, z2, exp_xla(-z2));
}

constexpr float kSqrtHalfF32 = 0x1.6a09e6p-1f;

__device__ __forceinline__ float fwd_f32(float x) {
  return __fmul_rn(__fmul_rn(x, 0.5f), erfc_xla(__fmul_rn(-x, kSqrtHalfF32)));
}

// tanh-approximate GELU: v = fma(x^3, 0.044715, x) sqrt(2/pi); tanh(v) is v
// below |v| = 0x1.a36e2ep-12, +-1 from |v| = 20, else v P(v^2) / Q(v^2) on v
// clamped to +-0x1.ffec88p+2 (each Horner step an FMA); then
// x ((t + 1) 0.5).  XLA's CPU flushes subnormal inputs and results to zero
// of the same sign.  Three steps of that recipe change no result and are
// left out: the input's flush (a subnormal x gives a subnormal or zero
// result, flushed at the end), the branch at |v| = 20 (the quotient at the
// clamp is +-1 exactly), and NaN through the clamp (v is NaN only where x
// is, and then so is the result): the twin (ops/gelu.py) takes them all.
__device__ __forceinline__ float gelu_tanh_f32(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float v = __fmul_rn(__fmaf_rn(x3, 0x1.6e4e26p-5f, x), 0x1.988454p-1f);
  const float vc = fminf(fmaxf(v, -0x1.ffec88p+2f), 0x1.ffec88p+2f);
  const float v2 = __fmul_rn(vc, vc);
  float p = __fmaf_rn(v2, -0x1.3e4b8p-52f, 0x1.c266fcp-43f);
  p = __fmaf_rn(p, v2, -0x1.7a6ffep-34f);
  p = __fmaf_rn(p, v2, 0x1.b80082p-25f);
  p = __fmaf_rn(p, v2, 0x1.f28694p-17f);
  p = __fmaf_rn(p, v2, 0x1.4e1bdap-11f);
  p = __fmaf_rn(p, v2, 0x1.40b3b8p-8f);
  float q = __fmaf_rn(v2, 0x1.41a7bp-20f, 0x1.f12bacp-14f);
  q = __fmaf_rn(q, v2, 0x1.29540ap-9f);
  q = __fmaf_rn(q, v2, 0x1.40b3bap-8f);
  const float t = fabsf(v) < 0x1.a36e2ep-12f ? v : __fdiv_rn(__fmul_rn(vc, p), q);
  const float y = __fmul_rn(x, __fmul_rn(__fadd_rn(t, 1.0f), 0.5f));
  return fabsf(y) < 0x1p-126f ? copysignf(0.0f, y) : y;
}

}  // namespace
