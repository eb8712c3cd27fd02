// Kernel G: the exact (erf) GELU of the JAX package for Hopper (sm_90a),
// forward and backward, each one elementwise pass over bf16 or fp32
// tensors of any shape:
//     forward   y  = gelu(x)  = (0.5 x) erfc(-x s)
//     backward  dx = -(((0.5x g) c) exp(-z^2)) s + (g erfc(z)) 0.5, z = -x s
// with s = sqrt(1/2) and c = -2/sqrt(pi) rounded to the input's dtype,
// bit for bit with the plain twins gelu_erf_ref / gelu_erf_bwd_ref of
// dupl_tpu_torch/ops/gelu.py, which are jax.jit(jax.nn.gelu(approximate=
// False)) and jax.vjp of it on the CPU, every rounding included.
//
// Replaces no Pallas kernel: it is XLA's fused loop for the GELU of the
// JAX package's Mlp (dupl_tpu/models/vit.py:Mlp, nn.gelu), which XLA
// expands into its own f32 erfc and exp polynomials.  torch's erf / erfc
// and F.gelu are other functions, rounded elsewhere; the port needs the
// JAX package's bits on its main path (every ViT block of serving,
// pseudo-labels, evaluation and training: 12 launches a student's forward,
// 12 a backward).
//
// Every rounding is explicit: __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn round each operation on its own (nvcc would otherwise contract
// a product and a sum into one FMA), and __fmaf_rn stands exactly where
// XLA's CPU code generator contracts: each Horner step of the erfc and exp
// polynomials, 1 - z P, the exp's range reduction, and in the fp32
// backward the last product with the sum.  The constants are XLA's (hex,
// as in ops/gelu.py).  Subnormals are kept (no -ftz), as in the twins.
//
// Bound.  Per element: 2 or 4 bytes read (twice that for the backward's x
// and g) and as many written; on the fp32 pipes about 12 instructions for
// |z| < 1 and about 30 (an exp, two divisions, a 7- or 8-step polynomial)
// beyond, the backward about twice that.  At ViT-B's MLP width in bf16
// both bounds are about equal (PERF.md).  Design: a grid-stride loop of
// 16-byte loads and stores (8 bf16 or 4 fp32 elements a thread and step)
// where both pointers are 16-byte aligned, elementwise otherwise and for
// the tail; the erfc's branches diverge within a warp only where |z|
// crosses 1 or 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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
  const float q = __fmul_rn(e, __fdiv_rn(1.0f, az));
  const float w = __fdiv_rn(1.0f, z2);
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

constexpr float kSqrtHalfBf16 = 0.70703125f;
constexpr float kSqrtHalfF32 = 0x1.6a09e6p-1f;

__device__ __forceinline__ float fwd(float x, bool bf16) {
  if (bf16) {
    const float half = bf(__fmul_rn(x, 0.5f));
    const float e = bf(erfc_xla(__fmul_rn(-x, kSqrtHalfBf16)));
    return __fmul_rn(half, e);                 // rounded to bf16 by the store
  }
  return __fmul_rn(__fmul_rn(x, 0.5f), erfc_xla(__fmul_rn(-x, kSqrtHalfF32)));
}

__device__ __forceinline__ float bwd(float x, float g, bool bf16) {
  if (bf16) {
    const float t = bf(__fmul_rn(bf(__fmul_rn(bf(__fmul_rn(x, 0.5f)), g)),
                                 -1.125f));
    const float z = __fmul_rn(-x, kSqrtHalfBf16);
    const float zb = bf(z);
    const float e = bf(exp_xla(-bf(__fmul_rn(zb, zb))));
    const float left = -bf(__fmul_rn(bf(__fmul_rn(t, e)), kSqrtHalfBf16));
    const float right = bf(__fmul_rn(bf(__fmul_rn(g, bf(erfc_xla(z)))), 0.5f));
    return __fadd_rn(left, right);             // rounded to bf16 by the store
  }
  const float t = __fmul_rn(__fmul_rn(__fmul_rn(x, 0.5f), g),
                            -0x1.20dd76p+0f);
  const float z = __fmul_rn(-x, kSqrtHalfF32);
  const float z2 = __fmul_rn(z, z);
  const float e = exp_xla(-z2);                // shared with the erfc
  const float ec = fabsf(z) < 1.0f ? erfc_small(z, z2) : erfc_large(z, z2, e);
  const float right = __fmul_rn(__fmul_rn(g, ec), 0.5f);
  return __fmaf_rn(-__fmul_rn(t, e), kSqrtHalfF32, right);
}

template <typename T>
__device__ __forceinline__ float load(T v);
template <>
__device__ __forceinline__ float load<float>(float v) { return v; }
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T store(float v);
template <>
__device__ __forceinline__ float store<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// out[i] = fwd(x[i]) (g == nullptr) or bwd(x[i], g[i]); kVec elements a
// thread and step by 16-byte accesses, or 1
template <typename T, int kVec>
__global__ void __launch_bounds__(256)
gelu_kernel(const T* __restrict__ x, const T* __restrict__ g,
            T* __restrict__ out, int64_t n) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t nvec = n / kVec;
  for (int64_t i = first; i < nvec; i += stride) {
    alignas(16) T xv[kVec];
    alignas(16) T gv[kVec];
    alignas(16) T ov[kVec];
    if constexpr (kVec > 1) {
      *reinterpret_cast<uint4*>(xv) = reinterpret_cast<const uint4*>(x)[i];
      if (g) *reinterpret_cast<uint4*>(gv) = reinterpret_cast<const uint4*>(g)[i];
    } else {
      xv[0] = x[i];
      if (g) gv[0] = g[i];
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      ov[k] = store<T>(g ? bwd(load(xv[k]), load(gv[k]), kBf16)
                         : fwd(load(xv[k]), kBf16));
    if constexpr (kVec > 1)
      reinterpret_cast<uint4*>(out)[i] = *reinterpret_cast<uint4*>(ov);
    else
      out[i] = ov[0];
  }
  for (int64_t i = nvec * kVec + first; i < n; i += stride)
    out[i] = store<T>(g ? bwd(load(x[i]), load(g[i]), kBf16)
                        : fwd(load(x[i]), kBf16));
}

template <typename T>
int launch(const void* x, const void* g, void* out, long long n,
           cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const long long work = aligned ? (n + kVec - 1) / kVec : n;
  const int blocks = static_cast<int>(
      work / 256 + 1 < 132 * 16 ? work / 256 + 1 : 132 * 16);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (aligned)
    gelu_kernel<T, kVec><<<blocks, 256, 0, stream>>>(xt, gt, ot, n);
  else
    gelu_kernel<T, 1><<<blocks, 256, 0, stream>>>(xt, gt, ot, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dupl_gelu_erf_fwd(const void* x, void* y, long long n,
                                 int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, nullptr, y, n, st)
              : launch<float>(x, nullptr, y, n, st);
}

extern "C" int dupl_gelu_erf_bwd(const void* x, const void* g, void* dx,
                                 long long n, int bf16, void* stream) {
  if (g == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, g, dx, n, st)
              : launch<float>(x, g, dx, n, st);
}
