// Kernel G: the exact (erf) GELU of the JAX package for Hopper (sm_90a),
// forward and backward, each one elementwise pass over bf16, f16 or fp32
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
// Every rounding is explicit: __fmul_rn / __fadd_rn / __fsub_rn round each
// operation on its own (nvcc would otherwise contract a product and a sum
// into one FMA), and __fmaf_rn stands exactly where XLA's CPU code
// generator contracts: each Horner step of the erfc and exp polynomials,
// 1 - z P, the exp's range reduction, and in the fp32 backward the last
// product with the sum.  XLA's divisions 1 / |z| and 1 / z^2 are
// __frcp_rn, the correctly rounded reciprocal (the same bits as
// __fdiv_rn(1, v) in fewer instructions).  The constants are XLA's (hex, as
// in ops/gelu.py).  Subnormals are kept (no -ftz), as in the twins.
//
// bf16: tables.  A bf16 result depends on the 16 input bits alone, so G
// keeps two tables of all 65,536 inputs in device memory, as the twin does
// (ops/gelu.py:_bf16_tables): the forward's bf16 result (128 KB), and the
// backward's two x-only factors packed in one word (256 KB), bf16
// erfc(z) in the low half and bf16 exp(-bf16(bf16(z)^2)) in the high half,
// so each unpacks with one shift or one mask.  build_tables runs the
// expansion below over every bit pattern, once per device, at G's first
// launch there (not under stream capture).  The forward is then a gather,
// and the backward keeps only the products that mix x and g, each rounded
// to bf16 as XLA's VJP rounds it.  A lookup reads the table through L1
// (ld.global.nc): the hot set of real activations is a few thousand
// entries.  A window of the table staged in shared memory by every block
// tied this forward and lost 9% backward on the card (PERF.md).
//
// f16: the same design.  An f16 result, too, depends on the 16 input bits
// alone: G keeps a second pair of tables (build_tables_f16), the forward's
// f16 result and the backward's f16 erfc(f32(z)) | f16 exp(-f16(z z)) << 16
// with z = f16(-x s), each f16 operation rounded on its own, as XLA's CPU
// code rounds them (ops/gelu.py:_f16_tables).  The backward's products that
// mix x and g are f16 multiplies (mul.rn.f16, one rounding each, never
// contracted), and its last product and sum one f16 FMA (fma.rn.f16), where
// XLA's code has one (vfnmadd231ph).
//
// fp32: the expansion (csrc/gelu_xla.cuh, shared with Q1's fused GELU),
// forward and backward as separate kernels (the backward's registers no
// longer limit the forward's residency).
//
// Bound.  Per element: 2 or 4 bytes read (twice that for the backward's x
// and g) and as many written.  bf16 is bound by these bytes; fp32 by them
// or, beyond |z| = 1, by the expansion's ~30 instructions (PERF.md).  Each
// thread loads kChunks 16-byte chunks of x (and g) before it computes on
// any of them, with L1::no_allocate so that streamed data does not evict
// the table from L1; elementwise where a pointer is off 16-byte alignment
// and for the tail.  The grid covers the tensor once: on the card it beat
// a grid-stride loop over the resident blocks (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "gelu_xla.cuh"

namespace {

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t bf_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf_value(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

constexpr float kSqrtHalfBf16 = 0.70703125f;

__device__ __forceinline__ float bwd_f32(float x, float g) {
  const float t = __fmul_rn(__fmul_rn(__fmul_rn(x, 0.5f), g),
                            -0x1.20dd76p+0f);
  const float z = __fmul_rn(-x, kSqrtHalfF32);
  const float z2 = __fmul_rn(z, z);
  const float e = exp_xla(-z2);                // shared with the erfc
  const float ec = fabsf(z) < 1.0f ? erfc_small(z, z2) : erfc_large(z, z2, e);
  const float right = __fmul_rn(__fmul_rn(g, ec), 0.5f);
  return __fmaf_rn(-__fmul_rn(t, e), kSqrtHalfF32, right);
}

// ---- the bf16 tables -----------------------------------------------------------

__device__ uint16_t g_fwd_table[65536];  // bf16 gelu(x), by the bits of x
__device__ uint32_t g_bwd_table[65536];  // bf16 erfc(z) | bf16 exp(..) << 16

// One thread a bit pattern: the forward bf16(bf16(0.5 x) bf16(erfc(z))), z
// = f32(-x) * bf16(sqrt(1/2)), and the backward's erfc(z) and
// exp(-bf16(bf16(z)^2)), each rounded to bf16.
__global__ void __launch_bounds__(256) build_tables() {
  const uint32_t i = blockIdx.x * 256 + threadIdx.x;
  const float x = bf_value(i);
  const float z = __fmul_rn(-x, kSqrtHalfBf16);
  const float ec = bf(erfc_xla(z));
  g_fwd_table[i] =
      static_cast<uint16_t>(bf_bits(__fmul_rn(bf(__fmul_rn(x, 0.5f)), ec)));
  const float zb = bf(z);
  const float e = exp_xla(-bf(__fmul_rn(zb, zb)));
  g_bwd_table[i] = bf_bits(ec) | (bf_bits(e) << 16);
}

// The backward's products that mix x and g, from the packed word w of x.
__device__ __forceinline__ float bwd_bf16(float x, float g, uint32_t w) {
  const float ec = __uint_as_float(w << 16);
  const float e = __uint_as_float(w & 0xffff0000u);
  const float t = bf(__fmul_rn(bf(__fmul_rn(bf(__fmul_rn(x, 0.5f)), g)),
                               -1.125f));
  const float left = -bf(__fmul_rn(bf(__fmul_rn(t, e)), kSqrtHalfBf16));
  const float right = bf(__fmul_rn(bf(__fmul_rn(g, ec)), 0.5f));
  return __fadd_rn(left, right);               // rounded to bf16 by the caller
}

// ---- the f16 tables ------------------------------------------------------------

__device__ uint16_t g_fwd_table_f16[65536];  // f16 gelu(x), by the bits of x
__device__ uint32_t g_bwd_table_f16[65536];  // f16 erfc(z) | f16 exp(..) << 16

// f16 operations on bit patterns, each rounded once to nearest (PTX .rn:
// no contraction into an fma, subnormals kept)
__device__ __forceinline__ uint16_t hmul(uint16_t a, uint16_t b) {
  uint16_t d;
  asm("mul.rn.f16 %0, %1, %2;\n" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

__device__ __forceinline__ uint16_t hfma(uint16_t a, uint16_t b, uint16_t c) {
  uint16_t d;
  asm("fma.rn.f16 %0, %1, %2, %3;\n" : "=h"(d) : "h"(a), "h"(b), "h"(c));
  return d;
}

__device__ __forceinline__ float h_value(uint16_t bits) {
  return __half2float(__ushort_as_half(bits));
}

__device__ __forceinline__ uint16_t h_bits(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

// f16 bits of 0.5, of sqrt(1/2) (0.70703125) and of -2/sqrt(pi) rounded to
// f16 (-0x1.20cp+0)
constexpr uint16_t kHalfF16 = 0x3800, kSqrtHalfF16 = 0x39a8, kNegCF16 = 0xbc83;

// One thread a bit pattern: the forward f16(f16(0.5 x) f16(erfc(f32(z)))),
// z = f16(-x s), and the backward's erfc(z) and exp(-f16(z z)), each
// rounded to f16.
__global__ void __launch_bounds__(256) build_tables_f16() {
  const uint32_t i = blockIdx.x * 256 + threadIdx.x;
  const uint16_t x = static_cast<uint16_t>(i);
  const uint16_t z = hmul(x ^ 0x8000, kSqrtHalfF16);
  const uint16_t ec = h_bits(erfc_xla(h_value(z)));
  g_fwd_table_f16[i] = hmul(hmul(x, kHalfF16), ec);
  const uint16_t e = h_bits(exp_xla(h_value(hmul(z, z) ^ 0x8000)));
  g_bwd_table_f16[i] = ec | (static_cast<uint32_t>(e) << 16);
}

// The backward's products that mix x and g, from the packed word w of x:
// -(((0.5x g) c) e) s + (g ec) 0.5, the last product and sum one fma.
__device__ __forceinline__ uint16_t bwd_f16(uint16_t x, uint16_t g,
                                            uint32_t w) {
  const uint16_t ec = static_cast<uint16_t>(w), e = static_cast<uint16_t>(w >> 16);
  const uint16_t t = hmul(hmul(hmul(hmul(x, kHalfF16), g), kNegCF16), e);
  const uint16_t right = hmul(hmul(g, ec), kHalfF16);
  return hfma(t ^ 0x8000, kSqrtHalfF16, right);
}

// The table entry of x's bits, through L1: bf16's tables, or f16's.
template <bool kBwd, bool kF16 = false>
__device__ __forceinline__ uint32_t look(uint32_t bits) {
  if constexpr (kF16) {
    if constexpr (kBwd) return __ldg(g_bwd_table_f16 + bits);
    else return __ldg(g_fwd_table_f16 + bits);
  } else {
    if constexpr (kBwd) return __ldg(g_bwd_table + bits);
    else return __ldg(g_fwd_table + bits);
  }
}

// ---- the elementwise pass ------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kChunks = 2;  // 16-byte chunks of x (and g) a thread loads at once

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// One element: T is uint16_t (bf16 bits, or f16 bits if kF16) or float.
template <typename T, bool kBwd, bool kF16>
__device__ __forceinline__ T elem(T x, T g) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (kBwd) return bwd_f32(x, g);
    else return fwd_f32(x);
  } else if constexpr (kF16) {
    const uint32_t w = look<kBwd, true>(x);
    if constexpr (!kBwd) return static_cast<T>(w);
    else return bwd_f16(x, g, w);
  } else {
    const uint32_t w = look<kBwd>(x);
    if constexpr (!kBwd) return static_cast<T>(w);
    else return static_cast<T>(bf_bits(bwd_bf16(bf_value(x), bf_value(g), w)));
  }
}

// out[i] = forward(x[i]) or backward(x[i], g[i]); kVec elements a chunk
// (16 bytes), or 1 where a pointer is off 16-byte alignment.  kF16: T's
// 16 bits are an f16 value.
template <typename T, bool kBwd, int kVec, bool kF16 = false>
__global__ void __launch_bounds__(kThreads)
gelu_kernel(const T* __restrict__ x, const T* __restrict__ g,
            T* __restrict__ out, int64_t n) {
  const int64_t nvec = n / kVec;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kChunks;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads * kChunks +
                    threadIdx.x;
       i0 < nvec; i0 += step) {
    union Chunk {
      uint4 v;
      T e[kVec];
    } xv[kChunks], gv[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t i = i0 + c * kThreads;
      if (i >= nvec) break;
      if constexpr (kVec > 1) {
        xv[c].v = ld_stream(x + i * kVec);
        if constexpr (kBwd) gv[c].v = ld_stream(g + i * kVec);
      } else {
        xv[c].e[0] = x[i];
        if constexpr (kBwd) gv[c].e[0] = g[i];
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t i = i0 + c * kThreads;
      if (i >= nvec) break;
      Chunk o;
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        o.e[k] = elem<T, kBwd, kF16>(xv[c].e[k], kBwd ? gv[c].e[k] : T(0));
      if constexpr (kVec > 1)
        *reinterpret_cast<uint4*>(out + i * kVec) = o.v;
      else
        out[i] = o.e[0];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - nvec * kVec) {  // the tail
    const int64_t i = nvec * kVec + threadIdx.x;
    out[i] = elem<T, kBwd, kF16>(x[i], kBwd ? g[i] : T(0));
  }
}

// ---- host ------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Build the bf16 (kF16 false) or f16 tables on the current device once: on
// `stream`, waited for, so that a launch on any stream of the device finds
// them.  Not under stream capture: a captured build would not run until
// the graph does.
template <bool kF16>
int tables_ready(cudaStream_t stream) {
  static std::mutex mu;
  static bool built[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  if (built[dev]) return 0;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  err = cudaStreamIsCapturing(stream, &capture);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (capture != cudaStreamCaptureStatusNone)
    return static_cast<int>(cudaErrorStreamCaptureUnsupported);
  if constexpr (kF16) build_tables_f16<<<65536 / 256, 256, 0, stream>>>();
  else build_tables<<<65536 / 256, 256, 0, stream>>>();
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  built[dev] = true;
  return 0;
}

template <typename T, bool kBwd, int kVec, bool kF16>
int launch_one(const void* x, const void* g, void* out, long long n,
               cudaStream_t stream) {
  // a block for every kThreads * kChunks chunks: each thread's loop runs
  // once (the loop strides on only past 2^30 blocks)
  const long long per_block = static_cast<long long>(kThreads) * kChunks;
  const long long want = (n / kVec + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < 1 ? 1 : want < (1 << 30) ? want : 1 << 30);
  gelu_kernel<T, kBwd, kVec, kF16><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBwd, bool kF16 = false>
int launch(const void* x, const void* g, void* out, long long n,
           cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!std::is_same<T, float>::value) {
    const int status = tables_ready<kF16>(stream);
    if (status != 0) return status;
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  return aligned
             ? launch_one<T, kBwd, 16 / sizeof(T), kF16>(x, g, out, n, stream)
             : launch_one<T, kBwd, 1, kF16>(x, g, out, n, stream);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 f16; x, y (and g, dx) n contiguous elements of
// it on the device.  Returns the first CUDA error.
extern "C" int dupl_gelu_erf_fwd(const void* x, void* y, long long n,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, false>(x, nullptr, y, n, st);
    case 1: return launch<uint16_t, false>(x, nullptr, y, n, st);
    case 2: return launch<uint16_t, false, true>(x, nullptr, y, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dupl_gelu_erf_bwd(const void* x, const void* g, void* dx,
                                 long long n, int dtype, void* stream) {
  if (g == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, true>(x, g, dx, n, st);
    case 1: return launch<uint16_t, true>(x, g, dx, n, st);
    case 2: return launch<uint16_t, true, true>(x, g, dx, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

