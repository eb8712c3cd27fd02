// Instruction-rate probe of the elementwise and transcendental instructions
// (sm_90a): iters dependent passes of  acc <- acc + f(x + acc * 1e-9)  over
// a tile that never leaves the registers, in fp32 and in bf16.
//
// Replaces the Pallas TPU kernel tools/exp_rate_experiment.py:_mk_kernel
// (launched by run), which times the vector unit on a tile resident in fast
// memory.  Same arithmetic: acc starts at 0; every pass feeds acc back into
// the argument, so no pass can be hoisted or skipped; in bf16 the product,
// both sums and f are each rounded to bf16, every pass.
//
// Design.  On the TPU the tile sits in VMEM and one core walks it; here each
// thread owns two elements whose x and acc stay in registers for the whole
// loop (two independent dependent chains a thread, 64 warps an SM to cover
// the latency of the chain), the tile is read once and written once, and the
// loop is unrolled eight-fold so that the chain, not the loop counter, is
// what is timed.  What the probe is for is the choice of instruction, so f
// names one exactly:
//   fp32  mul      FMUL by 1.0001
//         exp      __expf: FMUL by log2(e) + MUFU.EX2 (what exp_attention.cu
//                  and crf_apply.cu use)
//         exp2     ex2.approx.ftz.f32: MUFU.EX2 alone
//         exp_min  FMNMX with 60 + __expf
//         tanh     tanh.approx.f32: MUFU.TANH
//         expf     the accurate library expf (range reduction and polynomial
//                  around MUFU.EX2), for comparison with __expf
//   bf16  (two elements packed in one register, bf16x2 instructions)
//         mul      HMUL2 by bf16(1.0001) = 1
//         exp      h2exp: unpack, two fp32 FMUL + MUFU.EX2, one packed
//                  convert (what crf_apply_bf16.cu uses)
//         exp2     h2exp2: ex2.approx.ftz.bf16x2
//         exp_min  HMNMX2 with 60 + h2exp
//         tanh     tanh.approx.bf16x2
// The feedback is an FFMA in fp32 and HMUL2 + HADD2 (each rounded) in bf16;
// the accumulation an FADD or HADD2.
//
// Bound.  No memory traffic to speak of (8 or 4 bytes an element, once).
// Every variant but mul executes one special-function instruction per element
// and pass (the packed bf16 forms possibly one per pair), at 16 lanes a
// clock and SM against 128 for fp32 arithmetic: the special-function unit
// binds them; mul is bound by the fp32 (or packed bf16) instruction rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Fn { kMul = 0, kExp = 1, kExp2 = 2, kExpMin = 3, kTanh = 4, kExpf = 5 };

template <int FN>
__device__ __forceinline__ float apply_f32(float v) {
  float y;
  if (FN == kMul) return v * 1.0001f;
  if (FN == kExp) return __expf(v);
  if (FN == kExp2) {
    asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
    return y;
  }
  if (FN == kExpMin) return __expf(fminf(v, 60.0f));
  if (FN == kTanh) {
    asm volatile("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(v));
    return y;
  }
  return expf(v);
}

template <int FN>
__global__ void __launch_bounds__(kThreads)
exp_rate_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int64_t n, int iters) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 2;
  if (i >= n) return;
  const bool two = i + 1 < n;
  const float x0 = x[i], x1 = two ? x[i + 1] : 0.f;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
    a0 = a0 + apply_f32<FN>(fmaf(a0, 1e-9f, x0));
    a1 = a1 + apply_f32<FN>(fmaf(a1, 1e-9f, x1));
  }
  out[i] = a0;
  if (two) out[i + 1] = a1;
}

template <int FN>
__device__ __forceinline__ __nv_bfloat162 apply_bf16(__nv_bfloat162 v) {
  if (FN == kMul) return __hmul2_rn(v, __float2bfloat162_rn(1.0001f));
  if (FN == kExp) return h2exp(v);
  if (FN == kExp2) return h2exp2(v);
  if (FN == kExpMin) return h2exp(__hmin2(v, __float2bfloat162_rn(60.0f)));
  uint32_t y, u = *reinterpret_cast<uint32_t*>(&v);
  asm volatile("tanh.approx.bf16x2 %0, %1;" : "=r"(y) : "r"(u));
  return *reinterpret_cast<__nv_bfloat162*>(&y);
}

// Two pairs a thread: four elements, two independent chains of packed ops.
template <int FN>
__global__ void __launch_bounds__(kThreads)
exp_rate_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     __nv_bfloat16* __restrict__ out, int64_t n, int iters) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  __nv_bfloat16 xe[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) xe[j] = i + j < n ? x[i + j] : zero;
  const __nv_bfloat162 x0 = __halves2bfloat162(xe[0], xe[1]);
  const __nv_bfloat162 x1 = __halves2bfloat162(xe[2], xe[3]);
  const __nv_bfloat162 eps = __float2bfloat162_rn(1e-9f);
  __nv_bfloat162 a0 = __float2bfloat162_rn(0.f), a1 = a0;
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
    a0 = __hadd2_rn(a0, apply_bf16<FN>(__hadd2_rn(x0, __hmul2_rn(a0, eps))));
    a1 = __hadd2_rn(a1, apply_bf16<FN>(__hadd2_rn(x1, __hmul2_rn(a1, eps))));
  }
  const __nv_bfloat16 oe[4] = {__low2bfloat16(a0), __high2bfloat16(a0),
                               __low2bfloat16(a1), __high2bfloat16(a1)};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j < n) out[i + j] = oe[j];
}

template <int FN>
void launch(const void* x, void* out, int64_t n, int iters, int is_bf16,
            cudaStream_t stream) {
  const int per_thread = is_bf16 ? 4 : 2;
  const int64_t threads = (n + per_thread - 1) / per_thread;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (is_bf16)
    exp_rate_bf16_kernel<FN><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        n, iters);
  else
    exp_rate_f32_kernel<FN><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, iters);
}

}  // namespace

// x, out: n contiguous elements, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// fn: 0 mul, 1 exp, 2 exp2, 3 exp_min, 4 tanh, 5 expf (fp32 only).  Returns
// cudaGetLastError().
extern "C" int dupl_exp_rate(const void* x, void* out, int64_t n, int iters,
                             int fn, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || iters < 0 || (is_bf16 && fn == kExpf))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (fn) {
    case kMul: launch<kMul>(x, out, n, iters, is_bf16, s); break;
    case kExp: launch<kExp>(x, out, n, iters, is_bf16, s); break;
    case kExp2: launch<kExp2>(x, out, n, iters, is_bf16, s); break;
    case kExpMin: launch<kExpMin>(x, out, n, iters, is_bf16, s); break;
    case kTanh: launch<kTanh>(x, out, n, iters, is_bf16, s); break;
    case kExpf: launch<kExpf>(x, out, n, iters, 0, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
