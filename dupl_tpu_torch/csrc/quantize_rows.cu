// Kernel Q1: dynamic per-row int8 quantization for Hopper (sm_90a):
//     s[r]    = max(amax_k |x[r, k]| * f32(1/127), 1e-8)
//     q[r, k] = clamp(round_half_even(x[r, k] / s[r]), -127, 127)
// for x (R, K) bf16 or fp32 -> q (R, K) int8, s (R, 1) fp32, bit for bit
// with quantize_rows_ref (dupl_tpu_torch/ops/quant.py), which is the
// jitted JAX package's quantization (dupl_tpu/ops/quant.py:
// quantized_matmul: XLA turns max|x| / 127.0 into a product with f32(1/127)
// and keeps x / s an IEEE division).  It quantizes the activations and the
// weights (N, K) of every w8a8 product of the int8 inference path.
//
// Replaces no Pallas kernel: the JAX package leaves this to XLA's fused
// loops.  Design: one warp a row, eight rows a block; the warp reads its
// row in 16-byte chunks for the maximum (a butterfly of shuffles), then
// again (from L1 / L2) to divide (__fdiv_rn: no fast math), round (rintf),
// clamp and store the int8 values as 8- or 4-byte words.
//
// Bound: the bytes, each input read once (2 or 4 bytes an element) and one
// byte an element and four a row written; a division an element on the
// fp32 pipes is far below that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr float kInv127 = 0x1.020408p-7f;   // f32(1/127)
constexpr float kMinScale = 0x1.5798eep-27f;  // f32(1e-8)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t quant(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = q < -127.0f ? -127.0f : q;
  q = q > 127.0f ? 127.0f : q;
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// kVec elements of T make one 16-byte chunk: 8 bf16 or 4 fp32
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int rows, int k) {
  constexpr int kVec = 16 / sizeof(T);
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * k);
  const int chunks = k / kVec;
  float amax = 0.0f;
  for (int c = lane; c < chunks; c += 32) {
    alignas(16) T v[kVec];
    *reinterpret_cast<uint4*>(v) = xr[c];
#pragma unroll
    for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(to_f(v[i])));
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  float sc = __fmul_rn(amax, kInv127);
  sc = sc < kMinScale ? kMinScale : sc;
  int8_t* qr = q + static_cast<int64_t>(row) * k;
  for (int c = lane; c < chunks; c += 32) {
    alignas(16) T v[kVec];
    *reinterpret_cast<uint4*>(v) = xr[c];
    uint32_t w[kVec / 4];
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j)
      w[j] = quant(to_f(v[4 * j]), sc) | quant(to_f(v[4 * j + 1]), sc) << 8 |
             quant(to_f(v[4 * j + 2]), sc) << 16 |
             quant(to_f(v[4 * j + 3]), sc) << 24;
    if constexpr (kVec == 8)
      reinterpret_cast<uint2*>(qr)[c] = make_uint2(w[0], w[1]);
    else
      reinterpret_cast<uint32_t*>(qr)[c] = w[0];
  }
  if (lane == 0) s[row] = sc;
}

}  // namespace

// x (rows, k) contiguous, 16-byte aligned, k a multiple of 8; q 8-byte
// aligned
extern "C" int dupl_quantize_rows(const void* x, void* q, void* s, int rows,
                                  int k, int bf16, void* stream) {
  if (rows < 1 || k < 8 || k % 8 ||
      (reinterpret_cast<uintptr_t>(x) % 16) || (reinterpret_cast<uintptr_t>(q) % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (bf16)
    quantize_rows_kernel<__nv_bfloat16><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qp, sp, rows, k);
  else
    quantize_rows_kernel<float><<<blocks, 32 * kRowsPerBlock, 0, st>>>(
        static_cast<const float*>(x), qp, sp, rows, k);
  return static_cast<int>(cudaGetLastError());
}
