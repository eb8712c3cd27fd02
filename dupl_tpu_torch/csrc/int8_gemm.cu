// Kernel Q2: the w8a8 product of the int8 inference path for Hopper
// (sm_90a):
//     C[m, n] = (f32(sum_k A[m, k] B[n, k]) * sa[m]) * sw[n]
//     or, with a bias, fma(f32(sum_k ...) * sa[m], sw[n], bias[n])
// A (M, K) int8 row-major (the quantized activations), B (N, K) int8
// row-major (the quantized nn.Linear weight), sa (M, 1), sw (N, 1) and bias
// (N,) fp32 -> C (M, N) fp32.  The int32 sum is exact, so C is bit for bit
// int8_linear_ref (dupl_tpu_torch/ops/quant.py) in any order of k; the
// rescale is two fp32 products in the JAX package's order (y * s_a * s_w,
// dupl_tpu/ops/quant.py), and QDense's bias add is fused with the second
// product, as XLA's CPU code contracts them under jit (__fmul_rn for the
// products that round on their own, __fmaf_rn for the one that does not).
//
// Replaces no Pallas kernel: the JAX package's int8 dot_general goes to
// XLA.  Design (simple and correct first; wgmma is later work): a block of
// 256 threads computes a 128 x 128 tile of C, each of its 8 warps a 64 x 32
// part as 4 x 4 mma.sync.m16n8k32.s8 tiles with int32 accumulators in
// registers.  B (N, K) row-major is the instruction's column operand as it
// stands.  The k loop walks 64-column slices of A and B that cp.async
// stages into two shared-memory stages (the next in flight while the block
// multiplies the current); staged rows are 80 bytes apart, so the 32-bit
// fragment loads of a warp hit 32 different banks.  Rows past M or N and
// columns past K are staged as zeros (cp.async's zero fill), so M and N
// may be ragged; K is a multiple of 32 and N of 8.
//
// Bound.  2 M N K int8 operations on the tensor cores (1,979 TOP/s dense
// on the H100 SXM) against the bytes: A and B read once, C written once in
// fp32.  At ViT-B's fc1 shape (M 12,560, N 3072, K 768) that is 5.93e10
// operations (0.030 ms) and 166 MB (0.050 ms): the fp32 output binds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;
constexpr int kRow = kBK + 16;   // staged row stride in bytes
constexpr int kStages = 2;
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one 64-column slice of a 128-row tile of a (rows, k) int8 matrix: 512
// 16-byte chunks, two a thread
__device__ __forceinline__ void stage(int8_t* dst, const int8_t* src,
                                      int row0, int rows, int k0, int k) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
    const bool valid = row0 + r < rows && k0 + col < k;
    const int8_t* g = valid ? src + static_cast<int64_t>(row0 + r) * k + k0 + col
                            : src;
    cp_async16(dst + r * kRow + col, g, valid);
  }
}

__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ a, const float* __restrict__ sa,
                 const int8_t* __restrict__ b, const float* __restrict__ sw,
                 const float* __restrict__ bias, float* __restrict__ c,
                 int m, int n, int k) {
  __shared__ __align__(16) int8_t sA[kStages][kBM * kRow];
  __shared__ __align__(16) int8_t sB[kStages][kBN * kRow];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * kWarpM, wn = (warp % 4) * kWarpN;
  const int g = lane / 4, t = lane % 4;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int tiles = (k + kBK - 1) / kBK;
  stage(sA[0], a, m0, m, 0, k);
  stage(sB[0], b, n0, n, 0, k);
  cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) {
      stage(sA[(kt + 1) % kStages], a, m0, m, (kt + 1) * kBK, k);
      stage(sB[(kt + 1) % kStages], b, n0, n, (kt + 1) * kBK, k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* tA = sA[kt % kStages];
    const int8_t* tB = sB[kt % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int8_t* p = tA + (wm + i * 16 + g) * kRow + ks + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* p = tB + (wn + j * 8 + g) * kRow + ks + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();   // the next slice's copies overwrite this stage
  }

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = n0 + wn + j * 8 + t * 2;
    if (col >= n) continue;   // n % 8 == 0: col + 1 < n as well
    const float w0 = sw[col], w1 = sw[col + 1];
    const float b0 = bias ? bias[col] : 0.0f;
    const float b1 = bias ? bias[col + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row >= m) continue;
        const float s = sa[row];
        const float y0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), s);
        const float y1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s);
        const float v0 = bias ? __fmaf_rn(y0, w0, b0) : __fmul_rn(y0, w0);
        const float v1 = bias ? __fmaf_rn(y1, w1, b1) : __fmul_rn(y1, w1);
        *reinterpret_cast<float2*>(c + static_cast<int64_t>(row) * n + col) =
            make_float2(v0, v1);
      }
  }
}

}  // namespace

// a (m, k), b (n, k) int8 16-byte aligned; k a multiple of 32, n of 8;
// bias may be null
extern "C" int dupl_int8_gemm(const void* a, const void* sa, const void* b,
                              const void* sw, const void* bias, void* c, int m,
                              int n, int k, void* stream) {
  if (m < 1 || n < 8 || n % 8 || k < 32 || k % 32 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(sa),
      static_cast<const int8_t*>(b), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<float*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
