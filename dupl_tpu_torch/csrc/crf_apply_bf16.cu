// Fused CRF kernel-apply with the scores rounded to bf16 before the exp
// (sm_90a):
//     out[b, i, :] = sum_j exp_bf16(bf16(min(basis[b, i, :] . coef[b, :, j],
//                                            logc[b, j]))) * bf16(vals[b, j, :])
// with fp32 scores, the exp taken on bf16 values and rounded to bf16, and
// fp32 accumulation.
//
// Replaces the Pallas TPU kernel tools/crf_apply_experiment.py:_kernel16
// (launched by pallas16), the bf16-exp variant of the CRF kernel-apply
// (crf_apply.cu is the fp32-exp form).  Same numerics: the 11-wide score and
// the clamp at logc in fp32, that clamped score rounded to bf16, the kernel
// entry k = exp of it as a bf16 value, the values rounded to bf16, fp32 sums.
// A pivot with logc = -inf gives k = exactly 0.
//
// Design.  k in bf16 is exactly the A operand of a tensor-core product, so
// here the value product runs on mma.sync.m16n8k16 (crf_apply.cu spends V of
// its 11 + V fp32 FMAs an entry on it).  A warp owns 32 pixels (two 16-row
// m-tiles); in the fragment layout each thread holds rows g and g+8 of both,
// so it keeps four pixels' 11-wide basis rows in registers and, per 16-pivot
// k-step, computes their scores against its four pivots (columns 2t, 2t+1,
// 2t+8, 2t+9): 256 scores a warp and m-tile, none twice.  Neighbouring
// pivots pack into one bf16x2 register: one cvt rounds both clamped scores,
// h2exp takes both exps, and the result is the A fragment as it stands.  A
// block of four warps (128 pixels) loops over tiles of 128 pivots staged in
// shared memory: each pivot's 11 coefficients and logc as three float4s, its
// values rounded to bf16 and stored transposed, zero-padded to 8 * NT
// columns.  Pivots past Ns are staged with logc = -inf and zero values;
// pixels past N are computed and not stored.  The (N, Ns) kernel matrix
// never exists in memory.
//
// Bound.  Per (pixel, pivot) entry 11 fp32 FMAs, a min, half a convert and an
// exp, and 2 * 8 * NT tensor-core FLOPs, against 44 + 4V bytes per pixel in
// and out: compute-bound, on the fp32 pipes (the score) and the
// special-function unit (the exp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kDim = 11;     // basis width: (f^2, f, 1) of 5-D features
constexpr int kThreads = 128;
constexpr int kPixels = 128; // pixels per block: 4 warps x 2 m-tiles x 16
constexpr int kTile = 128;   // pivots per shared-memory tile

__device__ __forceinline__ float score(const float f[kDim], const float4 c0,
                                       const float4 c1, const float4 c2) {
  float s = f[0] * c0.x;
  s = fmaf(f[1], c0.y, s);
  s = fmaf(f[2], c0.z, s);
  s = fmaf(f[3], c0.w, s);
  s = fmaf(f[4], c1.x, s);
  s = fmaf(f[5], c1.y, s);
  s = fmaf(f[6], c1.z, s);
  s = fmaf(f[7], c1.w, s);
  s = fmaf(f[8], c2.x, s);
  s = fmaf(f[9], c2.y, s);
  s = fmaf(f[10], c2.z, s);
  return fminf(s, c2.w);  // the clamp at logc
}

// exp of two clamped fp32 scores, rounded to bf16 first and taken in bf16:
// the packed pair is one A-fragment register.
__device__ __forceinline__ uint32_t exp_bf16x2(float lo, float hi) {
  const __nv_bfloat162 e = h2exp(__floats2bfloat162_rn(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&e);
}

template <int NT>  // 8-wide n-tiles of the value columns
__global__ void __launch_bounds__(kThreads)
crf_apply_bf16_kernel(const float* __restrict__ basis,
                      const float* __restrict__ coef,
                      const float* __restrict__ logc,
                      const float* __restrict__ vals, float* __restrict__ out,
                      int n, int ns, int nv) {
  __shared__ float4 cf[kTile][3];  // coef[0..10] of pivot j, then logc
  __shared__ __align__(16) __nv_bfloat16 vt[8 * NT][kTile + 8];  // [col][pivot]

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* cb = coef + static_cast<int64_t>(b) * kDim * ns;
  const float* lb = logc + static_cast<int64_t>(b) * ns;
  const float* vb = vals + static_cast<int64_t>(b) * ns * nv;

  // This thread's four pixels: rows g and g+8 of the warp's two m-tiles.
  int pix[4];
  float f[4][kDim];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    pix[r] = blockIdx.x * kPixels + warp * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
    const float* bb = basis + (static_cast<int64_t>(b) * n + pix[r]) * kDim;
#pragma unroll
    for (int d = 0; d < kDim; ++d) f[r][d] = pix[r] < n ? bb[d] : 0.f;
  }
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.f;

  for (int j0 = 0; j0 < ns; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int jj = threadIdx.x; jj < kTile; jj += kThreads) {
      const int j = j0 + jj;
      float c[12];
#pragma unroll
      for (int d = 0; d < kDim; ++d) c[d] = j < ns ? cb[d * ns + j] : 0.f;
      c[11] = j < ns ? lb[j] : -CUDART_INF_F;
      cf[jj][0] = make_float4(c[0], c[1], c[2], c[3]);
      cf[jj][1] = make_float4(c[4], c[5], c[6], c[7]);
      cf[jj][2] = make_float4(c[8], c[9], c[10], c[11]);
      const float* src = vb + static_cast<int64_t>(j) * nv;
#pragma unroll
      for (int c2 = 0; c2 < 8 * NT; ++c2)
        vt[c2][jj] = __float2bfloat16_rn(j < ns && c2 < nv ? src[c2] : 0.f);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kTile / 16; ++kk) {
      // Clamped scores of the four pixels against this thread's four pivots
      // of the k-step, in fragment column order 2t, 2t+1, 2t+8, 2t+9.
      float s[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int jj = kk * 16 + t * 2 + (p & 1) + (p >> 1) * 8;
        const float4 c0 = cf[jj][0], c1 = cf[jj][1], c2 = cf[jj][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) s[r][p] = score(f[r], c0, c1, c2);
      }
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        a[m][0] = exp_bf16x2(s[2 * m][0], s[2 * m][1]);          // row g
        a[m][1] = exp_bf16x2(s[2 * m + 1][0], s[2 * m + 1][1]);  // row g + 8
        a[m][2] = exp_bf16x2(s[2 * m][2], s[2 * m][3]);
        a[m][3] = exp_bf16x2(s[2 * m + 1][2], s[2 * m + 1][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* vr = &vt[nt * 8 + g][kk * 16 + t * 2];
        const uint32_t bf[2] = {ld32(vr), ld32(vr + 8)};
        mma_bf16_16816(acc[0][nt], a[0], bf);
        mma_bf16_16816(acc[1][nt], a[1], bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (pix[r] >= n) continue;
    float* ob = out + (static_cast<int64_t>(b) * n + pix[r]) * nv;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + t * 2;
      const float* a4 = acc[r >> 1][nt];
      if (c < nv) ob[c] = a4[(r & 1) * 2];
      if (c + 1 < nv) ob[c + 1] = a4[(r & 1) * 2 + 1];
    }
  }
}

template <int NT>
void launch(const void* basis, const void* coef, const void* logc,
            const void* vals, void* out, int batch, int n, int ns, int nv,
            cudaStream_t stream) {
  const dim3 grid((n + kPixels - 1) / kPixels, batch);
  crf_apply_bf16_kernel<NT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(basis), static_cast<const float*>(coef),
      static_cast<const float*>(logc), static_cast<const float*>(vals),
      static_cast<float*>(out), n, ns, nv);
}

}  // namespace

// basis (B, N, 11), coef (B, 11, Ns), logc (B, Ns), vals (B, Ns, V), out
// (B, N, V): fp32, contiguous, 1 <= V <= 32.  Returns cudaGetLastError().
extern "C" int dupl_crf_apply_bf16(const void* basis, const void* coef,
                                   const void* logc, const void* vals,
                                   void* out, int batch, int n, int ns, int nv,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nv < 1 || nv > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (nv <= 8) launch<1>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nv <= 16) launch<2>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nv <= 24) launch<3>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else launch<4>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  return static_cast<int>(cudaGetLastError());
}
