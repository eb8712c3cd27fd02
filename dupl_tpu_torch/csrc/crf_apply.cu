// Fused CRF kernel-apply for Hopper (sm_90a):
//     out[b, i, :] = sum_j bf16(exp(min(basis[b, i, :] . coef[b, :, j],
//                                       logc[b, j]))) * bf16(vals[b, j, :])
// with fp32 scores and fp32 accumulation.
//
// Replaces the Pallas TPU kernel dupl_tpu/ops/crf_pallas.py:_kernel
// (launched by crf_pallas.kernel_apply), the full-resolution slice of the
// mean-field CRF (dupl_tpu/ops/crf.py:cross_apply): once in the fast CRF,
// 1 + 10 times a batch in the full CRF of evaluation.  Same numerics: the
// 11-wide score in fp32 (summed in the order written below), the clamp at
// logc, the exp in fp32 (__expf), the kernel entry rounded to bf16 (RN),
// the values rounded to bf16 (RN), fp32 sums.  Only the order of the fp32
// sums of the value product differs from the plain version.
//
// Design.  A bf16 x bf16 product is exact in fp32, so the value product
// runs on the tensor cores (mma.sync.m16n8k16, fp32 accumulation) at the
// function's own precision; the score and the exp stay on the fp32 pipes
// and the special-function unit.  A warp owns 32 pixels (two 16-row
// m-tiles); in the fragment layout of mma_bf16.cuh each thread holds rows g
// and g+8 of both, so it keeps four pixels' 11-wide basis rows in registers
// and, per 16-pivot k-step, computes their clamped scores against its four
// pivots (columns 2t, 2t+1, 2t+8, 2t+9): one coefficient load (three
// float4 broadcasts, shared by the 8 lanes of a t) serves four pixels, and
// every (pixel, pivot) score and exp is computed once, by one thread.  The
// exps of neighbouring pivots pack into one bf16x2 register (one cvt.rn
// rounds both), which is the A fragment as it stands: the (N, Ns) kernel
// matrix never reaches shared or device memory.  Every value column takes
// the same entries: at V 82 (COCO's fast mode) the 88 padded columns are 11
// n-tiles of the one pass.  A block of four warps (128 pixels) loops over
// tiles of 64 pivots that cp.async stages into a ring of two shared-memory
// stages, the next tile in flight while the block computes on the current
// one: each pivot's 11 coefficients and logc as 12 floats, and its values,
// which the wrapper rounds to bf16 once and zero-pads to a multiple of 8
// columns, pivot-major as 16-byte chunks, read as B fragments by
// ldmatrix.trans (the row stride an odd number of 16-byte units: no bank
// conflicts).  Pivots past Ns are staged with logc = -inf and zero values
// (the entry is exactly 0) and the last tile's k-steps stop at the first
// 16 past Ns; pixels past N are computed and not stored.  The ring
// matters at wide V: staged between two barriers with plain loads, 88
// columns stalled the two blocks that fit an SM (3x V 22 on the card).  Up
// to 96 value columns (12 n-tiles, every caller: VOC 21/22, COCO 81/82) run
// in one pass; wider calls take the grid's third dimension, 96 columns a
// layer, each layer computing its own entries.  A column's sum depends on
// its own values only, so any 32-column slice of a call is bit-equal to a
// call on that slice alone.
//
// Bound.  Per (pixel, pivot) entry: 11 fp32 FMAs, a min, the exp's
// multiply (and its range fix-up), half a convert, one special-function
// exp, and 2 * 8 * NT tensor-core FLOPs, against 44 + 4V bytes a pixel in
// and out: bound by the fp32 pipes' issue (~15 instructions an entry); the
// exp (1 an entry at 16 a clock an SM) and the tensor cores (busy an eighth
// of the time at V 82 on the card) run beside it.  Measured against the least time the card
// could take (the largest of 22 fp32 FLOPs an entry over 67 TFLOP/s, an exp
// over 4.19e12/s, 2 VP FLOPs over 989 TFLOP/s and the bytes over 3.35
// TB/s): see PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kDim = 11;      // basis width: (f^2, f, 1) of 5-D features
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPixels = 32 * kWarps;  // two 16-row m-tiles a warp
constexpr int kTile = 64;     // pivots per shared-memory stage
constexpr int kMaxNT = 12;    // n-tiles of one pass: 96 value columns

__device__ __forceinline__ float score(const float (&f)[kDim], const float4 c0,
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

// The entries of two clamped scores, exp in fp32 and each rounded to bf16:
// one A-fragment register, `lo` in the low half (the lower pivot).
__device__ __forceinline__ uint32_t entries(float lo, float hi) {
  return pack_bf16(__expf(lo), __expf(hi));
}

template <int NT>  // 8-wide n-tiles of the value columns in one pass
__global__ void __launch_bounds__(kThreads)
crf_apply_kernel(const float* __restrict__ basis, const float* __restrict__ coef,
                 const float* __restrict__ logc,
                 const __nv_bfloat16* __restrict__ vals,
                 float* __restrict__ out, int n, int ns, int nv) {
  constexpr int kVP = 8 * NT;
  // Row stride of the value tile in bf16: an odd number of 16-byte units,
  // so the eight row addresses of an ldmatrix phase hit distinct banks.
  constexpr int kStride = (NT % 2 ? NT : NT + 1) * 8;
  // coef[0..10] of pivot j, then logc; two stages
  __shared__ __align__(16) float cf[2][kTile][12];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kTile][kStride];  // [pivot][col]

  const int b = blockIdx.y;
  const int col0 = blockIdx.z * kVP;
  const int ld = (nv + 7) / 8 * 8;     // the values' row length (bf16)
  const int nc = min(kVP, nv - col0);  // value columns of this pass
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* cb = coef + static_cast<int64_t>(b) * kDim * ns;
  const float* lb = logc + static_cast<int64_t>(b) * ns;
  const __nv_bfloat16* vb = vals + static_cast<int64_t>(b) * ns * ld + col0;

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

  // Stage pivot tile `tile` into stage s: a thread a pivot copies its 11
  // coefficients and logc, and the block copies the values 16 bytes (an
  // n-tile's 8 columns) at a time; pivots past Ns and columns past the
  // values' row get logc = -inf and zeros, so their entries and products
  // are exactly 0.
  auto stage = [&](int tile, int s) {
    const int j0 = tile * kTile;
    if (threadIdx.x < kTile) {
      const int j = j0 + threadIdx.x;
      float* c = cf[s][threadIdx.x];
      if (j < ns) {
#pragma unroll
        for (int d = 0; d < kDim; ++d) cp_async4(c + d, cb + d * ns + j);
        cp_async4(c + kDim, lb + j);
      } else {
#pragma unroll
        for (int d = 0; d < kDim; ++d) c[d] = 0.f;
        c[kDim] = -CUDART_INF_F;
      }
    }
    for (int idx = threadIdx.x; idx < kTile * NT; idx += kThreads) {
      const int jj = idx / NT, q = idx - jj * NT;
      const int j = j0 + jj;
      __nv_bfloat16* v = &vs[s][jj][q * 8];
      if (j < ns && col0 + q * 8 < ld)
        cp_async16(v, vb + static_cast<int64_t>(j) * ld + q * 8);
      else
        *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // ldmatrix row address of this lane in stage 0: pivot row (lane & 15) of
  // n-tile (lane >> 4), at k-step 0 and n-tile pair 0.
  const uint32_t vs_lane = __cvta_generic_to_shared(
      &vs[0][lane & 15][(lane >> 4) * 8]);
  constexpr uint32_t kStageBytes = kTile * kStride * 2;

  const int tiles = (ns + kTile - 1) / kTile;
  stage(0, 0);
  for (int tile = 0; tile < tiles; ++tile) {
    // This thread's copies of the tile have landed; the barrier publishes
    // everyone's and marks the other stage, read by the previous tile, free.
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (tile + 1 < tiles) stage(tile + 1, (tile + 1) & 1);
    const int s = tile & 1;

    const int steps = (min(kTile, ns - tile * kTile) + 15) / 16;
#pragma unroll 2
    for (int kk = 0; kk < steps; ++kk) {
      // Clamped scores of the four pixels against this thread's four pivots
      // of the k-step, in fragment column order 2t, 2t+1, 2t+8, 2t+9.
      float sc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int jj = kk * 16 + t * 2 + (p & 1) + (p >> 1) * 8;
        const float4* c4 = reinterpret_cast<const float4*>(cf[s][jj]);
        const float4 c0 = c4[0], c1 = c4[1], c2 = c4[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[r][p] = score(f[r], c0, c1, c2);
      }
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        a[m][0] = entries(sc[2 * m][0], sc[2 * m][1]);          // row g
        a[m][1] = entries(sc[2 * m + 1][0], sc[2 * m + 1][1]);  // row g + 8
        a[m][2] = entries(sc[2 * m][2], sc[2 * m][3]);
        a[m][3] = entries(sc[2 * m + 1][2], sc[2 * m + 1][3]);
      }
      const uint32_t vrow = vs_lane + s * kStageBytes + kk * 16 * kStride * 2;
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vrow + nt * 16);
        const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
        mma_bf16_16816(acc[0][nt], a[0], b0);
        mma_bf16_16816(acc[1][nt], a[1], b0);
        mma_bf16_16816(acc[0][nt + 1], a[0], b1);
        mma_bf16_16816(acc[1][nt + 1], a[1], b1);
      }
      if constexpr (NT % 2) {
        uint32_t bf[2];
        ldsm_x2_trans(bf, vrow + (NT - 1) * 16);
        mma_bf16_16816(acc[0][NT - 1], a[0], bf);
        mma_bf16_16816(acc[1][NT - 1], a[1], bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (pix[r] >= n) continue;
    float* ob = out + (static_cast<int64_t>(b) * n + pix[r]) * nv + col0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + t * 2;
      const float* a4 = acc[r >> 1][nt];
      if (c < nc) ob[c] = a4[(r & 1) * 2];
      if (c + 1 < nc) ob[c + 1] = a4[(r & 1) * 2 + 1];
    }
  }
}

template <int NT>
void launch(const void* basis, const void* coef, const void* logc,
            const void* vals, void* out, int batch, int n, int ns, int nv,
            cudaStream_t stream) {
  const dim3 grid((n + kPixels - 1) / kPixels, batch,
                  (nv + 8 * NT - 1) / (8 * NT));
  crf_apply_kernel<NT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(basis), static_cast<const float*>(coef),
      static_cast<const float*>(logc),
      static_cast<const __nv_bfloat16*>(vals), static_cast<float*>(out), n,
      ns, nv);
}

}  // namespace

// basis (B, N, 11), coef (B, 11, Ns), logc (B, Ns), out (B, N, V): fp32;
// vals (B, Ns, VP8): the values rounded to bf16 and zero-padded to VP8 = V
// rounded up to a multiple of 8 columns; all contiguous, V >= 1.  Returns
// cudaGetLastError().
extern "C" int dupl_crf_apply(const void* basis, const void* coef,
                              const void* logc, const void* vals, void* out,
                              int batch, int n, int ns, int nv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nv < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (nv + 7) / 8;  // n-tiles the width needs
  if (nt <= 1) launch<1>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nt <= 2) launch<2>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nt <= 3) launch<3>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nt <= 4) launch<4>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nt <= 6) launch<6>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nt <= 8) launch<8>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nt <= 11) launch<11>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else launch<kMaxNT>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  return static_cast<int>(cudaGetLastError());
}
