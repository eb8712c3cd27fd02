// Fused CRF kernel-apply with the scores rounded to bf16 before the exp
// (sm_90a):
//     out[b, i, :] = sum_j bf16(exp(bf16(min(basis[b, i, :] . coef[b, :, j],
//                                            logc[b, j])))) * bf16(vals[b, j, :])
// with an fp32 score, the exp taken of the bf16 value and rounded to bf16,
// and fp32 sums.  Any number of value columns.
//
// Replaces the Pallas TPU kernel tools/crf_apply_experiment.py:_kernel16
// (launched by pallas16), the bf16-exp variant of the CRF kernel-apply
// (crf_apply.cu is the fp32-exp form).  A pivot with logc = -inf gives
// k = exactly 0.
//
// Design.  crf_apply.cu's, with the bf16 steps packed.
//  * The score stays an fp32 chain of fused multiply-adds over the 11
//    terms in order, as the plain twin's matrix product sums them on the
//    card.  Scores of order 1 round to bf16 with ulps of 2^-8 to 2^-5, and
//    any other summation order flips a few of those roundings: on the CRF's
//    own operands, whose colour terms reach ~2,600 and cancel, by up to
//    ~1e-3 of a column's largest output (a bf16 split of the score on the
//    tensor cores, emulated on the CPU: tests/test_torch_experiments.py).
//  * The clamp after rounding, in bf16x2.  Rounding is monotone, so
//    bf16(min(s, logc)) = min(bf16(s), bf16(logc)): the raw scores of two
//    neighbouring pivots pack with one cvt.rn.bf16x2, logc's pair with
//    another, and one min.bf16x2 clamps both.  The exp is taken of each
//    bf16 value in fp32 (ex2.approx.ftz of x log2(e): two instructions,
//    where __expf with its range fix-up takes four) and the pair rounds to
//    bf16 in one cvt: the A fragment of the value product as it stands.
//  * The value side is crf_apply.cu's: 64-pivot tiles staged by cp.async in
//    a ring of two shared-memory stages (each pivot's 11 coefficients and
//    logc as 12 floats; its values, which the wrapper rounds to bf16 once
//    and zero-pads to a multiple of 8 columns, read by ldmatrix.trans), the
//    product on mma.sync.m16n8k16; up to 96 value columns (12 n-tiles) in
//    one pass, wider calls over the grid's third dimension, 96 columns a
//    layer, each layer computing its own entries.  A column's sum depends on
//    its own values only, so any slice of the columns is bit-equal to a call
//    on that slice alone.  Pivots past Ns are staged with logc = -inf and
//    zero values (the entry is exactly 0); pixels past N are computed and
//    not stored.
//  * Pixels a thread, as crf_apply.cu: a warp owns two 16-row m-tiles, a
//    thread rows g and g+8 of each (four pixels' basis rows in registers),
//    and per 16-pivot k-step scores them against its four pivots (columns
//    2t, 2t+1, 2t+8, 2t+9), each pivot's 12 floats read from shared memory
//    once for the four pixels.  Four m-tiles a warp (half the shared-memory
//    reads an entry) and eight warps a block ran no faster on the card.
//
// Bound.  Per (pixel, pivot) entry: 11 fp32 FMAs, half a pack and half a
// min.bf16x2, the exp's unpack and multiply, one exp on the
// special-function unit, half a pack, and 2 VP tensor-core FLOPs of the
// value product (VP = V rounded up to 8); against 44 + 4V bytes a pixel:
// the fp32 FMAs (22 FLOPs an entry over 67 TFLOP/s) bound it, in practice
// the ~16 instructions an entry that the schedulers dispatch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kDim = 11;      // basis width: (f^2, f, 1) of 5-D features
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;     // pivots per shared-memory stage
constexpr int kMaxNT = 12;    // n-tiles of one pass: 96 value columns
constexpr int kMTiles = 2;    // 16-row m-tiles a warp
constexpr int kPixels = 16 * kMTiles * kWarps;

// The unclamped fp32 score, summed as the plain twin's matrix product is.
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
  return fmaf(f[10], c2.z, s);
}

// min of two packed bf16 pairs (the clamp at logc).
__device__ __forceinline__ uint32_t min_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// e^x as 2^(x log2(e)) on the special-function unit, without the range
// fix-up of __expf (results below 2^-126 flush to zero: at most 1.2e-38
// an entry, where the twin keeps a subnormal).
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The entries of two scores of neighbouring pivots clamped at their logc
// pair (both bf16x2): bf16(exp(x)) of each bf16 value x, the exp in fp32.
__device__ __forceinline__ uint32_t entries(float lo, float hi, uint32_t lc) {
  const uint32_t x = min_bf16x2(pack_bf16(lo, hi), lc);
  return pack_bf16(exp_ftz(__uint_as_float(x << 16)),
                   exp_ftz(__uint_as_float(x & 0xffff0000u)));
}

template <int NT>  // 8-wide n-tiles of the value columns in one pass
__global__ void __launch_bounds__(kThreads)
crf_apply_bf16_kernel(const float* __restrict__ basis,
                      const float* __restrict__ coef,
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
  int pix[2 * kMTiles];
  float f[2 * kMTiles][kDim];
#pragma unroll
  for (int r = 0; r < 2 * kMTiles; ++r) {
    pix[r] = blockIdx.x * kPixels + warp * 16 * kMTiles + (r >> 1) * 16 +
             (r & 1) * 8 + g;
    const float* bb = basis + (static_cast<int64_t>(b) * n + pix[r]) * kDim;
#pragma unroll
    for (int d = 0; d < kDim; ++d) f[r][d] = pix[r] < n ? bb[d] : 0.f;
  }
  float acc[kMTiles][NT][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
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
      // A fragments: for each pivot pair h (columns 2t, 2t+1 of n-tile h),
      // the entries of every pixel row, row g in a[m][2h], g+8 in a[m][2h+1].
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jj = kk * 16 + h * 8 + t * 2;
        const float4* c4 = reinterpret_cast<const float4*>(cf[s][jj]);
        const float4 c0 = c4[0], c1 = c4[1], c2 = c4[2];
        const float4 d0 = c4[3], d1 = c4[4], d2 = c4[5];  // pivot jj + 1
        const uint32_t lc = pack_bf16(c2.w, d2.w);
#pragma unroll
        for (int r = 0; r < 2 * kMTiles; ++r)
          a[r >> 1][2 * h + (r & 1)] =
              entries(score(f[r], c0, c1, c2), score(f[r], d0, d1, d2), lc);
      }
      const uint32_t vrow = vs_lane + s * kStageBytes + kk * 16 * kStride * 2;
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vrow + nt * 16);
        const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          mma_bf16_16816(acc[m][nt], a[m], b0);
          mma_bf16_16816(acc[m][nt + 1], a[m], b1);
        }
      }
      if constexpr (NT % 2) {
        uint32_t bf[2];
        ldsm_x2_trans(bf, vrow + (NT - 1) * 16);
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) mma_bf16_16816(acc[m][NT - 1], a[m], bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2 * kMTiles; ++r) {
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
  crf_apply_bf16_kernel<NT><<<grid, kThreads, 0, stream>>>(
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
extern "C" int dupl_crf_apply_bf16(const void* basis, const void* coef,
                                   const void* logc, const void* vals,
                                   void* out, int batch, int n, int ns, int nv,
                                   void* stream) {
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
