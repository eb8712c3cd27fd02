// Fused CRF kernel-apply for Hopper (sm_90a):
//     out[b, i, :] = sum_j bf16(exp(min(basis[b, i, :] . coef[b, :, j],
//                                       logc[b, j]))) * bf16(vals[b, j, :])
// with fp32 scores and fp32 accumulation.
//
// Replaces the Pallas TPU kernel dupl_tpu/ops/crf_pallas.py:_kernel
// (launched by crf_pallas.kernel_apply), the full-resolution slice of the
// fast mean-field CRF (dupl_tpu/ops/crf.py:cross_apply).  Same numerics: the
// 11-wide score in fp32, the clamp at logc, the kernel entry rounded to
// bf16, the values rounded to bf16, fp32 sums.
//
// Design.  One thread per pixel row, 128 pixels per block, one grid row per
// image, one grid layer per group of at most 32 value columns; the block
// loops over tiles of 128 pivots staged in shared memory (each pivot's 11
// coefficients plus logc as three float4s, its group's values rounded to
// bf16 and zero-padded to VP columns).  Every thread reads the same pivot at
// the same time, so the shared-memory reads are broadcasts; the per-pixel
// basis row and the VP accumulators live in registers.  The (N, Ns) kernel
// matrix never exists in memory: the plain version writes and re-reads it
// (fp32 scores, then bf16 entries) tile by tile.  Pivots past Ns are never
// visited; pixels past N are computed and not stored.
//
// Any V.  The Pallas kernel pads V to 128 lanes and takes any width; here V
// is cut into column groups of 32 (V 82, COCO's fast mode: 32 + 32 + 18),
// all in the one launch.  A group stages, accumulates and writes only its
// own columns, and repeats the 11-wide score and the exp: each column is
// computed exactly as a call on that group's columns alone would compute it
// (the same fp32 score, the same bf16 entry, fp32 sums in pivot order).
// Full groups run at VP 32, the last, partial one at the VP its width needs,
// so V <= 32 runs as before.
//
// Bound.  Per (pixel, pivot) entry: 11 FMAs, a min, an exp, a bf16 round
// and V FMAs, against 44 + 4V bytes per pixel in and out: compute-bound on
// the fp32 pipes (about 35 instructions an entry at V = 22; the slice runs
// 200,704 x 3,136 entries per 448^2 image).  The value product could move
// to the tensor cores (bf16 in, fp32 accumulate, as mma.sync computes) in a
// later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 11;     // basis width: (f^2, f, 1) of 5-D features
constexpr int kThreads = 128;
constexpr int kTile = 128;   // pivots per shared-memory tile
constexpr int kGroup = 32;   // value columns of a grid layer

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Columns [col0, col0 + VP) of the output, VP zero-padded past nv.
template <int VP>
__device__ __forceinline__ void apply_group(
    const float* __restrict__ basis, const float* __restrict__ coef,
    const float* __restrict__ logc, const float* __restrict__ vals,
    float* __restrict__ out, int n, int ns, int nv, int col0, float4 (*cf)[3],
    float4* vs_raw) {
  float4 (*vs)[VP / 4] = reinterpret_cast<float4 (*)[VP / 4]>(vs_raw);
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int nc = min(VP, nv - col0);  // columns of this group
  const float* bb = basis + (static_cast<int64_t>(b) * n + i) * kDim;
  const float* cb = coef + static_cast<int64_t>(b) * kDim * ns;
  const float* lb = logc + static_cast<int64_t>(b) * ns;
  const float* vb = vals + static_cast<int64_t>(b) * ns * nv + col0;

  float f[kDim];
#pragma unroll
  for (int d = 0; d < kDim; ++d) f[d] = i < n ? bb[d] : 0.f;
  float acc[VP];
#pragma unroll
  for (int c = 0; c < VP; ++c) acc[c] = 0.f;

  for (int j0 = 0; j0 < ns; j0 += kTile) {
    const int nt = min(kTile, ns - j0);
    __syncthreads();  // the previous tile is consumed
    for (int jj = threadIdx.x; jj < nt; jj += kThreads) {
      float c[12];
#pragma unroll
      for (int d = 0; d < kDim; ++d) c[d] = cb[d * ns + j0 + jj];  // coalesced
      c[11] = lb[j0 + jj];
      cf[jj][0] = make_float4(c[0], c[1], c[2], c[3]);
      cf[jj][1] = make_float4(c[4], c[5], c[6], c[7]);
      cf[jj][2] = make_float4(c[8], c[9], c[10], c[11]);
      float* vrow = reinterpret_cast<float*>(vs[jj]);
      const float* src = vb + static_cast<int64_t>(j0 + jj) * nv;
#pragma unroll
      for (int c2 = 0; c2 < VP; ++c2) vrow[c2] = c2 < nc ? bf16_round(src[c2]) : 0.f;
    }
    __syncthreads();

    for (int jj = 0; jj < nt; ++jj) {
      const float4 c0 = cf[jj][0], c1 = cf[jj][1], c2 = cf[jj][2];
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
      const float e = bf16_round(__expf(fminf(s, c2.w)));
#pragma unroll
      for (int c4 = 0; c4 < VP / 4; ++c4) {
        const float4 x = vs[jj][c4];
        acc[4 * c4 + 0] = fmaf(e, x.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(e, x.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(e, x.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(e, x.w, acc[4 * c4 + 3]);
      }
    }
  }

  if (i < n) {
    float* ob = out + (static_cast<int64_t>(b) * n + i) * nv + col0;
#pragma unroll
    for (int c = 0; c < VP; ++c)
      if (c < nc) ob[c] = acc[c];
  }
}

// Grid layer z is column group z: groups before the last run at VP 32, the
// last at VP_LAST.  With one group (V <= 32) the VP 32 path is not compiled
// in, so it costs no registers or shared memory.
template <int VP_LAST, bool kGroups>
__global__ void __launch_bounds__(kThreads)
crf_apply_kernel(const float* __restrict__ basis, const float* __restrict__ coef,
                 const float* __restrict__ logc, const float* __restrict__ vals,
                 float* __restrict__ out, int n, int ns, int nv) {
  constexpr int kVP = kGroups ? kGroup : VP_LAST;
  __shared__ float4 cf[kTile][3];          // coef[0..10] of pivot j, then logc
  __shared__ float4 vs[kTile * kVP / 4];   // bf16-rounded values, zero-padded
  const int col0 = blockIdx.z * kGroup;
  if constexpr (kGroups) {
    if (blockIdx.z + 1 < gridDim.z) {
      apply_group<kGroup>(basis, coef, logc, vals, out, n, ns, nv, col0, cf, vs);
      return;
    }
  }
  apply_group<VP_LAST>(basis, coef, logc, vals, out, n, ns, nv, col0, cf, vs);
}

template <int VP_LAST>
void launch(const void* basis, const void* coef, const void* logc,
            const void* vals, void* out, int batch, int n, int ns, int nv,
            cudaStream_t stream) {
  const int groups = (nv + kGroup - 1) / kGroup;
  const dim3 grid((n + kThreads - 1) / kThreads, batch, groups);
  const float* args[4] = {static_cast<const float*>(basis),
                          static_cast<const float*>(coef),
                          static_cast<const float*>(logc),
                          static_cast<const float*>(vals)};
  if (groups > 1)
    crf_apply_kernel<VP_LAST, true><<<grid, kThreads, 0, stream>>>(
        args[0], args[1], args[2], args[3], static_cast<float*>(out), n, ns, nv);
  else
    crf_apply_kernel<VP_LAST, false><<<grid, kThreads, 0, stream>>>(
        args[0], args[1], args[2], args[3], static_cast<float*>(out), n, ns, nv);
}

}  // namespace

// basis (B, N, 11), coef (B, 11, Ns), logc (B, Ns), vals (B, Ns, V), out
// (B, N, V): fp32, contiguous, V >= 1.  Returns cudaGetLastError().
extern "C" int dupl_crf_apply(const void* basis, const void* coef,
                              const void* logc, const void* vals, void* out,
                              int batch, int n, int ns, int nv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nv < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int last = nv - (nv - 1) / kGroup * kGroup;  // columns of the last group
  if (last <= 4) launch<4>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (last <= 8) launch<8>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (last <= 16) launch<16>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (last <= 24) launch<24>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else launch<32>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  return static_cast<int>(cudaGetLastError());
}
