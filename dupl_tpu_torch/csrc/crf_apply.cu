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
// image; the block loops over tiles of 128 pivots staged in shared memory
// (each pivot's 11 coefficients plus logc as three float4s, its values
// rounded to bf16 and zero-padded to VP columns).  Every thread reads the
// same pivot at the same time, so the shared-memory reads are broadcasts;
// the per-pixel basis row and the VP accumulators live in registers.  The
// (N, Ns) kernel matrix never exists in memory: the plain version writes and
// re-reads it (fp32 scores, then bf16 entries) tile by tile.  Pivots past
// Ns are never visited; pixels past N are computed and not stored.
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int VP>
__global__ void __launch_bounds__(kThreads)
crf_apply_kernel(const float* __restrict__ basis, const float* __restrict__ coef,
                 const float* __restrict__ logc, const float* __restrict__ vals,
                 float* __restrict__ out, int n, int ns, int nv) {
  __shared__ float4 cf[kTile][3];       // coef[0..10] of pivot j, then logc
  __shared__ float4 vs[kTile][VP / 4];  // bf16-rounded values, zero-padded

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* bb = basis + (static_cast<int64_t>(b) * n + i) * kDim;
  const float* cb = coef + static_cast<int64_t>(b) * kDim * ns;
  const float* lb = logc + static_cast<int64_t>(b) * ns;
  const float* vb = vals + static_cast<int64_t>(b) * ns * nv;

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
      for (int c2 = 0; c2 < VP; ++c2) vrow[c2] = c2 < nv ? bf16_round(src[c2]) : 0.f;
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
    float* ob = out + (static_cast<int64_t>(b) * n + i) * nv;
#pragma unroll
    for (int c = 0; c < VP; ++c)
      if (c < nv) ob[c] = acc[c];
  }
}

template <int VP>
void launch(const void* basis, const void* coef, const void* logc,
            const void* vals, void* out, int batch, int n, int ns, int nv,
            cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  crf_apply_kernel<VP><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(basis), static_cast<const float*>(coef),
      static_cast<const float*>(logc), static_cast<const float*>(vals),
      static_cast<float*>(out), n, ns, nv);
}

}  // namespace

// basis (B, N, 11), coef (B, 11, Ns), logc (B, Ns), vals (B, Ns, V), out
// (B, N, V): fp32, contiguous, 1 <= V <= 32.  Returns cudaGetLastError().
extern "C" int dupl_crf_apply(const void* basis, const void* coef,
                              const void* logc, const void* vals, void* out,
                              int batch, int n, int ns, int nv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nv <= 4) launch<4>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nv <= 8) launch<8>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nv <= 16) launch<16>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nv <= 24) launch<24>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else if (nv <= 32) launch<32>(basis, coef, logc, vals, out, batch, n, ns, nv, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
