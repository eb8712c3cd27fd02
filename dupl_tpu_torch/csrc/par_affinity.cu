// PAR RGB affinity for Hopper (sm_90a): for every pixel of a (B, H, W, 3)
// float32 image and its K = 8 * len(dilations) taps t_k (8-connected
// neighbours at each dilation, replicate padding),
//     std_c   = unbiased std of the K tap values of channel c
//     l_k     = -mean_c((|t_kc - x_c| * (1/w1) / (std_c + 1e-8))^2)
//     out[k]  = softmax_k(l)_k + pos_k
// written channels-first as (B, K, H, W) float32.
//
// Replaces the Pallas TPU kernel dupl_tpu/ops/par_pallas.py:_aff_kernel
// (launched by par_pallas.affinity_pallas).  Same formula and summation
// order: sum x and sum x^2 over the taps in tap order (dilation-major, then
// ops/par.py OFFSETS order), mean = s1 * (1/K), var = max(s2 - K*mean^2, 0)
// * (1/(K-1)), the channel mean as (z0^2 + z1^2 + z2^2) / 3, then a
// max-subtracted softmax and the position constants, which the host
// computes in float64 as affinity_pallas does.
//
// Design.  One thread per output pixel, 256 pixels of one image per block.
// A thread reads its taps straight from the unpadded image with clamped
// coordinates (replicate padding followed by a slice is a clamp), so the
// host neither pads nor transposes; neighbouring threads read neighbouring
// pixels, and the 48 taps of a block's pixels come from L1/L2.  The K logits
// stay in registers through the softmax.  Output rows of one tap are
// contiguous over the pixels, so the stores coalesce.
//
// Numerics.  var = s2 - K*mean^2 cancels in fp32 where a neighbourhood is
// nearly flat, and a fused multiply-add in sum x^2 moves the result by up
// to ~5e-5 there; the sums therefore use __fmul_rn/__fadd_rn, which nvcc
// does not contract, so the kernel rounds as the plain twin (separate
// multiply and add) does.
//
// Bound.  Per pixel: 2 x K x 3 loads (cached), about 20 K flops and K exps,
// against 12 bytes in and 4K bytes out: at K = 48 the 192 output bytes a
// pixel dominate device-memory traffic (154 MB for 16 images of 224^2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDilations = 6;
constexpr int kMaxTaps = 8 * kMaxDilations;
constexpr int kOffsets[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                {0, 1},   {1, -1}, {1, 0},  {1, 1}};

struct Taps {
  int dy[kMaxTaps];
  int dx[kMaxTaps];
  float pos[kMaxTaps];
};

template <int K>
__global__ void __launch_bounds__(kThreads)
par_affinity_kernel(const float* __restrict__ img, float* __restrict__ out,
                    int h, int w, float inv_w1, Taps taps) {
  const int b = blockIdx.y;
  const int hw = h * w;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int y = pix / w;
  const int x = pix - y * w;
  const float* ib = img + static_cast<int64_t>(b) * hw * 3;

  float s1[3] = {0.f, 0.f, 0.f}, s2[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int yy = min(max(y + taps.dy[k], 0), h - 1);
    const int xx = min(max(x + taps.dx[k], 0), w - 1);
    const float* t = ib + (yy * w + xx) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = t[c];
      s1[c] = __fadd_rn(s1[c], v);
      s2[c] = __fadd_rn(s2[c], __fmul_rn(v, v));
    }
  }
  float xc[3], inv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xc[c] = ib[pix * 3 + c];
    const float mean = __fmul_rn(s1[c], 1.0f / K);
    const float var = __fmul_rn(
        fmaxf(__fsub_rn(s2[c], __fmul_rn(__fmul_rn(static_cast<float>(K), mean),
                                          mean)), 0.f),
        1.0f / (K - 1));
    inv[c] = __fdiv_rn(inv_w1, __fadd_rn(__fsqrt_rn(var), 1e-8f));
  }

  float l[K];
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int yy = min(max(y + taps.dy[k], 0), h - 1);
    const int xx = min(max(x + taps.dx[k], 0), w - 1);
    const float* t = ib + (yy * w + xx) * 3;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float z = __fmul_rn(fabsf(__fsub_rn(t[c], xc[c])), inv[c]);
      q = __fadd_rn(q, __fmul_rn(z, z));
    }
    l[k] = -__fdiv_rn(q, 3.0f);
    mx = fmaxf(mx, l[k]);
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    l[k] = expf(l[k] - mx);
    sum += l[k];
  }
  float* ob = out + static_cast<int64_t>(b) * K * hw + pix;
#pragma unroll
  for (int k = 0; k < K; ++k)
    ob[static_cast<int64_t>(k) * hw] = __fadd_rn(__fdiv_rn(l[k], sum), taps.pos[k]);
}

template <int ND>
void launch(const float* img, float* out, int batch, int h, int w,
            float inv_w1, const Taps& taps, cudaStream_t stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, batch);
  par_affinity_kernel<8 * ND><<<grid, kThreads, 0, stream>>>(img, out, h, w,
                                                             inv_w1, taps);
}

}  // namespace

// img (B, H, W, 3) and out (B, 8*nd, H, W): float32, contiguous, on the
// device.  dil (nd host ints, 1 <= nd <= 6) and pos (8*nd host floats) are
// copied into the launch.  Returns cudaGetLastError().
extern "C" int dupl_par_affinity(const void* img, void* out, int batch, int h,
                                 int w, int nd, const int* dil,
                                 const float* pos, float inv_w1,
                                 void* stream) {
  if (nd < 1 || nd > kMaxDilations || batch < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int i = 0; i < nd; ++i)
    for (int o = 0; o < 8; ++o) {
      taps.dy[8 * i + o] = kOffsets[o][0] * dil[i];
      taps.dx[8 * i + o] = kOffsets[o][1] * dil[i];
      taps.pos[8 * i + o] = pos[8 * i + o];
    }
  const float* in = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nd) {
    case 1: launch<1>(in, o, batch, h, w, inv_w1, taps, s); break;
    case 2: launch<2>(in, o, batch, h, w, inv_w1, taps, s); break;
    case 3: launch<3>(in, o, batch, h, w, inv_w1, taps, s); break;
    case 4: launch<4>(in, o, batch, h, w, inv_w1, taps, s); break;
    case 5: launch<5>(in, o, batch, h, w, inv_w1, taps, s); break;
    default: launch<6>(in, o, batch, h, w, inv_w1, taps, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
