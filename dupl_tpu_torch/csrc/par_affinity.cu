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
// * (1/(K-1)), the channel mean of z^2, then a max-subtracted softmax and
// the position constants, which the host computes in float64 as
// affinity_pallas does.
//
// Bound.  The output: 4K bytes a pixel against 12 bytes in (at K = 48, 154
// MB written and 9.6 MB read for 16 images of 224^2: 0.049 ms at 3.35
// TB/s).  Each tap also costs ~40 instructions a pixel (two sweeps of three
// shared-memory reads, the sums, the logit, the exp, the store), which at
// 38.5 M pixel-taps take about as long as the stores: the design keeps both
// streams busy at once and spends as few instructions as it can on
// addressing.
//
// Design.  A block owns a tile of 32 columns (a warp's lanes, along x) by
// kRows (32) rows of one image.  It stages the tile's input window, padded
// by PAD >= the largest dilation on each side, in dynamic shared memory as
// three planar fp32 planes a row ([row][channel][column]).  Coordinates are
// clamped once, while staging, which is the replicate padding (and covers
// images smaller than the halo).  Then each warp takes whole rows of the
// tile: a tap is three unclamped shared-memory reads at the centre's address
// plus an offset (dy * row stride + dx) and the channel planes an immediate
// apart; 32 lanes read 32 consecutive words, so no read has a bank
// conflict.  At the recipes' dilations the offsets are constants of the
// kernel (immediates of the reads); other sets take them from the launch.
// A thread owns one pixel at a time and keeps its K logits in registers
// between the sweeps, reading the taps again in the second sweep rather
// than keeping 3K values live; each tap's row is one 128-byte store a warp,
// coalesced along W, marked streaming (the output passes through L2 once).
// The window is 6.25x the tile at PAD 24 (9.6 MB become 60 MB of L2 reads,
// well under L2's rate) in 76.8 KB, so two blocks share an SM and one
// block's staging overlaps the other's sweeps; registers are held to 80 (a
// launch bound of three blocks), which the card ran fastest (tiles of 16 to
// 32 rows, two and three blocks an SM, 4 and 8 warps tried).  PAD 40 covers
// the wrapper's limit on the dilations.
//
// Numerics.  var = s2 - K*mean^2 cancels in fp32 where a neighbourhood is
// nearly flat, and a fused multiply-add in sum x^2 moves the result by up
// to ~5e-5 there; the sums and the variance therefore use __fmul_rn /
// __fadd_rn, which nvcc does not contract, so the kernel rounds as the
// plain twin (separate multiply and add) does.  The channel mean and the
// softmax's division multiply by reciprocals (1/3, 1/sum), and the exp is
// ex2.approx of (l - max) log2(e): ulps of a logit or of an output, far
// inside the card check's 1e-5.
//
// Past the cap (more than 6 dilations, or one over 40: a shared-memory
// halo of PAD 40 is as wide as the tile holds) a second kernel takes any
// set: a thread a pixel, each tap's three channels read from global memory
// (through L1; neighbouring pixels share their taps' lines) at clamped
// coordinates, the dilations and position constants from two small device
// arrays, any number of 8-tap groups.  It keeps no logits in registers:
// it sweeps the taps four times (the sums, the maximum, the sum of the
// exps, the outputs), recomputing each logit, which gives the same bits
// each time.  Its arithmetic is the first kernel's, with 1/K and 1/(K-1)
// rounded at run time.  A simple kernel, for sets no recipe uses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;     // tile columns: a warp's lanes
constexpr int kRows = 32;     // tile rows
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDilations = 6;
constexpr int kMaxTaps = 8 * kMaxDilations;
constexpr int kOffsets[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                {0, 1},   {1, -1}, {1, 0},  {1, 1}};

struct Taps {
  int off[kMaxTaps];    // dy * (3 * window columns) + dx
  float pos[kMaxTaps];
};

template <int PAD>
__host__ __device__ constexpr int window_cols() { return kCols + 2 * PAD; }

// Tap k's offset in the window at the recipes' dilations (1, 2, 4, 8, 12,
// 24), ops/par.py OFFSETS order: a constant once the tap loop is unrolled,
// so the shared-memory reads take it as an immediate.
__host__ __device__ constexpr int recipe_offset(int k, int rs) {
  const int d = k < 8 ? 1 : k < 16 ? 2 : k < 24 ? 4 : k < 32 ? 8 : k < 40 ? 12 : 24;
  const int o = k & 7;
  const int dy = o < 3 ? -1 : o < 5 ? 0 : 1;
  const int dx = (o == 0 || o == 3 || o == 5) ? -1 : (o == 1 || o == 6) ? 0 : 1;
  return (dy * rs + dx) * d;
}

// 2^x on the special-function unit (inputs here are <= 0; results below
// 2^-126 flush to zero, at most 1.2e-38 from the twin's exp).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// RECIPE: the taps are the recipes' (K 48, PAD 24), offsets known here.
template <int K, int PAD, bool RECIPE>
__global__ void __launch_bounds__(kThreads, 3)
par_affinity_kernel(const float* __restrict__ img, float* __restrict__ out,
                    int h, int w, float inv_w1, Taps taps) {
  constexpr int WW = window_cols<PAD>();
  constexpr int RS = 3 * WW;  // window row stride: three channel planes
  auto tap = [&](int k) { return RECIPE ? recipe_offset(k, RS) : taps.off[k]; };
  extern __shared__ float win[];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kCols, y0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* ib = img + static_cast<int64_t>(b) * h * w * 3;

  // Stage the window: a warp a row, lanes along x, coordinates clamped.
  for (int wy = warp; wy < kRows + 2 * PAD; wy += kWarps) {
    const int yy = min(max(y0 - PAD + wy, 0), h - 1);
    const float* src = ib + static_cast<int64_t>(yy) * w * 3;
    float* dst = win + wy * RS;
    for (int wx = lane; wx < WW; wx += 32) {
      const float* p = src + min(max(x0 - PAD + wx, 0), w - 1) * 3;
      dst[wx] = p[0];
      dst[WW + wx] = p[1];
      dst[2 * WW + wx] = p[2];
    }
  }
  __syncthreads();

  const int64_t hw = static_cast<int64_t>(h) * w;
  const int x = x0 + lane;
  for (int r = warp; r < kRows; r += kWarps) {
    const int y = y0 + r;
    const float* c = win + (r + PAD) * RS + PAD + lane;  // the centre

    float s1[3] = {0.f, 0.f, 0.f}, s2[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* t = c + tap(k);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float v = t[ch * WW];
        s1[ch] = __fadd_rn(s1[ch], v);
        s2[ch] = __fadd_rn(s2[ch], __fmul_rn(v, v));
      }
    }
    float xc[3], inv[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      xc[ch] = c[ch * WW];
      const float mean = __fmul_rn(s1[ch], 1.0f / K);
      const float var = __fmul_rn(
          fmaxf(__fsub_rn(s2[ch], __fmul_rn(__fmul_rn(static_cast<float>(K),
                                                      mean), mean)), 0.f),
          1.0f / (K - 1));
      inv[ch] = __fdiv_rn(inv_w1, __fadd_rn(__fsqrt_rn(var), 1e-8f));
    }

    // Read the taps again rather than keep 3K values live across the sweeps
    // (the compiler would otherwise reuse the first sweep's loads and spill).
    asm volatile("" ::: "memory");
    float l[K];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* t = c + tap(k);
      float q;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float z = __fmul_rn(fabsf(__fsub_rn(t[ch * WW], xc[ch])), inv[ch]);
        q = ch ? __fadd_rn(q, __fmul_rn(z, z)) : __fmul_rn(z, z);
      }
      l[k] = -__fmul_rn(q, 1.0f / 3);
      mx = fmaxf(mx, l[k]);
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      l[k] = ex2(__fmul_rn(l[k] - mx, 1.4426950408889634f));
      sum += l[k];
    }
    if (y >= h || x >= w) continue;  // the tile overhangs the image
    const float rs = __frcp_rn(sum);
    float* ob = out + static_cast<int64_t>(b) * K * hw +
                static_cast<int64_t>(y) * w + x;
#pragma unroll
    for (int k = 0; k < K; ++k) __stcs(ob + k * hw, fmaf(l[k], rs, taps.pos[k]));
  }
}

template <int K, int PAD, bool RECIPE = false>
cudaError_t launch(const float* img, float* out, int batch, int h, int w,
                   float inv_w1, const Taps& taps,
                   cudaStream_t stream) {
  constexpr int smem = sizeof(float) * (kRows + 2 * PAD) * 3 * window_cols<PAD>();
  static bool granted = false;  // the opt-in above 48 KB, once
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        par_affinity_kernel<K, PAD, RECIPE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    granted = true;
  }
  const dim3 grid((w + kCols - 1) / kCols, (h + kRows - 1) / kRows, batch);
  par_affinity_kernel<K, PAD, RECIPE><<<grid, kThreads, smem, stream>>>(
      img, out, h, w, inv_w1, taps);
  return cudaGetLastError();
}

template <int PAD>
cudaError_t launch_pad(int nd, const float* img, float* out, int batch, int h,
                       int w, float inv_w1, const Taps& taps,
                       cudaStream_t s) {
  switch (nd) {
    case 1: return launch<8, PAD>(img, out, batch, h, w, inv_w1, taps, s);
    case 2: return launch<16, PAD>(img, out, batch, h, w, inv_w1, taps, s);
    case 3: return launch<24, PAD>(img, out, batch, h, w, inv_w1, taps, s);
    case 4: return launch<32, PAD>(img, out, batch, h, w, inv_w1, taps, s);
    case 5: return launch<40, PAD>(img, out, batch, h, w, inv_w1, taps, s);
    default: return launch<48, PAD>(img, out, batch, h, w, inv_w1, taps, s);
  }
}

// ---- past the cap: any dilation set

// Tap k's three channel values at (y, x) under dilation set dil.
__device__ __forceinline__ void tap_values(const float* ib, const int* dil,
                                           int k, int y, int x, int h, int w,
                                           float (&t)[3]) {
  const int d = __ldg(dil + (k >> 3)), o = k & 7;
  const int dy = o < 3 ? -1 : o < 5 ? 0 : 1;
  const int dx = (o == 0 || o == 3 || o == 5) ? -1 : (o == 1 || o == 6) ? 0 : 1;
  const int yy = min(max(y + dy * d, 0), h - 1);
  const int xx = min(max(x + dx * d, 0), w - 1);
  const float* p = ib + (static_cast<int64_t>(yy) * w + xx) * 3;
  t[0] = __ldg(p);
  t[1] = __ldg(p + 1);
  t[2] = __ldg(p + 2);
}

// A thread a pixel: blocks of 32 columns by kAnyRows rows of one image.
constexpr int kAnyRows = 8;

__global__ void __launch_bounds__(32 * kAnyRows)
par_affinity_any_kernel(const float* __restrict__ img, float* __restrict__ out,
                        int h, int w, float inv_w1, const int* __restrict__ dil,
                        const float* __restrict__ pos, int nd) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * 32 + (threadIdx.x & 31);
  const int y = blockIdx.y * kAnyRows + (threadIdx.x >> 5);
  if (x >= w || y >= h) return;
  const float* ib = img + static_cast<int64_t>(b) * h * w * 3;
  const int K = 8 * nd;
  float s1[3] = {0.f, 0.f, 0.f}, s2[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    float t[3];
    tap_values(ib, dil, k, y, x, h, w, t);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      s1[ch] = __fadd_rn(s1[ch], t[ch]);
      s2[ch] = __fadd_rn(s2[ch], __fmul_rn(t[ch], t[ch]));
    }
  }
  const float inv_k = 1.0f / K, inv_k1 = 1.0f / (K - 1);
  float xc[3], inv[3];
  const float* c = ib + (static_cast<int64_t>(y) * w + x) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    xc[ch] = __ldg(c + ch);
    const float mean = __fmul_rn(s1[ch], inv_k);
    const float var = __fmul_rn(
        fmaxf(__fsub_rn(s2[ch], __fmul_rn(__fmul_rn(static_cast<float>(K),
                                                    mean), mean)), 0.f),
        inv_k1);
    inv[ch] = __fdiv_rn(inv_w1, __fadd_rn(__fsqrt_rn(var), 1e-8f));
  }
  auto logit = [&](int k) {
    float t[3];
    tap_values(ib, dil, k, y, x, h, w, t);
    float q;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float z = __fmul_rn(fabsf(__fsub_rn(t[ch], xc[ch])), inv[ch]);
      q = ch ? __fadd_rn(q, __fmul_rn(z, z)) : __fmul_rn(z, z);
    }
    return -__fmul_rn(q, 1.0f / 3);
  };
  float mx = -INFINITY;
  for (int k = 0; k < K; ++k) mx = fmaxf(mx, logit(k));
  float sum = 0.f;
  for (int k = 0; k < K; ++k)
    sum += ex2(__fmul_rn(logit(k) - mx, 1.4426950408889634f));
  const float rs = __frcp_rn(sum);
  const int64_t hw = static_cast<int64_t>(h) * w;
  float* ob = out + static_cast<int64_t>(b) * K * hw + static_cast<int64_t>(y) * w + x;
  for (int k = 0; k < K; ++k)
    __stcs(ob + k * hw,
           fmaf(ex2(__fmul_rn(logit(k) - mx, 1.4426950408889634f)), rs,
                __ldg(pos + k)));
}

}  // namespace

// img (B, H, W, 3) and out (B, 8*nd, H, W): float32, contiguous, on the
// device; dil (nd ints, each >= 1) and pos (8*nd floats) on the device too:
// any dilation set, by the kernel past the cap.
extern "C" int dupl_par_affinity_any(const void* img, void* out, int batch,
                                     int h, int w, int nd, const int* dil,
                                     const float* pos, float inv_w1,
                                     void* stream) {
  if (nd < 1 || batch < 1 || batch > 65535 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + 31) / 32, (h + kAnyRows - 1) / kAnyRows, batch);
  par_affinity_any_kernel<<<grid, 32 * kAnyRows, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), h, w, inv_w1,
      dil, pos, nd);
  return static_cast<int>(cudaGetLastError());
}

// img (B, H, W, 3) and out (B, 8*nd, H, W): float32, contiguous, on the
// device.  dil (nd host ints, 1 <= nd <= 6, each in [1, 40]) and pos (8*nd
// host floats) are copied into the launch.  Returns the launch's error, or
// cudaErrorInvalidValue.
extern "C" int dupl_par_affinity(const void* img, void* out, int batch, int h,
                                 int w, int nd, const int* dil,
                                 const float* pos, float inv_w1,
                                 void* stream) {
  if (nd < 1 || nd > kMaxDilations || batch < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int pad = 0;
  for (int i = 0; i < nd; ++i) {
    if (dil[i] < 1 || dil[i] > 40)
      return static_cast<int>(cudaErrorInvalidValue);
    pad = dil[i] > pad ? dil[i] : pad;
  }
  const int ws = 3 * (kCols + 2 * (pad <= 24 ? 24 : 40));
  Taps taps;
  for (int i = 0; i < nd; ++i)
    for (int o = 0; o < 8; ++o) {
      taps.off[8 * i + o] = kOffsets[o][0] * dil[i] * ws + kOffsets[o][1] * dil[i];
      taps.pos[8 * i + o] = pos[8 * i + o];
    }
  bool recipe = nd == kMaxDilations && pad == 24;
  for (int k = 0; k < 8 * nd; ++k)
    recipe = recipe && taps.off[k] == recipe_offset(k, ws);
  const float* in = static_cast<const float*>(img);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      recipe ? launch<kMaxTaps, 24, true>(in, o, batch, h, w, inv_w1, taps, s)
      : pad <= 24 ? launch_pad<24>(nd, in, o, batch, h, w, inv_w1, taps, s)
                  : launch_pad<40>(nd, in, o, batch, h, w, inv_w1, taps, s);
  return static_cast<int>(e);
}
