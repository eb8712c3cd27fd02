// One round of PAR mask propagation for Hopper (sm_90a):
//     dst[b, c, y, x] = sum_k src[b, c, clamp(y + dy_k), clamp(x + dx_k)]
//                             * aff[b, k, y, x]
// over the K = 8 * len(dilations) taps (8-connected neighbours at each
// dilation; the clamp is replicate padding).  The host launches it once per
// round, ping-ponging two buffers.
//
// Replaces the Pallas TPU kernel dupl_tpu/ops/par_pallas.py:_kernel
// (launched by par_pallas.propagate_pallas with aff_layout="bkhw"), which
// keeps one image's affinity and a channel tile of masks resident in VMEM
// across all rounds.  On this card one 224^2 image's fp32 affinity (9.6 MB)
// is larger than an SM's 227 KB of shared memory, and the batch's (154 MB)
// larger than the 50 MB L2, and each round reads neighbours up to 24 px away
// that the previous round wrote; so every round is one launch.
//
// Two modes, as _kernel:
//   fp32: the taps are summed one by one in tap order (fused multiply-adds);
//   bf16: the mask is rounded to bf16 when staged, the affinity arrives in
//         bf16, every product and partial sum inside a group of 8 taps is
//         rounded to bf16, and the group sums are added in fp32.
//
// Design.  A block takes a 16 x 32 pixel tile of one image (one thread per
// pixel) and loops over all channels, two at a time.  Each thread holds its
// pixel's K affinities in registers for the whole launch, so the affinity is
// read once per round.  For each group of channels the block stages the tile
// plus a halo of max(dilation) on every side (clamped coordinates) in shared
// memory: warps over rows and lanes over columns so the loads coalesce, each
// warp loading eight rows into registers before it stores any.  Each thread
// then reads its K taps of both channels from shared memory at offsets
// the host precomputes (consecutive threads hit consecutive words: no bank
// conflicts), as two interleaved FMA chains, and stores two coalesced
// output rows.  A first version kept one load in flight per thread and
// summed one channel at a time: 1.75 ms a round at the slice's size.
// Staging four channels a fill measured no faster.
//
// Bound.  Per round and pixel-channel: K shared-memory reads and K FMAs,
// 4 bytes out, and (16+2p)(32+2p)/512 staged loads from L2 (10 at p = 24);
// per pixel 4K bytes of affinity.  At the slice's 16 x 40 x 224^2 that is
// about 1.5 G FMAs, 128 MB written, 154 MB of affinity and 1.28 GB of
// staged halo read per round.  Measured at that size, the fill takes about
// 60% of the time and the sums 40%, one after the other: the halo's 10x
// amplification through L2, not device memory, bounds this design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kChannels = 2;   // channels staged per shared-memory fill
constexpr int kGroup = 8;      // bf16 mode: taps per bf16 partial sum
constexpr int kMaxDilations = 6;
constexpr int kMaxTaps = 8 * kMaxDilations;
constexpr int kMaxDilation = 40;  // bounds the staging registers below
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 8;   // staged rows a warp loads before storing
// 32-column strides of a staged row, at the largest halo
constexpr int kColGroups = (kTileW + 2 * kMaxDilation + 31) / 32;
constexpr int kOffsets[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                {0, 1},   {1, -1}, {1, 0},  {1, 1}};

struct Taps {
  int off[kMaxTaps];   // dy * (tile width + 2 pad) + dx, in the staged tile
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// T: the type of the staged mask and of the affinity (float or bf16).
template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
par_propagate_kernel(const float* __restrict__ src, const T* __restrict__ aff,
                     float* __restrict__ dst, int channels, int h, int w,
                     int pad, Taps taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int tw = kTileW + 2 * pad;
  const int th = kTileH + 2 * pad;
  const int plane = th * tw;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int ty = threadIdx.x / kTileW;
  const int tx = threadIdx.x - ty * kTileW;
  const int y = y0 + ty;
  const int x = x0 + tx;
  const bool inside = y < h && x < w;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pix = static_cast<int64_t>(y) * w + x;

  float a[K];
  const T* ab = aff + static_cast<int64_t>(b) * K * hw + pix;
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = inside ? to_float(ab[k * hw]) : 0.f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int centre = (ty + pad) * tw + tx + pad;

  for (int c0 = 0; c0 < channels; c0 += kChannels) {
    const int nc = min(kChannels, channels - c0);
    const int rows = nc * th;
    __syncthreads();  // the previous pair is consumed
    // Each warp loads kRowsInFlight rows x kColGroups lanes' worth into
    // registers before it stores any, so a thread keeps up to 32 loads in
    // flight instead of one (the fill is latency-bound otherwise).
    for (int r0 = warp; r0 < rows; r0 += kWarps * kRowsInFlight) {
      float v[kRowsInFlight][kColGroups];
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        const int r = r0 + i * kWarps;
        if (r >= rows) continue;
        const int cc = r / th;
        const int gy = min(max(y0 - pad + r - cc * th, 0), h - 1);
        const float* row =
            src + ((static_cast<int64_t>(b) * channels + c0 + cc) * h + gy) * w;
#pragma unroll
        for (int q = 0; q < kColGroups; ++q) {
          const int col = lane + 32 * q;
          if (col < tw) v[i][q] = row[min(max(x0 - pad + col, 0), w - 1)];
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        const int r = r0 + i * kWarps;
        if (r >= rows) continue;
        const int cc = r / th;
        T* srow = tile + cc * plane + (r - cc * th) * tw;
#pragma unroll
        for (int q = 0; q < kColGroups; ++q) {
          const int col = lane + 32 * q;
          if (col < tw) srow[col] = from_float<T>(v[i][q]);
        }
      }
    }
    __syncthreads();

    // The kChannels sums are independent chains, interleaved tap by tap so
    // the FMA and shared-load latencies overlap.  Channels past nc read
    // stale tile rows and are not stored.
    const T* s = tile + centre;
    float out[kChannels];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int cc = 0; cc < kChannels; ++cc) out[cc] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int cc = 0; cc < kChannels; ++cc)
          out[cc] = fmaf(to_float(s[cc * plane + taps.off[k]]), a[k], out[cc]);
    } else {
#pragma unroll
      for (int g = 0; g < K; g += kGroup) {
        float acc[kChannels];
#pragma unroll
        for (int k = g; k < g + kGroup; ++k)
#pragma unroll
          for (int cc = 0; cc < kChannels; ++cc) {
            // bf16 x bf16 is exact in fp32: one rounding, as a bf16 multiply
            const float term =
                bf16_round(to_float(s[cc * plane + taps.off[k]]) * a[k]);
            acc[cc] = k == g ? term : bf16_round(acc[cc] + term);
          }
#pragma unroll
        for (int cc = 0; cc < kChannels; ++cc)
          out[cc] = g == 0 ? acc[cc] : out[cc] + acc[cc];
      }
    }
    if (inside) {
      float* d = dst + (static_cast<int64_t>(b) * channels + c0) * hw + pix;
#pragma unroll
      for (int cc = 0; cc < kChannels; ++cc)
        if (cc < nc) d[cc * hw] = out[cc];
    }
  }
}

template <int K, typename T>
int launch(const float* src, const void* aff, float* dst, int batch,
           int channels, int h, int w, int pad, const Taps& taps,
           cudaStream_t stream) {
  const size_t smem = sizeof(T) * kChannels * (kTileH + 2 * pad) *
                      (kTileW + 2 * pad);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        par_propagate_kernel<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  par_propagate_kernel<K, T><<<grid, kThreads, smem, stream>>>(
      src, static_cast<const T*>(aff), dst, channels, h, w, pad, taps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int nd, const float* src, const void* aff, float* dst, int batch,
             int channels, int h, int w, int pad, const Taps& taps,
             cudaStream_t s) {
  switch (nd) {
    case 1: return launch<8, T>(src, aff, dst, batch, channels, h, w, pad, taps, s);
    case 2: return launch<16, T>(src, aff, dst, batch, channels, h, w, pad, taps, s);
    case 3: return launch<24, T>(src, aff, dst, batch, channels, h, w, pad, taps, s);
    case 4: return launch<32, T>(src, aff, dst, batch, channels, h, w, pad, taps, s);
    case 5: return launch<40, T>(src, aff, dst, batch, channels, h, w, pad, taps, s);
    default: return launch<48, T>(src, aff, dst, batch, channels, h, w, pad, taps, s);
  }
}

}  // namespace

// src, dst (B, C, H, W) float32 and aff (B, 8*nd, H, W) float32 (bf16 == 0)
// or bfloat16 (bf16 != 0): contiguous, on the device, src != dst.  dil: nd
// host ints, 1 <= nd <= 6, each in [1, 40].  Returns the first CUDA error.
extern "C" int dupl_par_propagate(const void* src, const void* aff, void* dst,
                                  int batch, int channels, int h, int w,
                                  int nd, const int* dil, int bf16,
                                  void* stream) {
  if (nd < 1 || nd > kMaxDilations || batch < 1 || channels < 1 || h < 1 ||
      w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int pad = 0;
  for (int i = 0; i < nd; ++i) {
    if (dil[i] < 1 || dil[i] > kMaxDilation)
      return static_cast<int>(cudaErrorInvalidValue);
    pad = dil[i] > pad ? dil[i] : pad;
  }
  const int tw = kTileW + 2 * pad;
  Taps taps;
  for (int i = 0; i < nd; ++i)
    for (int o = 0; o < 8; ++o)
      taps.off[8 * i + o] = kOffsets[o][0] * dil[i] * tw + kOffsets[o][1] * dil[i];
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(nd, s, aff, d, batch, channels, h, w,
                                        pad, taps, st)
              : dispatch<float>(nd, s, aff, d, batch, channels, h, w, pad,
                                taps, st);
}
