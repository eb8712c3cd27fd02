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
// Three modes, as _kernel's compute types:
//   fp32: the taps are summed one by one in tap order (fused multiply-adds);
//   bf16: the mask is rounded to bf16 when staged, the affinity arrives in
//         bf16, every product and partial sum inside a group of 8 taps is
//         rounded to bf16, and the group sums are added in fp32;
//   f16:  the same in f16 (float16), on f16x2 multiplies and adds.
//
// Design.  A block takes a 32 x 24 pixel tile of one image: a warp two
// neighbouring rows, a lane one column, so each thread sums two pixels and
// holds their 2K affinities in registers for the whole launch (the
// affinity is read once per round).  The registers bound the tile: at 48
// taps a 32-row tile spills (ptxas -v), and the whole register file would
// not hold 2,048 pixels' affinities.  The block loops over the channels two
// at a time.  Each pair is staged with its halo of max(dilation) on every
// side, a plane a channel: 72 x 80 positions for 768 pixels at the
// dilations (1, 2, 4, 8, 12, 24), 7.5 staged loads a pixel-channel from L2
// where the 16 x 32 tile of the first version took 10.  The fill is
// asynchronous: cp.async copies chunks of 4 columns, 16 bytes at a time
// where a chunk lies inside the image and W and the halo are multiples of
// 4, else 4 bytes at a time from clamped source addresses (so replicate
// padding stays exact at every edge, for any H and W), into the second of
// two shared-memory stages while the block sums the first (the first
// pair's copies fly while the affinities load); one barrier a pair hands
// the stages over.  Where one block a
// tile would leave the SMs' last wave mostly idle (a training step's batch
// of 4), the channel pairs split into groups, a block a group.  Each
// thread then reads its K taps of both channels and pixels, at offsets the
// host precomputes (a warp reads 32 consecutive floats: no bank
// conflicts), as four independent FMA chains, and stores four coalesced
// output rows.  In the bf16 and f16 modes each thread first pairs the two
// channels of the positions it copied in the type, in place, and the sums
// run on bf16x2 or f16x2 multiplies and adds, both channels of a pixel in
// one register.  On the card the time grew as the tile shrank (more halo a
// pixel) and fell when 16-byte copies replaced 4-byte ones: the staging
// weighs as much as the tap reads.
//
// Bound.  Per round and pixel-channel: K shared-memory reads of 4 bytes and
// K FMAs, 4 bytes out, 7.5 staged loads; per pixel 4K bytes of affinity.
// At the pseudo-label slice's 16 x 40 x 224^2 that is 1.54e9 FMAs (0.05 ms
// on the fp32 pipes), 282 MB of device memory (0.08 ms), 1.0 GB staged
// from L2, and 6.2 GB of tap reads from shared memory: ~0.2 ms a round at
// 128 bytes a clock an SM, the floor of this design.  The fill now runs
// beside the sums instead of before them.
//
// Past the cap (more than 6 dilations, or one over 40, whose halo the two
// stages cannot hold) a second kernel takes any set: a thread an output
// pixel-channel, each tap read from global memory (through L1) at clamped
// coordinates, the dilations from a small device array, any number of
// 8-tap groups, in the same two modes (fp32: fused multiply-adds in tap
// order; bf16 and f16: products and partial sums in the 16-bit type within a
// group of 8 taps, group sums in fp32).  A simple kernel, for sets no recipe
// uses.
//
// The 16-bit modes share one code path: Pair<T> packs two values of the
// type in a 32-bit word and multiplies or adds two words lane by lane with
// one rounding to nearest a lane (mul.rn / add.rn: never contracted into an
// fma, subnormals kept), the exact product or sum rounded once, which is
// what the twin's fp32 product or sum rounded to the type gives on operands
// of that type (24 >= 2 x 11 + 2 bits: f16 too rounds once).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;             // tile columns: a warp's lanes
constexpr int kStages = 2;              // shared-memory stages of a channel pair
constexpr int kGroup = 8;               // bf16 mode: taps per bf16 partial sum
constexpr int kMaxDilations = 6;
constexpr int kMaxTaps = 8 * kMaxDilations;
constexpr int kMaxDilation = 40;        // two stages fit 227 KB up to here
// 4-column chunks of a staged row: one lane each, at the largest halo
constexpr int kMaxChunks = (kTileW + 2 * kMaxDilation + 3) / 4;
static_assert(kMaxChunks <= 32, "a staged row's chunks exceed a warp");
constexpr int kOffsets[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                {0, 1},   {1, -1}, {1, 0},  {1, 1}};

struct Taps {
  int off[kMaxTaps];   // (dy * staged row stride + dx) * 4 bytes, in a plane
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ float lds32f(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Two 16-bit values in a word (the first in the low half) and their
// lane-wise arithmetic, rounded once a lane, for T = __nv_bfloat16 or
// __half (the head of the file says why).
template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return make_float2(__uint_as_float(v << 16),
                       __uint_as_float(v & 0xffff0000u));
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
  static __device__ __forceinline__ uint32_t of(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
    const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Pair<__half> {
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  }
  static __device__ __forceinline__ __half zero() { return __float2half_rn(0.f); }
  static __device__ __forceinline__ uint32_t of(__half lo, __half hi) {
    const __half2 v = __halves2half2(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// Tile rows, two a warp: as many as the block's registers allow without
// spills at K = 48 (ptxas -v on sm_90a: 32 rows spill).
constexpr int kTileH = 24;
constexpr int kWarps = kTileH / 2;
constexpr int kThreads = 32 * kWarps;

// A staged row's stride in floats: the tile's width and halo, rounded up
// to whole 16-byte chunks.
__host__ __device__ constexpr int row_stride(int pad) {
  return (kTileW + 2 * pad + 3) / 4 * 4;
}

// A stage: the two channels' planes of (rows + halo) x row_stride floats.
__host__ __device__ constexpr size_t stage_bytes(int pad) {
  return 2 * sizeof(float) * (kTileH + 2 * pad) * row_stride(pad);
}

// T: the type of the affinity (float, bf16 or f16; a 16-bit type also
// rounds the staged mask).  Grid: (column tiles, row tiles, images x groups
// of channel pairs); a block sums its group's pairs.
template <int K, typename T>
__global__ void __launch_bounds__(kThreads, 1)
par_propagate_kernel(const float* __restrict__ src, const T* __restrict__ aff,
                     float* __restrict__ dst, int channels, int h, int w,
                     int pad, int group_pairs, Taps taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  const int tw = kTileW + 2 * pad;
  const int th = kTileH + 2 * pad;
  const int ts = row_stride(pad);
  const int plane = th * ts;       // floats of one channel's plane
  const int nq = (tw + 3) / 4;     // 4-column chunks of a staged row

  const int groups = ((channels + 1) / 2 + group_pairs - 1) / group_pairs;
  const int b = blockIdx.z / groups;
  const int p_begin = (blockIdx.z - b * groups) * group_pairs;
  const int p_end = min((channels + 1) / 2, p_begin + group_pairs);
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int x = x0 + lane;
  const int y = y0 + 2 * warp;          // this thread's pixels: (y, x), (y+1, x)
  const bool in0 = x < w && y < h;
  const bool in1 = x < w && y + 1 < h;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t pix = static_cast<int64_t>(y) * w + x;

  const float* planes = src + static_cast<int64_t>(b) * channels * hw;
  // A chunk of 4 source columns inside the image is one 16-byte copy when
  // rows and chunks start on 16 bytes (W and the halo multiples of 4);
  // otherwise, and where a chunk crosses an edge, 4 copies of 4 bytes from
  // clamped columns.
  const bool rows16 = w % 4 == 0 && pad % 4 == 0;
  const int gx0 = x0 - pad + 4 * lane;  // this lane's chunk: its first column
  const bool chunk16 = rows16 && gx0 >= 0 && gx0 + 3 < w && 4 * lane + 3 < tw;

  // Stage channels 2p and 2p+1 (the last channel twice when C is odd) with
  // their clamped halo: warps over rows, lanes over 4-column chunks, one
  // lane copying the same chunk of both channels (so that in bf16 mode it
  // can pair them once they have landed).  One commit group a call, empty
  // past the last pair, so the groups count pairs.
  auto fill = [&](int p) {
    if (p < p_end && lane < nq) {
      const float* p0 = planes + 2 * p * hw;
      const float* p1 = planes + min(2 * p + 1, channels - 1) * hw;
      float* st = stages + (p % kStages) * 2 * plane + 4 * lane;
      for (int r = warp; r < th; r += kWarps) {
        const int64_t gy =
            min(max(y0 - pad + r, 0), h - 1) * static_cast<int64_t>(w);
        float* c0 = st + r * ts;
        if (chunk16) {
          cp_async16(c0, p0 + gy + gx0);
          cp_async16(c0 + plane, p1 + gy + gx0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * lane + e < tw) {
              const int gx = min(max(gx0 + e, 0), w - 1);
              cp_async4(c0 + e, p0 + gy + gx);
              cp_async4(c0 + plane + e, p1 + gy + gx);
            }
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // The first pair's copies fly while the affinities load.
  fill(p_begin);
  // The two pixels' affinities: fp32 in two arrays, 16-bit as one pair a
  // tap (pixel 0 in the low half).
  float a0[K], a1[K];
  uint32_t ap[K];
  const T* ab = aff + static_cast<int64_t>(b) * K * hw + pix;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (sizeof(T) == 4) {
      a0[k] = in0 ? ab[k * hw] : 0.f;
      a1[k] = in1 ? ab[k * hw + w] : 0.f;
    } else {
      const T zero = Pair<T>::zero();
      ap[k] = Pair<T>::of(in0 ? ab[k * hw] : zero, in1 ? ab[k * hw + w] : zero);
    }
  }

  for (int p = p_begin; p < p_end; ++p) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // pair p landed
    float* st = stages + (p % kStages) * 2 * plane;
    if constexpr (sizeof(T) == 2) {
      // 16-bit modes: the positions this thread copied hold the pair of
      // their two channels in the first plane, in place
      if (lane < nq) {
        for (int r = warp; r < th; r += kWarps) {
          float* c0 = st + r * ts + 4 * lane;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * lane + e < tw)
              *reinterpret_cast<uint32_t*>(c0 + e) =
                  Pair<T>::pack(c0[e], c0[plane + e]);
        }
      }
    }
    // Pair p is visible to every thread, and every thread is done with
    // pair p - 1, whose stage the next fill overwrites.
    __syncthreads();
    fill(p + 1);

    // this thread's pixels in the first plane; the second plane is
    // `plane` floats on
    const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(
        st + (2 * warp + pad) * ts + lane + pad));
    const uint32_t s1 = s0 + ts * static_cast<int>(sizeof(float));
    const uint32_t pb = plane * static_cast<int>(sizeof(float));
    float o[4];   // (pixel 0, channel 0), (0, 1), (1, 0), (1, 1)
    if constexpr (sizeof(T) == 4) {
      o[0] = o[1] = o[2] = o[3] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t t0 = s0 + taps.off[k], t1 = s1 + taps.off[k];
        o[0] = fmaf(lds32f(t0), a0[k], o[0]);
        o[1] = fmaf(lds32f(t0 + pb), a0[k], o[1]);
        o[2] = fmaf(lds32f(t1), a1[k], o[2]);
        o[3] = fmaf(lds32f(t1 + pb), a1[k], o[3]);
      }
    } else {
      // Both channels of a pixel in one register: products and the
      // partial sums of a group of 8 taps in T, group sums in fp32.
#pragma unroll
      for (int g = 0; g < K; g += kGroup) {
        uint32_t acc0 = 0, acc1 = 0;
#pragma unroll
        for (int k = g; k < g + kGroup; ++k) {
          const uint32_t a_lo = __byte_perm(ap[k], 0, 0x1010);  // (a0, a0)
          const uint32_t a_hi = __byte_perm(ap[k], 0, 0x3232);  // (a1, a1)
          const uint32_t t0 = Pair<T>::mul(lds32(s0 + taps.off[k]), a_lo);
          const uint32_t t1 = Pair<T>::mul(lds32(s1 + taps.off[k]), a_hi);
          acc0 = k == g ? t0 : Pair<T>::add(acc0, t0);
          acc1 = k == g ? t1 : Pair<T>::add(acc1, t1);
        }
        const float2 f0 = Pair<T>::unpack(acc0), f1 = Pair<T>::unpack(acc1);
        o[0] = g == 0 ? f0.x : o[0] + f0.x;
        o[1] = g == 0 ? f0.y : o[1] + f0.y;
        o[2] = g == 0 ? f1.x : o[2] + f1.x;
        o[3] = g == 0 ? f1.y : o[3] + f1.y;
      }
    }
    float* d = dst + (static_cast<int64_t>(b) * channels + 2 * p) * hw + pix;
    const bool second = 2 * p + 1 < channels;
    if (in0) {
      d[0] = o[0];
      if (second) d[hw] = o[1];
    }
    if (in1) {
      d[w] = o[2];
      if (second) d[hw + w] = o[3];
    }
  }
}

// Channel pairs a block: all of them, unless splitting them into groups
// (more blocks, each loading its tile's affinities again) fills the SMs'
// last wave better, as at a training step's batch of 4: 280 blocks of 20
// pairs are 2.1 waves on 132 SMs, 560 of 10 are 4.2 half-waves.  Cost in
// pair-times: waves x (pairs a block + 1.5 for a block's set-up).
int pairs_per_block(int blocks, int pairs) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  int best = pairs;
  double best_cost = 1e30;
  for (int groups = 1; groups <= 4 && groups <= pairs; ++groups) {
    const int per = (pairs + groups - 1) / groups;
    const int used = (pairs + per - 1) / per;
    const int64_t waves = (static_cast<int64_t>(blocks) * used + sms - 1) / sms;
    const double cost = waves * (per + 1.5);
    if (cost < best_cost) best_cost = cost, best = per;
  }
  return best;
}

template <int K, typename T>
int launch(const float* src, const void* aff, float* dst, int batch,
           int channels, int h, int w, int pad, const Taps& taps,
           cudaStream_t stream) {
  const size_t smem = kStages * stage_bytes(pad);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        par_propagate_kernel<K, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = ((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  const int pairs = (channels + 1) / 2;
  const int per = pairs_per_block(tiles * batch, pairs);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  batch * ((pairs + per - 1) / per));
  par_propagate_kernel<K, T><<<grid, kThreads, smem, stream>>>(
      src, static_cast<const T*>(aff), dst, channels, h, w, pad, per, taps);
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

// ---- past the cap: any dilation set

constexpr int kAnyRows = 8;   // a block: 32 columns by 8 rows of a plane

template <typename T>
__global__ void __launch_bounds__(32 * kAnyRows)
par_propagate_any_kernel(const float* __restrict__ src, const T* __restrict__ aff,
                         float* __restrict__ dst, int channels, int h, int w,
                         const int* __restrict__ dil, int nd) {
  const int bc = blockIdx.z;               // image b, channel c
  const int x = blockIdx.x * kTileW + (threadIdx.x & 31);
  const int y = blockIdx.y * kAnyRows + (threadIdx.x >> 5);
  if (x >= w || y >= h) return;
  const int b = bc / channels;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const float* plane = src + static_cast<int64_t>(bc) * hw;
  const T* ab = aff + static_cast<int64_t>(b) * 8 * nd * hw +
                static_cast<int64_t>(y) * w + x;
  float o = 0.f;
  for (int g = 0; g < nd; ++g) {
    const int d = __ldg(dil + g);
    uint32_t acc = 0;
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      const int dy = t < 3 ? -1 : t < 5 ? 0 : 1;
      const int dx = (t == 0 || t == 3 || t == 5) ? -1 : (t == 1 || t == 6) ? 0 : 1;
      const int yy = min(max(y + dy * d, 0), h - 1);
      const int xx = min(max(x + dx * d, 0), w - 1);
      const float v = __ldg(plane + static_cast<int64_t>(yy) * w + xx);
      const T a = ab[(8 * g + t) * hw];
      if constexpr (sizeof(T) == 4) {
        o = fmaf(v, a, o);
      } else {
        // the value and the affinity in both halves of a word: the low
        // half's product and sum round as the twin's 16-bit operations
        const uint32_t vv = Pair<T>::pack(v, v);
        const uint16_t ab16 = *reinterpret_cast<const uint16_t*>(&a);
        const uint32_t p = Pair<T>::mul(vv, ab16 | (static_cast<uint32_t>(ab16) << 16));
        acc = t == 0 ? p : Pair<T>::add(acc, p);
      }
    }
    if constexpr (sizeof(T) == 2) {
      const float f = Pair<T>::unpack(acc).x;
      o = g == 0 ? f : o + f;
    }
  }
  dst[static_cast<int64_t>(bc) * hw + static_cast<int64_t>(y) * w + x] = o;
}

}  // namespace

// src, dst (B, C, H, W) float32 and aff (B, 8*nd, H, W) in the mode's type:
// float32 (mode 0), bfloat16 (1) or float16 (2); contiguous, on the device,
// src != dst; dil (nd ints, each >= 1) on the device: any dilation set, by
// the kernel past the cap.
extern "C" int dupl_par_propagate_any(const void* src, const void* aff,
                                      void* dst, int batch, int channels,
                                      int h, int w, int nd, const int* dil,
                                      int mode, void* stream) {
  if (nd < 1 || batch < 1 || channels < 1 || h < 1 || w < 1 ||
      static_cast<int64_t>(batch) * channels > 65535 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kAnyRows - 1) / kAnyRows,
                  batch * channels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  if (mode == 1)
    par_propagate_any_kernel<__nv_bfloat16><<<grid, 32 * kAnyRows, 0, st>>>(
        s, static_cast<const __nv_bfloat16*>(aff), d, channels, h, w, dil, nd);
  else if (mode == 2)
    par_propagate_any_kernel<__half><<<grid, 32 * kAnyRows, 0, st>>>(
        s, static_cast<const __half*>(aff), d, channels, h, w, dil, nd);
  else
    par_propagate_any_kernel<float><<<grid, 32 * kAnyRows, 0, st>>>(
        s, static_cast<const float*>(aff), d, channels, h, w, dil, nd);
  return static_cast<int>(cudaGetLastError());
}

// src, dst (B, C, H, W) float32 and aff (B, 8*nd, H, W) float32 (mode 0),
// bfloat16 (1) or float16 (2): contiguous, on the device, src != dst.  dil:
// nd host ints, 1 <= nd <= 6, each in [1, 40].  Returns the first CUDA
// error.
extern "C" int dupl_par_propagate(const void* src, const void* aff, void* dst,
                                  int batch, int channels, int h, int w,
                                  int nd, const int* dil, int mode,
                                  void* stream) {
  if (nd < 1 || nd > kMaxDilations || batch < 1 || channels < 1 || h < 1 ||
      w < 1 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int pad = 0;
  for (int i = 0; i < nd; ++i) {
    if (dil[i] < 1 || dil[i] > kMaxDilation)
      return static_cast<int>(cudaErrorInvalidValue);
    pad = dil[i] > pad ? dil[i] : pad;
  }
  const int ts = row_stride(pad);
  Taps taps;
  for (int i = 0; i < nd; ++i)
    for (int o = 0; o < 8; ++o)
      taps.off[8 * i + o] = (kOffsets[o][0] * dil[i] * ts +
                             kOffsets[o][1] * dil[i]) *
                            static_cast<int>(sizeof(float));
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    return dispatch<__nv_bfloat16>(nd, s, aff, d, batch, channels, h, w, pad,
                                   taps, st);
  if (mode == 2)
    return dispatch<__half>(nd, s, aff, d, batch, channels, h, w, pad, taps,
                            st);
  return dispatch<float>(nd, s, aff, d, batch, channels, h, w, pad, taps, st);
}
