// Kernel Q1: the dynamic per-row int8 quantization of both operands of a
// w8a8 product, in one launch, for Hopper (sm_90a):
//     s[r]    = max(amax_k |x[r, k]| * f32(1/127), 1e-8)
//     q[r, k] = clamp(round_half_even(x[r, k] / s[r]), -127, 127)
// for the activations x (M, K) and the weight w (N, K) (nn.Linear's layout),
// each bf16 or fp32 -> q int8, s (rows, 1) fp32, bit for bit with
// quantize_rows_ref (dupl_tpu_torch/ops/quant.py), which is the jitted JAX
// package's quantization (dupl_tpu/ops/quant.py:quantized_matmul: XLA
// turns max|x| / 127.0 into a product with f32(1/127) and keeps x / s an
// IEEE division).  A second entry (fc2 of an int8 Mlp) takes fc1's fp32
// output h in place of x and quantizes gelu(h), the GELU taken in
// registers as the jitted JAX package takes it (csrc/gelu_xla.cuh: XLA's
// tanh GELU, or kernel G's erf expansion); the fp32 GELU tensor is never
// written.
//
// Replaces no Pallas kernel: the JAX package leaves this to XLA's fused
// loops.
//
// Bound: the bytes, each input read once (2 or 4 bytes an element) and one
// byte an element and four a row written.  Design: a row is read once.
// A block of 256 threads takes rows of one operand; a row has 8 to 256
// threads (a power of two, the fewest that hold it in kChunks 16-byte
// chunks each), and each thread issues all its loads (L1::no_allocate)
// before it computes on any of them.  The maximum is a butterfly of
// shuffles, and across the warps of a row one exchange in shared memory.
// The values are then quantized from registers, packed four to a word by
// cvt.pack.sat and stored as 8-byte (bf16) or 4-byte (fp32) words of int8.
// The blocks of x come first in the grid, those of w after them.  x / s:
// the product with the row's correctly rounded reciprocal is within
// 2^-16 + 2^-18 of the rounded quotient's value (|x / s| <= 127.000003);
// where it lies 2^-15 or nearer a half-integer the rounding could differ,
// and the IEEE division is taken instead.  With the GELU, the elementwise
// work (about 40 fp32 instructions an element for the tanh one, more for
// the erf one, whose branches diverge) weighs as much as the bytes.
//
// Rows of at most kThreads * kChunks * 16 = 24,576 bytes: K <= 6144 in fp32
// (ViT-H's hidden 5120), 12,288 in bf16.
//
// Two more entries take the same quantization in two passes, for rows of
// any width and for rows whose maxima span several processes (a
// row-parallel product under tensor parallelism: the maxima of each
// process's share are all-reduced between the passes):
//   * dupl_row_absmax_pair: the maxima of |x| (or of |gelu(x)|) a row and of
//     |w| a row, fp32.  A warp a row, each lane streaming 16-byte chunks
//     (four loads in flight) and a shuffle butterfly at the end;
//   * dupl_quantize_pair_given: q and s from given maxima, by the same
//     recipe (s = max(amax f32(1/127), 1e-8), the division as above).  A
//     thread a 16-byte chunk; the GELU is taken again in registers, so the
//     fp32 GELU tensor is not written in either pass.
// The maximum is exact in any order, so the two passes give the one-launch
// entry's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu_xla.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 6;  // 16-byte chunks a thread holds at most
constexpr int kMaxRowBytes = kThreads * kChunks * 16;
constexpr float kInv127 = 0x1.020408p-7f;     // f32(1/127)
constexpr float kMinScale = 0x1.5798eep-27f;  // f32(1e-8)

enum Gelu { kNone = 0, kTanh = 1, kErf = 2 };

// One operand: rows (rows, k) of bf16 or fp32, `tpr` threads a row.
struct Operand {
  const void* x;
  int8_t* q;
  float* s;
  int rows;
  int tpr;
};

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// round_half_even(v / s) as an int; r = 1 / s.  In [-127, 127]: |v| <=
// amax and s >= amax f32(1/127) (1 - 2^-24) bound |v / s| by 127.000003.
__device__ __forceinline__ int quant(float v, float s, float r) {
  float y = __fmul_rn(v, r);
  if (fabsf(y - rintf(y)) >= 0.5f - 0x1p-15f) y = __fdiv_rn(v, s);
  return __float2int_rn(y);
}

// Four ints as the bytes of a word, a lowest, each saturated to int8:
// cvt.pack.sat puts its second operand in byte 0, its first in byte 1 and
// the low half of its third above them.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  uint32_t hi, w;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;"
      : "=r"(hi) : "r"(d), "r"(c), "r"(0u));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;"
      : "=r"(w) : "r"(b), "r"(a), "r"(hi));
  return w;
}

template <int kGelu>
__device__ __forceinline__ uint32_t activation(uint32_t bits) {
  const float v = __uint_as_float(bits);
  if constexpr (kGelu == kTanh) return __float_as_uint(gelu_tanh_f32(v));
  else return __float_as_uint(fwd_f32(v));
}

// A chunk's values as floats: 8 bf16 or 4 fp32 (T is __nv_bfloat16 or
// float).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& c, float* f) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

// The block's rows of one operand; k elements a row (a multiple of 8).
// Each thread keeps its chunks as loaded (or, with the GELU, as its fp32
// results) in registers from the load to the store.
template <typename T, int kGelu>
__device__ __forceinline__ void quantize_block(const Operand& op, int block,
                                               int k, float* red) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kGelu == kNone || kVec == 4, "the GELU takes fp32 rows");
  const int rows_per_block = kThreads / op.tpr;
  const int row = block * rows_per_block + threadIdx.x / op.tpr;
  const int lane = threadIdx.x % op.tpr;
  const bool live = row < op.rows;
  const int chunks = k / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(
      static_cast<const T*>(op.x) + static_cast<int64_t>(live ? row : 0) * k);
  uint4 raw[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = lane + j * op.tpr;
    if (live && c < chunks) raw[j] = ld_stream(xr + c);
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = lane + j * op.tpr;
    if (live && c < chunks) {
      if constexpr (kGelu != kNone) {
        raw[j].x = activation<kGelu>(raw[j].x);
        raw[j].y = activation<kGelu>(raw[j].y);
        raw[j].z = activation<kGelu>(raw[j].z);
        raw[j].w = activation<kGelu>(raw[j].w);
      }
      float f[kVec];
      unpack<T>(raw[j], f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(f[i]));
    }
  }
  // a row's threads are op.tpr consecutive lanes of a warp, or whole warps
#pragma unroll
  for (int off = 16; off; off >>= 1)
    if (off < op.tpr) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (op.tpr > 32) {                    // the same for the whole block
    const int warps = op.tpr / 32;
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) red[warp] = amax;
    __syncthreads();
    const int first = warp / warps * warps;
    for (int i = 0; i < warps; ++i) amax = fmaxf(amax, red[first + i]);
  }
  if (!live) return;
  float sc = __fmul_rn(amax, kInv127);
  sc = sc < kMinScale ? kMinScale : sc;
  const float rc = __frcp_rn(sc);
  int8_t* qr = op.q + static_cast<int64_t>(row) * k;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = lane + j * op.tpr;
    if (c >= chunks) break;
    float f[kVec];
    unpack<T>(raw[j], f);
    uint32_t w[kVec / 4];
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i)
      w[i] = pack4(quant(f[4 * i], sc, rc), quant(f[4 * i + 1], sc, rc),
                   quant(f[4 * i + 2], sc, rc), quant(f[4 * i + 3], sc, rc));
    if constexpr (kVec == 8)
      reinterpret_cast<uint2*>(qr)[c] = make_uint2(w[0], w[1]);
    else
      reinterpret_cast<uint32_t*>(qr)[c] = w[0];
  }
  if (lane == 0) op.s[row] = sc;
}

// Blocks [0, x_blocks) quantize x (through the GELU kGelu), the rest w.
template <typename TX, typename TW, int kGelu>
__global__ void __launch_bounds__(kThreads)
quantize_pair_kernel(Operand x, Operand w, int x_blocks, int k) {
  __shared__ float red[kThreads / 32];
  if (static_cast<int>(blockIdx.x) < x_blocks)
    quantize_block<TX, kGelu>(x, blockIdx.x, k, red);
  else
    quantize_block<TW, kNone>(w, blockIdx.x - x_blocks, k, red);
}

// Threads a row: the fewest (a power of two from 8) that hold its chunks;
// 0 past the cap.
int threads_per_row(int k, int esize) {
  const int chunks = k * esize / 16;
  for (int tpr = 8; tpr <= kThreads; tpr *= 2)
    if (tpr * kChunks >= chunks) return tpr;
  return 0;
}

// The blocks of one operand, 256 / tpr rows a block.
int blocks_for(const Operand& op) {
  const int rows_per_block = kThreads / op.tpr;
  return (op.rows + rows_per_block - 1) / rows_per_block;
}

template <typename TX, typename TW>
void launch(int gelu, const Operand& x, const Operand& w, int k,
            cudaStream_t st) {
  const int xb = blocks_for(x), blocks = xb + blocks_for(w);
  if constexpr (sizeof(TX) == 4) {     // the GELU entries take fp32 x
    if (gelu == kTanh) {
      quantize_pair_kernel<TX, TW, kTanh><<<blocks, kThreads, 0, st>>>(x, w, xb, k);
      return;
    }
    if (gelu == kErf) {
      quantize_pair_kernel<TX, TW, kErf><<<blocks, kThreads, 0, st>>>(x, w, xb, k);
      return;
    }
  }
  quantize_pair_kernel<TX, TW, kNone><<<blocks, kThreads, 0, st>>>(x, w, xb, k);
}

// ---- the two-pass entries: any row width, maxima that may come from
// elsewhere

constexpr int kUnroll = 4;  // 16-byte loads a lane has in flight

// The maxima of |x| (through the GELU kGelu) of the block's rows of one
// operand, a warp a row, into op.s.
template <typename T, int kGelu>
__device__ __forceinline__ void absmax_rows(const Operand& op, int block,
                                            int k) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kGelu == kNone || kVec == 4, "the GELU takes fp32 rows");
  const int row = block * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= op.rows) return;  // a whole warp: the shuffles below stay full
  const int chunks = k / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(
      static_cast<const T*>(op.x) + static_cast<int64_t>(row) * k);
  float amax = 0.0f;
  for (int c0 = lane; c0 < chunks; c0 += 32 * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c0 + 32 * u < chunks) raw[u] = ld_stream(xr + c0 + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + 32 * u >= chunks) break;
      if constexpr (kGelu != kNone) {
        raw[u].x = activation<kGelu>(raw[u].x);
        raw[u].y = activation<kGelu>(raw[u].y);
        raw[u].z = activation<kGelu>(raw[u].z);
        raw[u].w = activation<kGelu>(raw[u].w);
      }
      float f[kVec];
      unpack<T>(raw[u], f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(f[i]));
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) op.s[row] = amax;
}

// Blocks [0, x_blocks) take x's rows (through the GELU kGelu), the rest w's.
template <typename TX, typename TW, int kGelu>
__global__ void __launch_bounds__(kThreads)
row_absmax_pair_kernel(Operand x, Operand w, int x_blocks, int k) {
  if (static_cast<int>(blockIdx.x) < x_blocks)
    absmax_rows<TX, kGelu>(x, blockIdx.x, k);
  else
    absmax_rows<TW, kNone>(w, blockIdx.x - x_blocks, k);
}

// One 16-byte chunk of one operand quantized by its row's given maximum;
// the row's first chunk writes its scale.
template <typename T, int kGelu>
__device__ __forceinline__ void quantize_chunk(const Operand& op,
                                               const float* amax,
                                               int64_t chunk, int k) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kGelu == kNone || kVec == 4, "the GELU takes fp32 rows");
  const int chunks = k / kVec;
  const int64_t row = chunk / chunks;
  const int c = static_cast<int>(chunk - row * chunks);
  uint4 raw = ld_stream(static_cast<const T*>(op.x) + row * k + c * kVec);
  if constexpr (kGelu != kNone) {
    raw.x = activation<kGelu>(raw.x);
    raw.y = activation<kGelu>(raw.y);
    raw.z = activation<kGelu>(raw.z);
    raw.w = activation<kGelu>(raw.w);
  }
  float sc = __fmul_rn(__ldg(amax + row), kInv127);
  sc = sc < kMinScale ? kMinScale : sc;
  const float rc = __frcp_rn(sc);
  float f[kVec];
  unpack<T>(raw, f);
  uint32_t wd[kVec / 4];
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i)
    wd[i] = pack4(quant(f[4 * i], sc, rc), quant(f[4 * i + 1], sc, rc),
                  quant(f[4 * i + 2], sc, rc), quant(f[4 * i + 3], sc, rc));
  int8_t* qr = op.q + row * k;
  if constexpr (kVec == 8)
    reinterpret_cast<uint2*>(qr)[c] = make_uint2(wd[0], wd[1]);
  else
    reinterpret_cast<uint32_t*>(qr)[c] = wd[0];
  if (c == 0) op.s[row] = sc;
}

// A thread a chunk: x's chunks (through the GELU kGelu) first, w's after.
template <typename TX, typename TW, int kGelu>
__global__ void __launch_bounds__(kThreads)
quantize_pair_given_kernel(Operand x, Operand w, const float* amax_x,
                           const float* amax_w, int64_t x_chunks,
                           int64_t chunks, int k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < x_chunks)
    quantize_chunk<TX, kGelu>(x, amax_x, i, k);
  else if (i < chunks)
    quantize_chunk<TW, kNone>(w, amax_w, i - x_chunks, k);
}

// The two-pass kernels' launches for the operand types TX, TW: the maxima
// (amax_x, amax_w null) or the quantization by given maxima.
template <typename TX, typename TW>
void launch_two_pass(int gelu, const Operand& x, const Operand& w, int k,
                     const float* amax_x, const float* amax_w,
                     cudaStream_t st) {
  if (amax_x == nullptr) {
    constexpr int rows_per_block = kThreads / 32;
    const int xb = (x.rows + rows_per_block - 1) / rows_per_block;
    const int blocks = xb + (w.rows + rows_per_block - 1) / rows_per_block;
    if constexpr (sizeof(TX) == 4) {   // the GELU entries take fp32 x
      if (gelu == kTanh) {
        row_absmax_pair_kernel<TX, TW, kTanh><<<blocks, kThreads, 0, st>>>(x, w, xb, k);
        return;
      }
      if (gelu == kErf) {
        row_absmax_pair_kernel<TX, TW, kErf><<<blocks, kThreads, 0, st>>>(x, w, xb, k);
        return;
      }
    }
    row_absmax_pair_kernel<TX, TW, kNone><<<blocks, kThreads, 0, st>>>(x, w, xb, k);
    return;
  }
  const int64_t xc = static_cast<int64_t>(x.rows) * (k / (16 / sizeof(TX)));
  const int64_t all = xc + static_cast<int64_t>(w.rows) * (k / (16 / sizeof(TW)));
  const unsigned blocks = static_cast<unsigned>((all + kThreads - 1) / kThreads);
  if constexpr (sizeof(TX) == 4) {
    if (gelu == kTanh) {
      quantize_pair_given_kernel<TX, TW, kTanh><<<blocks, kThreads, 0, st>>>(
          x, w, amax_x, amax_w, xc, all, k);
      return;
    }
    if (gelu == kErf) {
      quantize_pair_given_kernel<TX, TW, kErf><<<blocks, kThreads, 0, st>>>(
          x, w, amax_x, amax_w, xc, all, k);
      return;
    }
  }
  quantize_pair_given_kernel<TX, TW, kNone><<<blocks, kThreads, 0, st>>>(
      x, w, amax_x, amax_w, xc, all, k);
}

// Either two-pass entry: amax_x and amax_w null for the maxima (into sx,
// sw), else the quantization by them.
int two_pass(const void* x, const void* w, const float* amax_x,
             const float* amax_w, void* qx, void* sx, void* qw, void* sw,
             int rows_x, int rows_w, int k, int x_bf16, int w_bf16, int gelu,
             void* stream) {
  const bool maxima = amax_x == nullptr;
  const auto misaligned = [](const void* p, int a) {
    return reinterpret_cast<uintptr_t>(p) % a != 0;
  };
  if (rows_x < 0 || rows_w < 0 || rows_x + rows_w < 1 || k < 8 || k % 8 ||
      gelu < kNone || gelu > kErf || (gelu && x_bf16) || misaligned(x, 16) ||
      misaligned(w, 16) || (!maxima && (amax_w == nullptr ||
                                        misaligned(qx, 8) || misaligned(qw, 8))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Operand ox{x, static_cast<int8_t*>(qx), static_cast<float*>(sx), rows_x, 0};
  const Operand ow{w, static_cast<int8_t*>(qw), static_cast<float*>(sw), rows_w, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    launch_two_pass<__nv_bfloat16, __nv_bfloat16>(gelu, ox, ow, k, amax_x, amax_w, st);
  else if (x_bf16)
    launch_two_pass<__nv_bfloat16, float>(gelu, ox, ow, k, amax_x, amax_w, st);
  else if (w_bf16)
    launch_two_pass<float, __nv_bfloat16>(gelu, ox, ow, k, amax_x, amax_w, st);
  else
    launch_two_pass<float, float>(gelu, ox, ow, k, amax_x, amax_w, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows_x, k) and w (rows_w, k) as dupl_quantize_pair takes them, k any
// multiple of 8 -> amax_x (rows_x,) and amax_w (rows_w,) fp32: the maxima
// of |gelu(x)| (gelu 1 or 2, x fp32) or of |x|, and of |w|, a row.
extern "C" int dupl_row_absmax_pair(const void* x, const void* w, void* amax_x,
                                    void* amax_w, int rows_x, int rows_w,
                                    int k, int x_bf16, int w_bf16, int gelu,
                                    void* stream) {
  return two_pass(x, w, nullptr, nullptr, nullptr, amax_x, nullptr, amax_w,
                  rows_x, rows_w, k, x_bf16, w_bf16, gelu, stream);
}

// dupl_quantize_pair's outputs for rows of any width k (a multiple of 8),
// each row quantized by its given maximum amax_x[r] or amax_w[r] (fp32, on
// the device) in place of its own.
extern "C" int dupl_quantize_pair_given(const void* x, const void* w,
                                        const void* amax_x, const void* amax_w,
                                        void* qx, void* sx, void* qw, void* sw,
                                        int rows_x, int rows_w, int k,
                                        int x_bf16, int w_bf16, int gelu,
                                        void* stream) {
  if (amax_x == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return two_pass(x, w, static_cast<const float*>(amax_x),
                  static_cast<const float*>(amax_w), qx, sx, qw, sw, rows_x,
                  rows_w, k, x_bf16, w_bf16, gelu, stream);
}

// x (rows_x, k) and w (rows_w, k) contiguous and 16-byte aligned, bf16 or
// fp32 each (x_bf16, w_bf16), k a multiple of 8 with a row of at most
// 24,576 bytes; qx, qw 8-byte aligned.  gelu: 0 none, 1 the tanh GELU, 2 the
// erf GELU of x, which must then be fp32.
extern "C" int dupl_quantize_pair(const void* x, const void* w, void* qx,
                                  void* sx, void* qw, void* sw, int rows_x,
                                  int rows_w, int k, int x_bf16, int w_bf16,
                                  int gelu, void* stream) {
  const int tx = threads_per_row(k, x_bf16 ? 2 : 4);
  const int tw = threads_per_row(k, w_bf16 ? 2 : 4);
  const auto misaligned = [](const void* p, int a) {
    return reinterpret_cast<uintptr_t>(p) % a != 0;
  };
  if (rows_x < 0 || rows_w < 0 || rows_x + rows_w < 1 || k < 8 || k % 8 ||
      !tx || !tw || gelu < kNone || gelu > kErf || (gelu && x_bf16) ||
      misaligned(x, 16) || misaligned(w, 16) || misaligned(qx, 8) ||
      misaligned(qw, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(kMaxRowBytes == 24576, "ops/quant.py:MAX_ROW_BYTES");
  const Operand ox{x, static_cast<int8_t*>(qx), static_cast<float*>(sx), rows_x, tx};
  const Operand ow{w, static_cast<int8_t*>(qw), static_cast<float*>(sw), rows_w, tw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(gelu, ox, ow, k, st);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(gelu, ox, ow, k, st);
  else if (w_bf16)
    launch<float, __nv_bfloat16>(gelu, ox, ow, k, st);
  else
    launch<float, float>(gelu, ox, ow, k, st);
  return static_cast<int>(cudaGetLastError());
}
