// Backward of the exact softmax attention (flash attention) for Hopper
// (sm_90a).
//
// Replaces the dq and dk/dv kernels that jax's library Pallas TPU flash
// attention runs under jax.grad where dupl_tpu/ops/attention.py:dot_attention
// calls it (sequences of 2048 tokens or more; its backward block sizes are
// set there).  It is the backward of flash_attention.cu's forward.  With
// everything bf16 on the way in, q unscaled and lse the forward's row
// log-sum-exp:
//   s = q.k^T (fp32), p = exp(scale * s - lse)                     (fp32)
//   t = g.v^T (fp32), delta = rowsum(out * g)                      (fp32)
//   ds = bf16(p * (t - delta))
//   dq = scale * ds.k, dk = scale * ds^T.q, dv = bf16(p)^T.g
//   (fp32 sums, each result rounded to bf16 once)
// p <= 1 always, so nothing is clamped.
//
// Design.  The TPU kernels hold all keys of a head per block (block_k = the
// padded length); a head's operands overflow a Hopper block's 227 KB of
// shared memory at these lengths, so the work is tiled as in the forward and
// the score tile is recomputed from the saved lse:
//   * kernel 1, one block per 64 query rows (4 warps x 16 rows; q, g and out
//     fragments in registers) forms delta from its own rows of out and g,
//     writes it to device memory ((B*H, N) fp32, scratch of the wrapper) and
//     sweeps the 64-key tiles of K and V once: s, t, ds, dq += ds.k.
//   * kernel 2, one block per 64 keys (k and v fragments in registers) sweeps
//     the 64-query tiles of q and g with lse and delta, forms the transposed
//     tiles s^T = k.q^T and t^T = v.g^T directly (so ds^T and p^T come out in
//     the A-operand layout), and accumulates dk and dv.
// Every output element is owned by one thread: no atomics, and the result is
// the same from run to run.  Rows and columns past N are masked in the
// kernel (a key past N gets p = 0 in kernel 1; a query past N reads lse =
// +inf in kernel 2, so its column of p and ds is exactly zero); nothing is
// padded in device memory.  Products run on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
//
// Bound.  The function needs 10*N^2*D tensor-core FLOPs and N^2 exps a head
// against 8 * N * D * 2 bytes of operands and results: bound by operations.
// This tiling recomputes the s and t tiles in both kernels (14*N^2*D FLOPs
// issued, not 10) and stages tiles without pipelining; wgmma, TMA and a fused
// single sweep are later work.
//
// Layout.  q, k, v, out, g are (B, N, H, D) with arbitrary strides for B, N
// and H (multiples of 8 elements, 16-byte aligned base); k and v are column
// slices of the qkv projection.  lse is (B, H, N) fp32.  dq, dk, dv are
// (B, N, H, D) contiguous.  D is a template parameter: 16, 32, 64 or 80.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;         // rows owned by a block (4 warps x 16)
constexpr int kBT = 64;         // rows of a streamed shared-memory tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> packed bf16x2; `lo` lands in the low half (lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Sum of the products of two packed bf16 pairs, in fp32.
__device__ __forceinline__ float dot2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return x.x * y.x + x.y * y.y;
}

// A fragments of 16 rows (r0 and r1 = r0 + 8 for this thread) over the full
// head dim, straight from device memory; rows past n read as zero.
template <int D>
__device__ __forceinline__ void load_frags(uint32_t f[D / 16][4],
                                           const __nv_bfloat16* base,
                                           int64_t sn, int r0, int r1, int n,
                                           int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    f[kk][0] = r0 < n ? ld32(base + r0 * sn + c) : 0u;
    f[kk][1] = r1 < n ? ld32(base + r1 * sn + c) : 0u;
    f[kk][2] = r0 < n ? ld32(base + r0 * sn + c + 8) : 0u;
    f[kk][3] = r1 < n ? ld32(base + r1 * sn + c + 8) : 0u;
  }
}

// Stage rows [row0, row0 + 64) of a (N, D) operand as tile[row][d] and,
// where `tr` is given, also transposed as tr[d][row]; rows past n are zero.
// Rows are padded by 8 bf16 so that the 32-bit fragment reads of a warp
// (8 rows x 4 column pairs) fall in distinct banks.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16 (*tile)[D + 8],
                                      __nv_bfloat16 (*tr)[kBT + 8],
                                      const __nv_bfloat16* base, int64_t sn,
                                      int row0, int n) {
  for (int i = threadIdx.x; i < kBT * D / 8; i += kThreads) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8, r = row0 + row;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) x = *reinterpret_cast<const uint4*>(base + r * sn + col);
    *reinterpret_cast<uint4*>(&tile[row][col]) = x;
    if (tr != nullptr) {
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[col + j][row] = xe[j];
    }
  }
}

// c[nt] = a . tile^T for 16 rows x 64 tile rows (8 n-tiles of 8).
template <int D>
__device__ __forceinline__ void rows_times_tile(float c[8][4],
                                                const uint32_t a[D / 16][4],
                                                const __nv_bfloat16 (*tile)[D + 8],
                                                int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* r = &tile[nt * 8 + g][kk * 16 + t * 2];
      const uint32_t bf[2] = {ld32(r), ld32(r + 8)};
      mma_bf16_16816(c[nt], a[kk], bf);
    }
  }
}

// acc += a . tr^T where a is a 16 x 64 bf16 tile in A-fragment registers and
// tr is the transposed operand tr[d][row].
template <int D>
__device__ __forceinline__ void tile_times_rows(float acc[D / 8][4],
                                                const uint32_t a[4][4],
                                                const __nv_bfloat16 (*tr)[kBT + 8],
                                                int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const __nv_bfloat16* r = &tr[nt * 8 + g][kk * 16 + t * 2];
      const uint32_t bf[2] = {ld32(r), ld32(r + 8)};
      mma_bf16_16816(acc[nt], a[kk], bf);
    }
  }
}

// out rows = bf16(mult * acc).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t row_stride,
                                           const float acc[D / 8][4], float mult,
                                           int r0, int r1, int n, int t) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + t * 2;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + r0 * row_stride + c) =
          pack_bf16(mult * acc[nt][0], mult * acc[nt][1]);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(out + r1 * row_stride + c) =
          pack_bf16(mult * acc[nt][2], mult * acc[nt][3]);
  }
}

// Kernel 1: delta and dq, one block per 64 query rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ go,
                         const float* __restrict__ lse,
                         __nv_bfloat16* __restrict__ dq,
                         float* __restrict__ delta, int n, int heads,
                         float scale,
                         int64_t qsb, int64_t qsn, int64_t qsh,
                         int64_t ksb, int64_t ksn, int64_t ksh,
                         int64_t vsb, int64_t vsn, int64_t vsh,
                         int64_t osb, int64_t osn, int64_t osh,
                         int64_t gsb, int64_t gsn, int64_t gsh) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBT][D + 8];   // K tile [key][d]
  __shared__ __align__(16) __nv_bfloat16 vs[kBT][D + 8];   // V tile [key][d]
  __shared__ __align__(16) __nv_bfloat16 kt[D][kBT + 8];   // K tile [d][key]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  const int r0 = blockIdx.x * kBM + warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_frags<D>(qf, q + b * qsb + h * qsh, qsn, r0, r1, n, t);
  load_frags<D>(gf, go + b * gsb + h * gsh, gsn, r0, r1, n, t);

  // delta = rowsum(out * g) over this thread's share of rows r0 and r1; the
  // four threads of a fragment row group hold disjoint columns.
  float del0 = 0.f, del1 = 0.f;
  {
    uint32_t of[D / 16][4];
    load_frags<D>(of, o + b * osb + h * osh, osn, r0, r1, n, t);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      del0 += dot2(of[kk][0], gf[kk][0]) + dot2(of[kk][2], gf[kk][2]);
      del1 += dot2(of[kk][1], gf[kk][1]) + dot2(of[kk][3], gf[kk][3]);
    }
  }
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    del0 += __shfl_xor_sync(0xffffffffu, del0, m);
    del1 += __shfl_xor_sync(0xffffffffu, del1, m);
  }
  const int64_t stat = static_cast<int64_t>(bh) * n;
  // rows past n never store; any finite lse keeps their p finite
  const float lse0 = r0 < n ? lse[stat + r0] : 0.f;
  const float lse1 = r1 < n ? lse[stat + r1] : 0.f;
  if (t == 0) {
    if (r0 < n) delta[stat + r0] = del0;
    if (r1 < n) delta[stat + r1] = del1;
  }

  float s[8][4], tt[8][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBT) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(ks, kt, kb, ksn, k0, n);
    stage<D>(vs, nullptr, vb, vsn, k0, n);
    __syncthreads();
    rows_times_tile<D>(s, qf, ks, g, t);
    rows_times_tile<D>(tt, gf, vs, g, t);
    // The accumulator layout of two neighbouring n-tiles is the A-fragment
    // layout of one 16-key k-step, so ds packs straight into the operand.
    uint32_t df[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int key = k0 + nt * 8 + t * 2;
      const bool in0 = key < n, in1 = key + 1 < n;
      float d[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = (c & 1) ? in1 : in0;
        const float ls = (c & 2) ? lse1 : lse0, del = (c & 2) ? del1 : del0;
        const float p = __expf(scale * s[nt][c] - ls);
        d[c] = in ? p * (tt[nt][c] - del) : 0.f;
      }
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      df[kk][hi] = pack_bf16(d[0], d[1]);      // row g
      df[kk][hi + 1] = pack_bf16(d[2], d[3]);  // row g + 8
    }
    tile_times_rows<D>(acc, df, kt, g, t);
  }
  const int64_t row_stride = static_cast<int64_t>(heads) * D;
  store_rows<D>(dq + static_cast<int64_t>(b) * n * row_stride + h * D,
                row_stride, acc, scale, r0, r1, n, t);
}

// Kernel 2: dk and dv, one block per 64 keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ go,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int n, int heads,
                          float scale,
                          int64_t qsb, int64_t qsn, int64_t qsh,
                          int64_t ksb, int64_t ksn, int64_t ksh,
                          int64_t vsb, int64_t vsn, int64_t vsh,
                          int64_t gsb, int64_t gsn, int64_t gsh) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBT][D + 8];   // q tile [query][d]
  __shared__ __align__(16) __nv_bfloat16 gs[kBT][D + 8];   // g tile [query][d]
  __shared__ __align__(16) __nv_bfloat16 qt[D][kBT + 8];   // q tile [d][query]
  __shared__ __align__(16) __nv_bfloat16 gt[D][kBT + 8];   // g tile [d][query]
  __shared__ float slse[kBT], sdel[kBT];

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* gb = go + b * gsb + h * gsh;
  const int64_t stat = static_cast<int64_t>(bh) * n;

  // This thread's key rows; s^T and t^T have keys as rows, queries as columns.
  const int r0 = blockIdx.x * kBM + warp * 16 + g, r1 = r0 + 8;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_frags<D>(kf, k + b * ksb + h * ksh, ksn, r0, r1, n, t);
  load_frags<D>(vf, v + b * vsb + h * vsh, vsn, r0, r1, n, t);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc_k[i][0] = acc_k[i][1] = acc_k[i][2] = acc_k[i][3] = 0.f;
    acc_v[i][0] = acc_v[i][1] = acc_v[i][2] = acc_v[i][3] = 0.f;
  }

  float s[8][4], tt[8][4];
  for (int q0 = 0; q0 < n; q0 += kBT) {
    __syncthreads();
    stage<D>(qs, qt, qb, qsn, q0, n);
    stage<D>(gs, gt, gb, gsn, q0, n);
    if (threadIdx.x < kBT) {
      // lse = +inf past the last query: its column of p and ds is zero
      const int r = q0 + threadIdx.x;
      slse[threadIdx.x] = r < n ? lse[stat + r] : CUDART_INF_F;
      sdel[threadIdx.x] = r < n ? delta[stat + r] : 0.f;
    }
    __syncthreads();
    rows_times_tile<D>(s, kf, qs, g, t);
    rows_times_tile<D>(tt, vf, gs, g, t);
    uint32_t pf[4][4], df[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + t * 2;
      float p[4], d[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float ls = slse[col + (c & 1)], del = sdel[col + (c & 1)];
        p[c] = __expf(scale * s[nt][c] - ls);
        d[c] = p[c] * (tt[nt][c] - del);
      }
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      pf[kk][hi] = pack_bf16(p[0], p[1]);
      pf[kk][hi + 1] = pack_bf16(p[2], p[3]);
      df[kk][hi] = pack_bf16(d[0], d[1]);
      df[kk][hi + 1] = pack_bf16(d[2], d[3]);
    }
    tile_times_rows<D>(acc_k, df, qt, g, t);
    tile_times_rows<D>(acc_v, pf, gt, g, t);
  }
  const int64_t row_stride = static_cast<int64_t>(heads) * D;
  const int64_t off = static_cast<int64_t>(b) * n * row_stride + h * D;
  store_rows<D>(dk + off, row_stride, acc_k, scale, r0, r1, n, t);
  store_rows<D>(dv + off, row_stride, acc_v, 1.f, r0, r1, n, t);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* go, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int batch, int n, int heads, float scale,
           const int64_t* st, cudaStream_t stream) {
  const dim3 grid((n + kBM - 1) / kBM, batch * heads);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(go);
  flash_attn_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(
      qp, kp, vp, static_cast<const __nv_bfloat16*>(o), gp,
      static_cast<const float*>(lse), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(delta), n, heads, scale, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14]);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attn_bwd_dkv_kernel<D><<<grid, kThreads, 0, stream>>>(
      qp, kp, vp, gp, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n, heads, scale, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, g: (B, N, H, D) bf16 with element strides (s_b, s_n, s_h)
// each in `strides` order q, k, v, out, g; head dim contiguous.  lse:
// (B, H, N) fp32, the forward's.  dq, dk, dv: (B, N, H, D) bf16 contiguous.
// delta: (B*H, N) fp32 scratch.  D in {16, 32, 64, 80}.  Returns
// cudaGetLastError().
extern "C" int dupl_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* out,
                                        const void* g, const void* lse,
                                        void* dq, void* dk, void* dv,
                                        void* delta, int batch, int n,
                                        int heads, int head_dim, float scale,
                                        const int64_t* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, out, g, lse, dq, dk, dv, delta, batch, n, heads, scale, strides, s);
    case 32: return launch<32>(q, k, v, out, g, lse, dq, dk, dv, delta, batch, n, heads, scale, strides, s);
    case 64: return launch<64>(q, k, v, out, g, lse, dq, dk, dv, delta, batch, n, heads, scale, strides, s);
    case 80: return launch<80>(q, k, v, out, g, lse, dq, dk, dv, delta, batch, n, heads, scale, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
