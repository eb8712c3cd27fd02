// Exact softmax attention forward (flash attention) for Hopper (sm_90a).
//
// Replaces the library Pallas TPU flash attention that
// dupl_tpu/ops/attention.py:dot_attention calls for sequences of 2048 tokens
// or more (flash_attention with SegmentIds padding and explicit BlockSizes).
// Same numerics: q, k, v arrive in bf16 and unscaled; s = scale * (q.k^T) in
// fp32 with the scale applied to the scores in the kernel; softmax with a
// running row maximum; the denominator sums the fp32 p = exp(s - m); the
// numerator contracts bf16(p) with bf16 v in fp32; out = numerator /
// denominator, rounded to bf16 once.  The row log-sum-exp m + log(l) is
// written in fp32 for the backward kernel (flash_attention_bwd.cu).
//
// Design.  The TPU call pads the sequence to a multiple of 128, keeps all of
// K and V of a head as one block (block_k = the padded length) and masks the
// padding with segment ids.  One head's K and V at N = 2117 are 271 KB each,
// more than a Hopper block's 227 KB of shared memory, so here one block owns
// 64 query rows (four warps of 16 rows, q fragments in registers) and loops
// over 64-key tiles of K and V^T staged in shared memory: the online softmax
// of flash attention.  Per tile the row maximum is updated, the accumulator
// and the running sum are rescaled by exp(m_old - m_new), and the tile's
// bf16(p) goes straight from the accumulator layout of the first product
// into the A operand of the second.  Keys past N are masked to -inf in the
// kernel; nothing is padded in device memory and there are no segment ids.
// The products run on the tensor cores through mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate); the exps run on the SFU.
//
// Bound.  Per head 4*N^2*D tensor-core FLOPs and N^2 exps against 4 * N * D
// * 2 bytes of q, k, v and out: bound by operations.  This first version
// issues mma.sync without software pipelining of the K/V loads; wgmma, TMA
// and a K/V ring come later.
//
// Layout.  q, k, v are (B, N, H, D) with arbitrary strides for B, N and H
// (multiples of 8 elements, 16-byte aligned base): column slices of the qkv
// projection, no copies.  out is (B, N, H, D) contiguous, lse (B, H, N)
// fp32.  D is a template parameter: 16, 32, 64 or 80.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block (4 warps x 16)
constexpr int kBK = 64;         // keys per shared-memory tile
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

// Shared-memory rows are padded by 8 bf16 so that the 32-bit fragment reads
// of a warp (8 rows x 4 column pairs) fall in distinct banks.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int n, int heads, float scale,
                      int64_t qsb, int64_t qsn, int64_t qsh,
                      int64_t ksb, int64_t ksn, int64_t ksh,
                      int64_t vsb, int64_t vsn, int64_t vsh) {
  constexpr int kSteps = D / 16;  // 16-wide k-steps of q.k^T
  constexpr int kTiles = D / 8;   // 8-wide n-tiles of the output
  __shared__ __align__(16) __nv_bfloat16 ks[kBK][D + 8];   // K tile [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt[D][kBK + 8];   // V tile [d][key]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  // A fragments of this warp's 16 query rows over the full head dim.
  const int r0 = blockIdx.x * kBQ + warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = r0 < n ? ld32(qb + r0 * qsn + c) : 0u;
    qf[kk][1] = r1 < n ? ld32(qb + r1 * qsn + c) : 0u;
    qf[kk][2] = r0 < n ? ld32(qb + r0 * qsn + c + 8) : 0u;
    qf[kk][3] = r1 < n ? ld32(qb + r1 * qsn + c + 8) : 0u;
  }

  float o[kTiles][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // Running row maxima (whole rows, equal in the four threads of a row
  // group) and this thread's share of the running row sums of p.
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * D / 8; i += kThreads) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8, key = k0 + row;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < n) {
        kv = *reinterpret_cast<const uint4*>(kb + key * ksn + col);
        vv = *reinterpret_cast<const uint4*>(vb + key * vsn + col);
      }
      *reinterpret_cast<uint4*>(&ks[row][col]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[col + j][row] = ve[j];
    }
    __syncthreads();

    // s = q.k^T: 16 rows x 64 keys as 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + t * 2];
        const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
        mma_bf16_16816(s[nt], qf[kk], bf);
      }
    }

    // Scale, mask the keys past N to -inf, and take the tile's row maxima.
    // Every tile holds at least one key, so the new maxima are finite.
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int key = k0 + nt * 8 + t * 2;
      const bool in0 = key < n, in1 = key + 1 < n;
      s[nt][0] = in0 ? s[nt][0] * scale : -CUDART_INF_F;
      s[nt][1] = in1 ? s[nt][1] * scale : -CUDART_INF_F;
      s[nt][2] = in0 ? s[nt][2] * scale : -CUDART_INF_F;
      s[nt][3] = in1 ? s[nt][3] * scale : -CUDART_INF_F;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, m));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, m));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // exp(-inf) = 0 at the first tile, where nothing is accumulated yet
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      o[nt][0] *= c0;
      o[nt][1] *= c0;
      o[nt][2] *= c1;
      o[nt][3] *= c1;
    }

    // p = exp(s - m), 0 for a masked key.  The accumulator layout of two
    // neighbouring n-tiles is the A-fragment layout of one 16-key k-step, so
    // p packs straight into the operand of the second product.
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float e0 = __expf(s[nt][0] - m0);
      const float e1 = __expf(s[nt][1] - m0);
      const float e2 = __expf(s[nt][2] - m1);
      const float e3 = __expf(s[nt][3] - m1);
      l0 += e0 + e1;
      l1 += e2 + e3;
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      pf[kk][hi] = pack_bf16(e0, e1);      // row g
      pf[kk][hi + 1] = pack_bf16(e2, e3);  // row g + 8
    }

    // o += bf16(p).v: 4 k-steps of 16 keys x D/8 n-tiles over the head dim.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const __nv_bfloat16* vr = &vt[nt * 8 + g][kk * 16 + t * 2];
        const uint32_t bf[2] = {ld32(vr), ld32(vr + 8)};
        mma_bf16_16816(o[nt], pf[kk], bf);
      }
    }
  }

  // Full row sums: the four threads of a fragment row group hold disjoint
  // columns, all relative to the same maximum.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  if (t == 0) {
    float* lb = lse + static_cast<int64_t>(bh) * n;
    if (r0 < n) lb[r0] = m0 + logf(l0);
    if (r1 < n) lb[r1] = m1 + logf(l1);
  }
  const int64_t row_stride = static_cast<int64_t>(heads) * D;
  __nv_bfloat16* ob = out + static_cast<int64_t>(b) * n * row_stride + h * D;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    const int c = nt * 8 + t * 2;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + c) =
          pack_bf16(o[nt][0] / l0, o[nt][1] / l0);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(ob + r1 * row_stride + c) =
          pack_bf16(o[nt][2] / l1, o[nt][3] / l1);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* out, void* lse,
            int batch, int n, int heads, float scale, const int64_t* st,
            cudaStream_t stream) {
  const dim3 grid((n + kBQ - 1) / kBQ, batch * heads);
  flash_attn_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), n, heads, scale, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8]);
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 with element strides (s_b, s_n, s_h) each in
// `strides` order q, k, v, head dim contiguous; out: (B, N, H, D) bf16
// contiguous; lse: (B, H, N) fp32; D in {16, 32, 64, 80}.  Returns
// cudaGetLastError().
extern "C" int dupl_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int batch, int n, int heads,
                                        int head_dim, float scale,
                                        const int64_t* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: launch<16>(q, k, v, out, lse, batch, n, heads, scale, strides, s); break;
    case 32: launch<32>(q, k, v, out, lse, batch, n, heads, scale, strides, s); break;
    case 64: launch<64>(q, k, v, out, lse, batch, n, heads, scale, strides, s); break;
    case 80: launch<80>(q, k, v, out, lse, batch, n, heads, scale, strides, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
