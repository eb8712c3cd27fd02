// Max-free single-pass softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dupl_tpu/ops/attention.py:_exp_attn_kernel
// (launched by _exp_attention_bhnd).  Same numerics: q arrives pre-scaled
// and rounded to bf16; s = q.k^T accumulates in fp32; e = exp(min(s, 60));
// the denominator sums the fp32 e; the numerator contracts bf16(e) with
// bf16 v in fp32; out = numerator / denominator, rounded to bf16.
//
// Design.  One block per (64-query tile, batch*head); four warps, each owning
// 16 query rows, with its q fragments in registers.  The TPU kernel keeps all
// of K and V for one head resident in VMEM; at N = 1765 that is 229 KB each,
// more than a Hopper SM's 227 KB of shared memory, so here the block loops
// over 64-key tiles of K and V^T staged in shared memory.  Because the
// softmax is max-free there is no running max and no rescale of the
// accumulators between tiles: the block accumulates sum(e) and bf16(e).v in
// fp32 and divides once.  Keys past N are masked (e = 0); nothing is padded
// in device memory.  The products run on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the exp runs on the SFU.
//
// Bound.  Per head 4*N^2*D tensor-core FLOPs and N^2 exps, against
// 3 * N * D * 2 bytes of q, k, v: compute-bound (each block re-reads K and V
// from L2, about 85 FLOPs per byte of that traffic with 64-row query tiles).  This first
// version issues mma.sync without software pipelining of the K/V loads;
// wgmma and TMA come later.
//
// Layout.  q, k, v are (B, N, H, D) with arbitrary strides for B, N and H
// (multiples of 8 elements, 16-byte aligned base), so the wrapper can hand in
// column slices of the qkv projection without copies.  out is (B, N, H, D)
// contiguous.  D is a template parameter: 16, 32, 64 (every DeiT/ViT up to
// ViT-L) or 80 (ViT-H).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block (4 warps x 16)
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr float kClamp = 60.0f;

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
exp_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int n, int heads,
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
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums of e

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

    // e = exp(min(s, 60)), zero past the last key.  The accumulator layout
    // of two neighbouring n-tiles is the A-fragment layout of one 16-key
    // k-step, so e packs straight into the operand of the second product.
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int key = k0 + nt * 8 + t * 2;
      const bool in0 = key < n, in1 = key + 1 < n;
      const float e0 = in0 ? __expf(fminf(s[nt][0], kClamp)) : 0.f;
      const float e1 = in1 ? __expf(fminf(s[nt][1], kClamp)) : 0.f;
      const float e2 = in0 ? __expf(fminf(s[nt][2], kClamp)) : 0.f;
      const float e3 = in1 ? __expf(fminf(s[nt][3], kClamp)) : 0.f;
      l0 += e0 + e1;
      l1 += e2 + e3;
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      pf[kk][hi] = pack_bf16(e0, e1);      // row g
      pf[kk][hi + 1] = pack_bf16(e2, e3);  // row g + 8
    }

    // o += bf16(e).v: 4 k-steps of 16 keys x D/8 n-tiles over the head dim.
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
  // columns.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

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
void launch(const void* q, const void* k, const void* v, void* out, int batch,
            int n, int heads, const int64_t* st, cudaStream_t stream) {
  const dim3 grid((n + kBQ - 1) / kBQ, batch * heads);
  exp_attn_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), n,
      heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 with element strides (s_b, s_n, s_h), head dim
// contiguous; out: (B, N, H, D) bf16 contiguous; D in {16, 32, 64, 80}.
// Returns cudaGetLastError().
extern "C" int dupl_exp_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int n, int heads, int head_dim,
                                      int64_t qsb, int64_t qsn, int64_t qsh,
                                      int64_t ksb, int64_t ksn, int64_t ksh,
                                      int64_t vsb, int64_t vsn, int64_t vsh,
                                      void* stream) {
  const int64_t st[9] = {qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: launch<16>(q, k, v, out, batch, n, heads, st, s); break;
    case 32: launch<32>(q, k, v, out, batch, n, heads, st, s); break;
    case 64: launch<64>(q, k, v, out, batch, n, heads, st, s); break;
    case 80: launch<80>(q, k, v, out, batch, n, heads, st, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
