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
// written in fp32 for the backward kernel (flash_attention_bwd.cu).  The
// exps run as exp2 of scores pre-multiplied by scale * log2(e).
//
// Bound.  Per head 4*N^2*D tensor-core FLOPs and N^2 exps against 4 * N * D
// * 2 bytes of q, k, v and out: bound by operations.  At D 64 the two are
// nearly equal on an H100: the exps alone take about as long at the
// special-function units' rate (16 a clock an SM) as the products at the
// tensor cores' peak.  So the kernel has to keep the tensor cores fed while
// the exps of the same block run.
//
// Design (attention_fwd.cuh, shared with K1).  One block owns 128 query
// rows of one head and walks the whole row of keys in 128-key tiles (the
// online softmax of flash attention: per tile the row maximum is updated,
// the accumulator and the running sum are rescaled by exp(m_old - m_new),
// and the tile's bf16(p) is contracted with V).  A producer warp feeds a
// three-stage TMA ring of K and V tiles; two consumer warpgroups of 64 rows
// run both products on wgmma (p from registers, V through the descriptor's
// transpose bit) in a two-tile software pipeline, the softmax of tile i + 1
// under the value product of tile i, which meets the exp co-bound.
// The alternative, the two warpgroups taking turns at issuing their
// products (named barriers, the softmax of one under the products of the
// other), was tried on top of this pipeline and was not faster at
// chip_smoke.py phase 14's shapes, so it was left out: it couples the
// warpgroups for no gain.  (That trial ran while ptxas still serialised the
// wgmmas; it has not been repeated since.)
//
// Operands.  q, k, v are (B, N, H, D) with arbitrary strides for B, N and H
// (multiples of 8 elements, 16-byte aligned base): column slices of the qkv
// projection, no copies.  The host encodes one 4-D TMA tensor map (D, H, N,
// B) per operand and column chunk from those strides (hopper.cuh).  D 64
// rows are 128 bytes, the 128-byte swizzle atom that TMA and wgmma share;
// D 16 and 32 use the 32- and 64-byte swizzles; D 80 is a 64-column chunk
// and a 16-column chunk.  Rows past N arrive zero-filled; a zero key row
// would score 0, so keys past N are masked to -inf in the kernel; nothing is
// padded in device memory.  out is (B, N, H, D) contiguous, lse (B, H, N)
// fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int n, int heads, float scale, const int64_t* st,
           cudaStream_t stream) {
  return attn_fwd::launch<D, false>(q, k, v, out, static_cast<float*>(lse),
                                    batch, n, heads, scale * attn_fwd::kLog2e,
                                    st, stream);
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 with element strides (s_b, s_n, s_h) each in
// `strides` order q, k, v, head dim contiguous; out: (B, N, H, D) bf16
// contiguous; lse: (B, H, N) fp32; D in {16, 32, 64, 80}.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue if the driver refuses a
// tensor map.
extern "C" int dupl_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int batch, int n, int heads,
                                        int head_dim, float scale,
                                        const int64_t* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, out, lse, batch, n, heads, scale, strides, s);
    case 32: return launch<32>(q, k, v, out, lse, batch, n, heads, scale, strides, s);
    case 64: return launch<64>(q, k, v, out, lse, batch, n, heads, scale, strides, s);
    case 80: return launch<80>(q, k, v, out, lse, batch, n, heads, scale, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
