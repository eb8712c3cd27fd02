// Max-free exp attention on (B, N, H, D) operands with the q scale folded
// into the kernel (kernel P2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/exp_attn_layout_experiment.py:
// _kernel_bnhd (launched by exp_attention_bnhd), the layout variant of the
// exp-attention forward.  Same numerics: q arrives UNSCALED in bf16 and is
// multiplied by the scale as a bf16 product (the scale rounded to bf16, the
// product rounded to bf16); s = q.k^T in fp32; e = exp(min(s, 60)); the
// denominator sums the fp32 e over the real keys; the numerator contracts
// bf16(e) with bf16 v in fp32; out = numerator / denominator in bf16.  The
// TPU kernel corrects its row sum for its zero-padded keys (each adds
// exp(0) = 1); here keys past N are masked to e = 0, which is the same sum.
//
// The TPU variant exists to read q and v blocks straight out of the
// (B, N, H, D) array and to write the output there, saving the transposes
// and pads of the (BH, N, D) form.  K1 already addresses its operands by
// (batch, token, head) strides and pads nothing, so on this card the layout
// half of the variant is the baseline; what this kernel adds is the scale:
// the separate elementwise pass that scales and rounds q (one read and one
// write of q in device memory, and a launch) becomes a pass over the
// block's q tile in shared memory.
//
// Design: K1's (attention_fwd.cuh, Step::kMaxFree with kScaleQ).  One block
// owns 128 query rows of one (batch, head); a producer warp loads its q
// rows and feeds a three-stage TMA ring of 128-key K and V tiles; two
// consumer warpgroups run both products on wgmma (scores from shared
// memory, bf16(e) from registers, V through the transpose bit), the exps of
// tile i + 1 under the value product of tile i.  Once q has landed, each
// consumer warpgroup multiplies its own 64 x D q tile in place by the bf16
// scale, rounding each product to bf16 (elementwise, so TMA's swizzle does
// not matter), then fences the stores for the async proxy and meets its
// 128 threads at a named barrier before its first wgmma: 8 KB a warpgroup
// at D 64, once a block.  From there on it is K1's step, tiling and order
// of sums, so P2 on q gives the bits of K1 on bf16(q * bf16(scale)).
//
// Bound.  Per head 4*N^2*D tensor-core FLOPs and N^2 exps against
// 4 * N * D * 2 bytes: bound by operations (K1's; the scale is N * D
// multiplies a head).  At B 64, H 12, N 1765, D 64: 6.12e11 FLOP, 0.619 ms
// at 989 TFLOP/s.
//
// Operands.  q, k, v: (B, N, H, D) with arbitrary strides for B, N and H
// (multiples of 8 elements, 16-byte aligned base); out (B, N, H, D)
// contiguous.  D in {16, 32, 64, 80}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n, int heads, float scale, const int64_t* st,
           cudaStream_t stream) {
  return attn_fwd::launch<D, attn_fwd::Step::kMaxFree, true>(
      q, k, v, out, nullptr, batch, n, heads, scale, st, stream);
}

}  // namespace

// q (unscaled), k, v: (B, N, H, D) bf16 with element strides (s_b, s_n,
// s_h) each in `strides` order q, k, v, head dim contiguous; scale: a value
// bf16 represents exactly; out: (B, N, H, D) bf16 contiguous; D in
// {16, 32, 64, 80}.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// if the tensor-map encoder refuses an operand.
extern "C" int dupl_exp_attention_bnhd(const void* q, const void* k,
                                       const void* v, void* out, int batch,
                                       int n, int heads, int head_dim,
                                       float scale, const int64_t* strides,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, out, batch, n, heads, scale, strides, s);
    case 32: return launch<32>(q, k, v, out, batch, n, heads, scale, strides, s);
    case 64: return launch<64>(q, k, v, out, batch, n, heads, scale, strides, s);
    case 80: return launch<80>(q, k, v, out, batch, n, heads, scale, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
