// Max-free exp attention whose row sum comes out of the second product
// (kernel P1) for Hopper (sm_90a):
// out = (bf16(e) . [V | 1])[:, :D] / (bf16(e) . [V | 1])[:, D].
//
// Replaces the Pallas TPU kernel tools/exp_attn_experiment.py:
// _exp_attn_kernel_ones (launched by exp_attention_ones), the "ones column"
// variant of the exp-attention forward.  Same numerics: q arrives pre-scaled
// in bf16; s = q.k^T in fp32; e = bf16(exp(min(s, 60))); numerator AND
// denominator contract that bf16 e in fp32 on the tensor cores, so both
// carry the same rounding; out = numerator / denominator, rounded to bf16.
// The TPU kernel appends the ones column to V in device memory and pads q,
// k and v to a multiple of 128 rows; padded keys drop out because their V
// rows, ones column included, are zero.
//
// Design: K1's (attention_fwd.cuh, Step::kMaxFreeOnes).  One block owns 128
// query rows of one (batch, head); a producer warp feeds a three-stage TMA
// ring of 128-key K and V tiles; two consumer warpgroups run S = Q.K^T on
// wgmma from shared memory and O += bf16(e).[V | 1] on wgmma from
// registers, V through the transpose bit, the exps of tile i + 1 under the
// value product of tile i.  The ones column is not copied into V: each
// consumer warpgroup writes a constant tile of ones (16 rows, as wide as
// V's last column chunk) into shared memory once, and the value product's
// last wgmma of every 16-key k-step is 8 columns wider than V's chunk
// (m64n72k16 at D 64), those 8 columns read from the ones tile as the
// next atom along N.  So sum(bf16(e)) accumulates in fp32 in the same
// instruction as the numerator, and K1's fp32 row-sum adds go.  Keys past N
// are masked to e = 0 by the max-free step already, which is what the TPU
// kernel's zero V rows give.  A separate m64n8k16 against the ones tile a
// k-step (8 more wgmma a tile) was measured slower on the card than the
// widened product and was dropped.  (The same function could add the
// bf16(e) on the CUDA cores; the experiment asks whether the tensor cores
// can take the denominator, so this kernel does not.)
//
// Bound.  Per head N^2 * (4 * D + 2) tensor-core FLOPs (the ones column's
// useful work; the 8 extra columns issue 16 N^2) and N^2 exps against
// 4 * N * D * 2 bytes of q, k, v and out: bound by operations.  At BH 768,
// N 1765, D 64 that is 6.17e11 FLOP, 0.624 ms at 989 TFLOP/s, against
// 0.104 ms for the bytes; the 2.39e9 exps take 0.57 ms at the
// special-function units' 16 a clock an SM, so, as in K1, the exps of one
// tile have to run under the products of another.
//
// Operands.  q, k, v: (B, N, H, D) with arbitrary strides for B, N and H
// (multiples of 8 elements, 16-byte aligned base); a (BH, N, D) operand is
// the case H = 1.  out is (B, N, H, D) contiguous.  D in {16, 32, 64, 80}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n, int heads, const int64_t* st, cudaStream_t stream) {
  return attn_fwd::launch<D, attn_fwd::Step::kMaxFreeOnes>(
      q, k, v, out, nullptr, batch, n, heads, 0.f, st, stream);
}

}  // namespace

// q (pre-scaled), k, v: (B, N, H, D) bf16 with element strides (s_b, s_n,
// s_h) each in `strides` order q, k, v, head dim contiguous; out:
// (B, N, H, D) bf16 contiguous; D in {16, 32, 64, 80}.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue if the
// tensor-map encoder refuses an operand.
extern "C" int dupl_exp_attention_ones(const void* q, const void* k,
                                       const void* v, void* out, int batch,
                                       int n, int heads, int head_dim,
                                       const int64_t* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, out, batch, n, heads, strides, s);
    case 32: return launch<32>(q, k, v, out, batch, n, heads, strides, s);
    case 64: return launch<64>(q, k, v, out, batch, n, heads, strides, s);
    case 80: return launch<80>(q, k, v, out, batch, n, heads, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
