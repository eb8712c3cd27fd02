// Max-free single-pass softmax attention forward (kernel K1) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel dupl_tpu/ops/attention.py:_exp_attn_kernel
// (launched by _exp_attention_bhnd).  Same numerics: q arrives pre-scaled
// and rounded to bf16; s = q.k^T accumulates in fp32; e = exp(min(s, 60));
// the denominator sums the fp32 e; the numerator contracts bf16(e) with
// bf16 v in fp32; out = numerator / denominator, rounded to bf16 once.  The
// exps run as exp2(min(s * log2(e), 60 * log2(e))).
//
// Bound.  Per head 4*N^2*D tensor-core FLOPs and N^2 exps against 4 * N * D
// * 2 bytes of q, k, v and out: bound by operations.  At BH 192, N 1765,
// D 64 that is 1.53e11 FLOP, 0.155 ms at 989 TFLOP/s, against 0.052 ms for
// the bytes at 3.35 TB/s; the 6.0e8 exps take about as long (0.14 ms at the
// special-function units' 16 a clock an SM) as the products at the tensor
// cores' peak, so the exps of one tile have to run under the products of
// another.
//
// Design (attention_fwd.cuh, shared with L1f's flash attention, P1 and P2).  The TPU
// kernel keeps one head's K and V resident in VMEM; at N 1765 that is 229 KB
// each, more than an SM's 227 KB of shared memory, so here one block owns
// 128 query rows of one head and streams K and V in 128-key tiles: a
// producer warp issues TMA copies into a three-stage mbarrier ring, and two
// consumer warpgroups of 64 rows each run both products on wgmma, the
// scores from shared memory (K-major), the value product with bf16(e) from
// registers (the score accumulator packed to bf16 pairs is wgmma's
// register-A layout) and V read through the descriptor's transpose bit, so
// nothing is transposed in shared memory.  Because the softmax is max-free
// there is no running maximum and no rescale of the accumulator: the scores
// of tile i + 1 and the value product of tile i go to the tensor cores back
// to back, with the exps of tile i + 1 in between and nothing to correct.
// Keys past N get e = 0, and a warpgroup whose 64 rows lie wholly past N
// exits at once (the second half of the last block at N 442 and 785, the
// training step's lengths).
//
// Operands.  q, k, v are (B, N, H, D) with arbitrary strides for B, N and H
// (multiples of 8 elements, 16-byte aligned base), so the wrapper hands in
// column slices of the qkv projection without copies; one TMA tensor map
// per operand and column chunk (hopper.cuh).  out is (B, N, H, D)
// contiguous.  D is a template parameter: 16, 32, 64 (every DeiT/ViT up to
// ViT-L) or 80 (ViT-H, as a 64-column and a 16-column chunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n, int heads, const int64_t* st, cudaStream_t stream) {
  return attn_fwd::launch<D, attn_fwd::Step::kMaxFree>(
      q, k, v, out, nullptr, batch, n, heads, attn_fwd::kLog2e, st, stream);
}

}  // namespace

// q, k, v: (B, N, H, D) bf16 with element strides (s_b, s_n, s_h), head dim
// contiguous; out: (B, N, H, D) bf16 contiguous; D in {16, 32, 64, 80}.
// Returns cudaGetLastError(), or cudaErrorInvalidValue if the driver refuses
// a tensor map.
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
    case 16: return launch<16>(q, k, v, out, batch, n, heads, st, s);
    case 32: return launch<32>(q, k, v, out, batch, n, heads, st, s);
    case 64: return launch<64>(q, k, v, out, batch, n, heads, st, s);
    case 80: return launch<80>(q, k, v, out, batch, n, heads, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
