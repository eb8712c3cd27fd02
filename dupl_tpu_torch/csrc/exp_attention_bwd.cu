// Backward of the max-free exp attention (kernel K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// dupl_tpu/ops/attention.py:_exp_attn_bwd_kernel (launched by
// _exp_attention_bwd_fused), the backward of exp_attention.cu's forward.
// Same numerics.  With q pre-scaled and everything bf16 on the way in:
//   s = q.k^T (fp32), e = exp(min(s, 60)), p = e / sum_j e       (fp32)
//   t = g.v^T (fp32), delta = sum_j p*t                           (fp32)
//   ds = bf16(p * (t - delta)), 0 where s >= 60
//   dq = ds.k, dk = ds^T.q, dv = bf16(p)^T.g   (fp32 sums, bf16 results)
// delta stays the sum of the fp32 p times t: the forward's out is bf16(sum
// bf16(e) v) / sum e, so rowsum(out * g), the flash backward's delta, is
// another quantity.
//
// Bound.  The function needs 10*N^2*D tensor-core FLOPs and N^2 exps a head
// against 7 * N * D * 2 bytes of operands and results: bound by operations.
// At B*H = 48, N = 785, D = 64 that is 1.9e10 FLOP, 0.019 ms at 989 TFLOP/s,
// against 34 MB, 0.010 ms at 3.35 TB/s.  This design issues 18*N^2*D: the
// statistics take a sweep of their own (S and T, 4*N^2*D), and both kernels
// recompute the s and t tiles; what it does about that is to run all of it
// on wgmma, fed by TMA.
//
// Design (attention_bwd.cuh, shared with L1b's flash backward).  The TPU
// kernel runs one program per (batch, head) and keeps four (N, N) fp32
// buffers of that head on chip; one head's operands alone (4 x N x D bf16)
// overflow a Hopper block's 227 KB at the training lengths, and blocks run
// in no order, so the work is tiled and the score tile is recomputed
// instead of kept.  Two kernels, no atomics, the same bits from run to run
// (which --resume relies on):
//   * kernel 1, one block per 128 query rows (q and g copied once by TMA),
//     sweeps the 64-key K/V tiles of a three-stage TMA ring twice: sweep 1
//     forms S = Q.K^T and T = G.V^T and accumulates sum_j e and sum_j e*t in
//     fp32 (max-free, so final after one sweep, nothing rescaled; keys past
//     N count e = 0), and writes 1 / sum e and delta to the wrapper's padded
//     scratch; sweep 2 recomputes S and T, forms ds (zero where s >= 60,
//     comparing s itself) and accumulates dQ += dS.K, the update of tile i
//     in flight with the scores of tile i + 1;
//   * kernel 2, one block per 128 keys (k and v copied once), sweeps the
//     64-query tiles of q and g with their scratch entries (bulk copies),
//     forms S^T = K.Q^T and T^T = V.G^T, so that p^T and ds^T come out as
//     wgmma register-A operands, and accumulates dK += dS^T.Q and dV +=
//     bf16(P^T).G, Q and G read through the descriptor's transpose bit.  A
//     query past N reads 1 / sum e = 0 from the padded scratch, so its
//     column of p and ds is exactly zero.  At D 80 it runs twice, dv then
//     dk, for registers.
//
// Operands.  q, k, v, g are (B, N, H, D) with arbitrary strides for B, N and
// H (multiples of 8 elements, 16-byte aligned base); k and v are column
// slices of the qkv projection.  dq, dk, dv are (B, N, H, D) contiguous.
// D is a template parameter: 16, 32, 64 or 80, the forward kernel's set.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd.cuh"

namespace {

template <int D>
int launch(const void* q, const void* k, const void* v, const void* go,
           void* dq, void* dk, void* dv, void* inv_sum, void* delta, int batch,
           int n, int heads, const int64_t* st, cudaStream_t stream) {
  // stride triples in the order q, k, v, g; no out and no lse
  return attn_bwd::launch<D, true>(
      q, st, k, st + 3, v, st + 6, go, st + 9, nullptr, nullptr, nullptr, dq, dk,
      dv, static_cast<float*>(inv_sum), static_cast<float*>(delta), batch, n,
      heads, 1.f, attn_bwd::kLog2e, stream);
}

}  // namespace

// q, k, v, g: (B, N, H, D) bf16 with element strides (s_b, s_n, s_h) each in
// `strides` order q, k, v, g; head dim contiguous.  dq, dk, dv: (B, N, H, D)
// bf16 contiguous.  inv_sum, delta: (B*H, Npad) fp32 scratch each, Npad = N
// rounded up to 64.  D in {16, 32, 64, 80}.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue if the driver refuses a tensor map.
extern "C" int dupl_exp_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* g, void* dq,
                                      void* dk, void* dv, void* inv_sum,
                                      void* delta, int batch, int n, int heads,
                                      int head_dim, const int64_t* strides,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, g, dq, dk, dv, inv_sum, delta, batch, n, heads, strides, s);
    case 32: return launch<32>(q, k, v, g, dq, dk, dv, inv_sum, delta, batch, n, heads, strides, s);
    case 64: return launch<64>(q, k, v, g, dq, dk, dv, inv_sum, delta, batch, n, heads, strides, s);
    case 80: return launch<80>(q, k, v, g, dq, dk, dv, inv_sum, delta, batch, n, heads, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
