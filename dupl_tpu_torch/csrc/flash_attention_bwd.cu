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
// p <= 1 always, so nothing is clamped.  The exps run as exp2 of scores
// pre-multiplied by scale * log2(e) against lse * log2(e).
//
// Bound.  The function needs 10*N^2*D tensor-core FLOPs and N^2 exps a head
// against 8 * N * D * 2 bytes of operands and results: bound by operations.
// This design issues 14*N^2*D (both kernels recompute the s and t tiles);
// the fused single sweep that issues 10 needs atomic dq sums, which would
// give up the same result from run to run, and is not taken.
//
// Design (attention_bwd.cuh, shared with K2).  Two kernels, each with a
// producer warp feeding a three-stage TMA ring and two consumer warpgroups
// running every product on wgmma:
//   * kernel 1, one block per 128 query rows, forms delta from its own rows
//     of out and g, writes delta and lse * log2(e) to a padded (B*H, Npad)
//     scratch (+inf and 0 past N), and sweeps the 64-key tiles of K and V:
//     S = Q.K^T, T = G.V^T, ds, dQ += dS.K;
//   * kernel 2, one block per 128 keys, sweeps the 64-query tiles of q and
//     g with their scratch entries, forms S^T and T^T directly and
//     accumulates dK += dS^T.Q and dV += P^T.G (at D 80 in two passes, dv
//     then dk).
// Every output element is owned by one thread: no atomics, and the result
// is the same from run to run.
//
// Operands.  q, k, v, out, g are (B, N, H, D) with arbitrary strides for B,
// N and H (multiples of 8 elements, 16-byte aligned base); k and v are
// column slices of the qkv projection.  lse is (B, H, N) fp32.  dq, dk, dv
// are (B, N, H, D) contiguous.  D is a template parameter: 16, 32, 64 or 80.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd.cuh"

namespace {

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* go, const void* lse, void* dq, void* dk, void* dv,
           void* scratch, int batch, int n, int heads, float scale,
           const int64_t* st, cudaStream_t stream) {
  // stride triples in the order q, k, v, out, g; scratch: lse * log2(e),
  // then delta
  float* stat_pad = static_cast<float*>(scratch);
  float* delta_pad =
      stat_pad + static_cast<int64_t>(batch) * heads * attn_bwd::padded(n);
  return attn_bwd::launch<D, false>(
      q, st, k, st + 3, v, st + 6, go, st + 12, o, st + 9,
      static_cast<const float*>(lse), dq, dk, dv, stat_pad, delta_pad, batch, n,
      heads, scale, scale * attn_bwd::kLog2e, stream);
}

}  // namespace

// q, k, v, out, g: (B, N, H, D) bf16 with element strides (s_b, s_n, s_h)
// each in `strides` order q, k, v, out, g; head dim contiguous.  lse:
// (B, H, N) fp32, the forward's.  dq, dk, dv: (B, N, H, D) bf16 contiguous.
// scratch: (2, B*H, Npad) fp32, Npad = N rounded up to 64.  D in
// {16, 32, 64, 80}.  Returns cudaGetLastError(), or cudaErrorInvalidValue if
// the driver refuses a tensor map.
extern "C" int dupl_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* out,
                                        const void* g, const void* lse,
                                        void* dq, void* dk, void* dv,
                                        void* scratch, int batch, int n,
                                        int heads, int head_dim, float scale,
                                        const int64_t* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, out, g, lse, dq, dk, dv, scratch, batch, n, heads, scale, strides, s);
    case 32: return launch<32>(q, k, v, out, g, lse, dq, dk, dv, scratch, batch, n, heads, scale, strides, s);
    case 64: return launch<64>(q, k, v, out, g, lse, dq, dk, dv, scratch, batch, n, heads, scale, strides, s);
    case 80: return launch<80>(q, k, v, out, g, lse, dq, dk, dv, scratch, batch, n, heads, scale, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
