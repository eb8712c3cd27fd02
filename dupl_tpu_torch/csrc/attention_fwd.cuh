// The attention forward kernel for Hopper (sm_90a) shared by L1f
// (flash_attention.cu: exact softmax with a running row maximum) and K1
// (exp_attention.cu: max-free, scores clamped at 60).  Each source's own
// note says which TPU kernel it replaces, its numerics and its bound; this
// header holds the design they share.
//
// One block owns 128 query rows of one (batch, head) and walks the whole
// row of keys in 128-key tiles.  The block is warp-specialised:
//   * one producer warp (of a third warpgroup that gives its registers to
//     the others) issues TMA copies: the block's q rows once, then K and V
//     tiles into a ring of kStages stages, each with its own "full"
//     mbarriers (K and V apart, so that q.k^T starts before V lands) and an
//     "empty" mbarrier that the consumers release;
//   * two consumer warpgroups of 64 query rows each run both products on
//     wgmma: S = Q.K^T with Q and K read from shared memory (K-major), and
//     O += P.V with P from registers (the fp32 accumulator layout of S,
//     packed to bf16 pairs, is wgmma's register-A layout for k16) and V read
//     through the descriptor's transpose bit, so V is never transposed.
//     A warpgroup whose 64 rows all lie past N (the last block of a ragged
//     length) exits at once, and the empty barriers count only the
//     warpgroups that work.
// The exps are met by a two-tile software pipeline inside each consumer
// warpgroup: the scores of tile i + 1 and the value product of tile i go to
// the tensor cores back to back, and the exps of tile i + 1 (on the
// special-function units) run while the value product is in flight; the
// other warpgroup, on its own rows, fills the gaps.  The exps overwrite the
// finished fp32 score registers and are packed to bf16 only after the value
// product has retired: a bf16 tile written while the product is in flight
// would share registers with the tile the product reads (the compiler sees
// that tile die at the issue), and ptxas would then serialise every wgmma of
// the kernel; kernels/build.py fails a build in which ptxas reports
// serialised wgmmas.  The pipeline holds a score tile (fp32, 64 registers a
// thread) and the bf16 p tile in flight (32) beside the accumulator.
//
// The two softmaxes differ only in the per-tile step and the epilogue:
//   * exact (kMaxFree false): the tile's row maximum moves the running one,
//     the accumulator and the running sum are rescaled by exp(m_old - m_new),
//     p = exp2(s * scale * log2(e) - m); the epilogue also writes the row's
//     log-sum-exp;
//   * max-free (kMaxFree true): e = exp2(min(s * log2(e), 60 * log2(e))),
//     q arriving pre-scaled, and nothing is rescaled: the scores of tile
//     i + 1 and the value product of tile i have no correction step between
//     them.
// Either way the row sums add the fp32 p (or e) before it is packed to
// bf16, and out = O / l is rounded to bf16 once.
//
// Operands.  q, k, v are (B, N, H, D) with arbitrary strides for B, N and H
// (multiples of 8 elements, 16-byte aligned base): column slices of the qkv
// projection, no copies.  The host encodes one 4-D TMA tensor map (D, H, N,
// B) per operand and column chunk from those strides (hopper.cuh).  Rows
// past N arrive zero-filled; a zero key row would score 0, so keys past N
// are masked in the kernel (-inf before the exact softmax, e = 0 in the
// max-free one); nothing is padded in device memory.  out is (B, N, H, D)
// contiguous, lse (B, H, N) fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace attn_fwd {

using namespace hopper;

constexpr int kBQ = 128;        // query rows of a block: 2 warpgroups x 64
constexpr int kBK = 128;        // keys of a K/V tile
constexpr int kStages = 3;      // K/V ring depth
constexpr int kThreads = 384;   // 2 consumer warpgroups + 1 producer
// Shared memory asked for at the least: two blocks never share an SM, so
// the consumers' setmaxnreg.inc always finds the producer's registers.
constexpr int kOneBlockPerSm = 116 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kClampLog2 = 60.0f * kLog2e;  // the max-free clamp, log2 units

struct Maps {
  CUtensorMap q[2], k[2], v[2];  // per column chunk
};

template <int D>
struct Layout {
  using C = Chunks<D>;
  static constexpr int kQ = C::tile_bytes(64);    // one warpgroup's q rows
  static constexpr int kKV = C::tile_bytes(kBK);  // one K or V tile
  static constexpr int kK = 2 * kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBytes = kV + kStages * kKV + 1024;  // + alignment
};

template <int D, bool kMaxFree>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_kernel(const __grid_constant__ Maps maps,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int n, int heads, float scale_log2) {
  using C = Chunks<D>;
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t k_full = smem_u32(&bars[1]);             // + 8 * stage
  const uint32_t v_full = smem_u32(&bars[1 + kStages]);
  const uint32_t empty = smem_u32(&bars[1 + 2 * kStages]);

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBQ;
  const int tiles = (n + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const int groups = q0 + 64 < n ? 2 : 1;  // consumer warpgroups with a row

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * groups);  // every working consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer ------------------------------------------------
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, groups * 64 * D * 2);
      for (int w = 0; w < groups; ++w)
        for (int c = 0; c < C::kCount; ++c)
          tma_load_4d(base + w * L::kQ + (c ? C::bytes(0, 64) : 0), &maps.q[c],
                      q_full, C::col(c), h, q0 + 64 * w, b);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t kt = base + L::kK + s * L::kKV;
        const uint32_t vt = base + L::kV + s * L::kKV;
        mbar_expect_tx(k_full + 8 * s, kBK * D * 2);
        for (int c = 0; c < C::kCount; ++c)
          for (int r = 0; r < kBK / 64; ++r)
            tma_load_4d(kt + (c ? C::bytes(0, kBK) : 0) + r * 128 * C::width(c),
                        &maps.k[c], k_full + 8 * s, C::col(c), h,
                        it * kBK + 64 * r, b);
        mbar_expect_tx(v_full + 8 * s, kBK * D * 2);
        for (int c = 0; c < C::kCount; ++c)
          for (int r = 0; r < kBK / 64; ++r)
            tma_load_4d(vt + (c ? C::bytes(0, kBK) : 0) + r * 128 * C::width(c),
                        &maps.v[c], v_full + 8 * s, C::col(c), h,
                        it * kBK + 64 * r, b);
      }
    }
  } else if (wg < groups) {  // ---- consumers: 64 query rows each ---------------
    regs_inc<240>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
    const uint32_t qa = base + wg * L::kQ;

    constexpr int kW0 = C::kW0, kW1 = C::kW1;
    float o0[kW0 / 2], o1[kW1 ? kW1 / 2 : 1];
#pragma unroll
    for (int i = 0; i < kW0 / 2; ++i) o0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kW1 ? kW1 / 2 : 1); ++i) o1[i] = 0.f;
    fence_regs(o0);  // zeroed before the first wgmma is issued
    fence_regs(o1);
    // Running row maxima of the scores in log2 units (whole rows, equal in
    // the four threads of a row group; the exact softmax only) and this
    // thread's share of the row sums of p, for rows g and g + 8 of the
    // warp's 16.
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

    // S = Q.K^T of one 128-key tile: 64 rows x 128 keys, fp32, in D / 16
    // k-steps, issued and committed as one group.
    auto issue_scores = [&](float (&sc)[kBK / 2], uint32_t kt) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk < kW0 / 16 ? 0 : 1, kc = c ? kk - kW0 / 16 : kk;
        const uint64_t da =
            kmajor_desc(qa + (c ? C::bytes(0, 64) : 0), C::width(c), kc);
        const uint64_t db =
            kmajor_desc(kt + (c ? C::bytes(0, kBK) : 0), C::width(c), kc);
        if (kk == 0)
          wgmma_ss_n128_init(sc, da, db);
        else
          wgmma_ss_n128(sc, da, db);
      }
      wgmma_commit();
    };
    // O += bf16(p).V: 8 k-steps of 16 keys, V through the transpose bit.
    auto issue_values = [&](const uint32_t (&pf)[kBK / 16][4], uint32_t vt) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_rs<kW0>(o0, pf[kk], mnmajor_desc(vt, kW0, kk));
        if constexpr (kW1 != 0)
          wgmma_rs<16>(o1, pf[kk], mnmajor_desc(vt + C::bytes(0, kBK), 16, kk));
      }
      wgmma_commit();
    };
    // The softmax step of a score tile whose keys start at k0: keys past N
    // count as -inf (only the last tile has any; every tile holds at least
    // one key, so the exact softmax's maxima stay finite).  It overwrites
    // the scores with p in fp32 and adds them to the running sums.  The
    // exact softmax first moves the running maxima and rescales the sums,
    // and returns the factors exp(m_old - m_new) by which O must still be
    // rescaled; the max-free one returns ones.
    auto softmax_tile = [&](float (&sc)[kBK / 2], int k0, auto ragged) {
      const int lim = n - k0 - 2 * t;  // keys 8 j + (e & 1) < lim are in
      auto in = [&](int j, int e) {
        if constexpr (decltype(ragged)::value)
          return 8 * j + (e & 1) < lim;
        else
          return true;
      };
      if constexpr (kMaxFree) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                in(j, e) ? ex2(fminf(sc[4 * j + e] * kLog2e, kClampLog2)) : 0.f;
            if (e & 2) l1 += p; else l0 += p;
            sc[4 * j + e] = p;
          }
        }
        return make_float2(1.f, 1.f);
      } else {
        auto score = [&](int j, int e) {
          return in(j, e) ? sc[4 * j + e] : -CUDART_INF_F;
        };
        float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(score(j, 0), score(j, 1)));
          mx1 = fmaxf(mx1, fmaxf(score(j, 2), score(j, 3)));
        }
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, m));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, m));
        }
        // maxima in log2 units (the scale is positive, so it commutes with
        // the maximum); exp2(-inf) = 0 at the first tile
        const float mn0 = fmaxf(m0, mx0 * scale_log2);
        const float mn1 = fmaxf(m1, mx1 * scale_log2);
        const float2 corr = make_float2(ex2(m0 - mn0), ex2(m1 - mn1));
        m0 = mn0;
        m1 = mn1;
        l0 *= corr.x;
        l1 *= corr.y;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float e0 = ex2(fmaf(score(j, 0), scale_log2, -m0));
          const float e1 = ex2(fmaf(score(j, 1), scale_log2, -m0));
          const float e2 = ex2(fmaf(score(j, 2), scale_log2, -m1));
          const float e3 = ex2(fmaf(score(j, 3), scale_log2, -m1));
          l0 += e0 + e1;
          l1 += e2 + e3;
          sc[4 * j] = e0;
          sc[4 * j + 1] = e1;
          sc[4 * j + 2] = e2;
          sc[4 * j + 3] = e3;
        }
        return corr;
      }
    };
    auto softmax = [&](float (&sc)[kBK / 2], int k0) {
      return k0 + kBK > n ? softmax_tile(sc, k0, std::true_type())
                          : softmax_tile(sc, k0, std::false_type());
    };
    // p as bf16 pairs: two neighbouring 8-key column blocks of the
    // accumulator are one 16-key k-step of wgmma's A operand.
    auto pack = [&](const float (&sc)[kBK / 2], uint32_t (&pf)[kBK / 16][4]) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        pf[j >> 1][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };
    auto rescale = [&](float2 corr) {
#pragma unroll
      for (int j = 0; j < kW0 / 8; ++j) {
        o0[4 * j] *= corr.x;
        o0[4 * j + 1] *= corr.x;
        o0[4 * j + 2] *= corr.y;
        o0[4 * j + 3] *= corr.y;
      }
      if constexpr (kW1 != 0) {
#pragma unroll
        for (int j = 0; j < kW1 / 8; ++j) {
          o1[4 * j] *= corr.x;
          o1[4 * j + 1] *= corr.x;
          o1[4 * j + 2] *= corr.y;
          o1[4 * j + 3] *= corr.y;
        }
      }
    };
    // Software pipeline inside the warpgroup: the scores of tile i + 1 and
    // the value product of tile i are in flight on the tensor cores while
    // the softmax of tile i + 1 runs.
    float sc[kBK / 2];
    uint32_t pf[kBK / 16][4];
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    issue_scores(sc, base + L::kK);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, 0);  // O is still zero: nothing to rescale
    pack(sc, pf);
    for (int it = 1; it < tiles; ++it) {
      const int s = it % kStages, sp = (it - 1) % kStages;
      mbar_wait(k_full + 8 * s, (it / kStages) & 1);
      issue_scores(sc, base + L::kK + s * L::kKV);
      mbar_wait(v_full + 8 * sp, ((it - 1) / kStages) & 1);
      issue_values(pf, base + L::kV + sp * L::kKV);
      wgmma_wait<1>();
      fence_regs(sc);
      const float2 corr = softmax(sc, it * kBK);
      wgmma_wait<0>();
      fence_regs(o0);
      fence_regs(o1);
      mbar_arrive(empty + 8 * sp);
      if constexpr (!kMaxFree) rescale(corr);
      pack(sc, pf);
    }
    const int sl = (tiles - 1) % kStages;
    mbar_wait(v_full + 8 * sl, ((tiles - 1) / kStages) & 1);
    issue_values(pf, base + L::kV + sl * L::kKV);
    wgmma_wait<0>();
    fence_regs(o0);
    fence_regs(o1);
    mbar_arrive(empty + 8 * sl);

    // Full row sums: the four threads of a row group hold disjoint columns
    // (in the exact softmax all relative to the same maximum).
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    if constexpr (!kMaxFree) {
      if (t == 0) {
        float* lb = lse + static_cast<int64_t>(bh) * n;
        if (r0 < n) lb[r0] = m0 * kLn2 + logf(l0);
        if (r1 < n) lb[r1] = m1 * kLn2 + logf(l1);
      }
    }
    const int64_t row_stride = static_cast<int64_t>(heads) * D;
    __nv_bfloat16* ob = out + static_cast<int64_t>(b) * n * row_stride + h * D;
#pragma unroll
    for (int j = 0; j < kW0 / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + c) =
            pack_bf16(o0[4 * j] / l0, o0[4 * j + 1] / l0);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(ob + r1 * row_stride + c) =
            pack_bf16(o0[4 * j + 2] / l1, o0[4 * j + 3] / l1);
    }
    if constexpr (kW1 != 0) {
#pragma unroll
      for (int j = 0; j < kW1 / 8; ++j) {
        const int c = kW0 + 8 * j + 2 * t;
        if (r0 < n)
          *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + c) =
              pack_bf16(o1[4 * j] / l0, o1[4 * j + 1] / l0);
        if (r1 < n)
          *reinterpret_cast<uint32_t*>(ob + r1 * row_stride + c) =
              pack_bf16(o1[4 * j + 2] / l1, o1[4 * j + 3] / l1);
      }
    }
  }
}

// Encode the maps and launch on `stream`.  q, k, v: (B, N, H, D) bf16 with
// element strides st[3 i .. 3 i + 2] = (s_b, s_n, s_h) for i = q, k, v;
// lse and scale_log2 are the exact softmax's (the max-free one ignores
// them).  Returns cudaGetLastError(), or cudaErrorInvalidValue if the
// driver refuses a tensor map.
template <int D, bool kMaxFree>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int batch, int n, int heads, float scale_log2, const int64_t* st,
           cudaStream_t stream) {
  using C = Chunks<D>;
  Maps maps = {};
  const void* ptr[3] = {q, k, v};
  CUtensorMap* dst[3] = {maps.q, maps.k, maps.v};
  for (int i = 0; i < 3; ++i)
    for (int c = 0; c < C::kCount; ++c)
      if (!encode_operand(&dst[i][c], ptr[i], batch, n, heads, D, st[3 * i],
                          st[3 * i + 1], st[3 * i + 2], C::width(c), 64))
        return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = Layout<D>::kBytes > kOneBlockPerSm ? Layout<D>::kBytes
                                                       : kOneBlockPerSm;
  static uint32_t configured = 0;  // a bit per device
  smem_bytes_once(configured, attn_fwd_kernel<D, kMaxFree>, bytes);
  const dim3 grid((n + kBQ - 1) / kBQ, batch * heads);
  attn_fwd_kernel<D, kMaxFree><<<grid, kThreads, bytes, stream>>>(
      maps, static_cast<__nv_bfloat16*>(out), lse, n, heads, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_fwd
