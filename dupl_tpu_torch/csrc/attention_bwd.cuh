// The attention backward kernels for Hopper (sm_90a) shared by L1b
// (flash_attention_bwd.cu: exact softmax, p from the forward's log-sum-exp)
// and K2 (exp_attention_bwd.cu: max-free, scores clamped at 60, p from the
// row sum of e that this backward takes itself).  Each source's own note
// says which TPU kernel it replaces, its numerics and its bound; this header
// holds the design they share.
//
// Two kernels, each warp-specialised: one producer warp issues TMA copies
// into a ring of kStages stages with "full" and "empty" mbarriers, and two
// consumer warpgroups of 64 rows each run every product on wgmma (scores
// from shared memory, K-major; the updates with the bf16 ds / p from
// registers in wgmma's register-A layout, which is the accumulator layout
// of the score tile packed to bf16 pairs, and the other operand read
// through the descriptor's transpose bit, so nothing is transposed in
// shared memory).  A warpgroup whose 64 rows all lie past N exits at once,
// and the empty barriers count only the warpgroups that work.
//   * kernel 1, one block per 128 query rows (q and g rows of the block
//     copied once), finds its rows' two statistics, writes them to a padded
//     (B*H, Npad) scratch (Npad = N rounded up to 64), and sweeps the 64-key
//     tiles of K and V: S = Q.K^T, T = G.V^T, ds, dQ += dS.K.  The exact
//     softmax's statistics are lse * log2(e) (+inf past N) and delta =
//     rowsum(out * g), both from its own rows; the max-free ones are 1 /
//     sum_j e (0 past N) and delta = sum_j e*t / sum_j e, which a first
//     sweep over the same K/V ring accumulates in fp32 (S and T again, no
//     update): being max-free they are final after one sweep.
//   * kernel 2, one block per 128 keys (k and v rows copied once), sweeps
//     the 64-query tiles of q and g together with their 64 entries of the
//     two scratch rows (bulk copies), forms the transposed tiles S^T = K.Q^T
//     and T^T = V.G^T directly (so ds^T and p^T come out as A operands), and
//     accumulates dK += dS^T.Q and dV += P^T.G.  A query past N reads a
//     statistic that zeroes its column of p and ds exactly (lse = +inf, or
//     1 / sum e = 0).
// Kernel 1 overlaps the dq update of tile i with the scores of tile i + 1
// (the last tile is peeled, so that every scores issue is unconditional: a
// branch around it made the compiler copy the score registers while their
// wgmma was in flight).  Kernel 2 holds two accumulators, and overlapping
// there left too few registers: ptxas serialised its wgmmas.  It waits for
// its updates before the next scores, and the other warpgroup fills the
// tensor cores meanwhile.  At D 80 even that does not fit in the 168
// registers a thread of a 384-thread block has (80 of them accumulators), so
// kernel 2 runs twice there, once for dv and once for dk, each recomputing
// S^T.  kernels/build.py fails a build in which ptxas reports serialised
// wgmmas.
// Every output element is owned by one thread: no atomics, and the result is
// the same from run to run.  Keys past N get ds = 0 in kernel 1 (and e = 0
// in the max-free statistics); operand rows past N arrive zero-filled by
// TMA; nothing is padded in device memory but the wrapper's scratch.
//
// Operands.  q, k, v, g (and the exact softmax's out) are (B, N, H, D) with
// arbitrary strides for B, N and H (multiples of 8 elements, 16-byte
// aligned base); k and v are column slices of the qkv projection.  TMA
// tensor maps and column chunks as in the forward (hopper.cuh).  lse is
// (B, H, N) fp32.  dq, dk, dv are (B, N, H, D) contiguous.  D is a template
// parameter: 16, 32, 64 or 80.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn_bwd {

using namespace hopper;

constexpr int kBM = 128;        // rows owned by a block: 2 warpgroups x 64
constexpr int kBT = 64;         // rows of a streamed tile
constexpr int kStages = 3;
constexpr int kThreads = 384;   // 2 consumer warpgroups + 1 producer
// Shared memory asked for at the least: two blocks never share an SM, so
// the consumers' setmaxnreg.inc always finds the producer's registers.
constexpr int kOneBlockPerSm = 116 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClamp = 60.0f;                // the max-free clamp
constexpr float kClampLog2 = 60.0f * kLog2e;

struct Maps {
  CUtensorMap q[2], k[2], v[2], g[2];  // per column chunk
};

template <int D>
struct Layout {
  using C = Chunks<D>;
  static constexpr int kRows = C::tile_bytes(64);   // 64 rows of one operand
  // owned: [operand a][warpgroup], [operand b][warpgroup]
  static constexpr int kOwn = 4 * kRows;
  // a stage: two streamed tiles and, in kernel 2, 64 entries each of the
  // two scratch rows
  static constexpr int kStage = 2 * kRows + 1024;
  static constexpr int kBytes = kOwn + kStages * kStage + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Sum of the products of two packed bf16 pairs, in fp32.
__device__ __forceinline__ float dot2(uint32_t a, uint32_t b) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return x.x * y.x + x.y * y.y;
}

// The max-free e = exp(min(s, 60)) of a score.
__device__ __forceinline__ float exp_clamped(float s) {
  return ex2(fminf(s * kLog2e, kClampLog2));
}

// acc (64 x 64 fp32) = A rows (64 x D) . B tile (64 x D)^T, both K-major
// operand tiles in shared memory.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t a, uint32_t b) {
  using C = Chunks<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk < C::kW0 / 16 ? 0 : 1, kc = c ? kk - C::kW0 / 16 : kk;
    const uint32_t off = c ? C::bytes(0, 64) : 0;
    wgmma_ss_n64(acc, kmajor_desc(a + off, C::width(c), kc),
                 kmajor_desc(b + off, C::width(c), kc), kk > 0);
  }
}

// acc (64 x D, as chunks acc0 | acc1) += a (64 x 64 bf16, registers, four
// 16-column k-steps) . tile (64 x D), the tile read through the transpose bit.
template <int D>
__device__ __forceinline__ void update(float (&acc0)[Chunks<D>::kW0 / 2],
                                       float (&acc1)[Chunks<D>::kW1 ? 8 : 1],
                                       const uint32_t (&a)[4][4], uint32_t tile) {
  using C = Chunks<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<C::kW0>(acc0, a[kk], mnmajor_desc(tile, C::kW0, kk));
    if constexpr (C::kW1 != 0)
      wgmma_rs<16>(acc1, a[kk], mnmajor_desc(tile + C::bytes(0, 64), 16, kk));
  }
}

// rows r0, r1 of out = bf16(mult * acc), acc as chunks acc0 | acc1 in the
// accumulator layout.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t row_stride,
                                           const float (&acc0)[Chunks<D>::kW0 / 2],
                                           const float (&acc1)[Chunks<D>::kW1 ? 8 : 1],
                                           float mult, int r0, int r1, int n, int t) {
  using C = Chunks<D>;
#pragma unroll
  for (int j = 0; j < C::kW0 / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + r0 * row_stride + c) =
          pack_bf16(mult * acc0[4 * j], mult * acc0[4 * j + 1]);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(out + r1 * row_stride + c) =
          pack_bf16(mult * acc0[4 * j + 2], mult * acc0[4 * j + 3]);
  }
  if constexpr (C::kW1 != 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = C::kW0 + 8 * j + 2 * t;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(out + r0 * row_stride + c) =
            pack_bf16(mult * acc1[4 * j], mult * acc1[4 * j + 1]);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(out + r1 * row_stride + c) =
            pack_bf16(mult * acc1[4 * j + 2], mult * acc1[4 * j + 3]);
    }
  }
}

// One 64-row operand tile of a head by TMA, every column chunk.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* maps,
                                          uint32_t bar, int h, int row, int b) {
  using C = Chunks<D>;
  for (int c = 0; c < C::kCount; ++c)
    tma_load_4d(dst + (c ? C::bytes(0, 64) : 0), &maps[c], bar, C::col(c), h, row,
                b);
}

__device__ __forceinline__ void init_bars(uint32_t own, uint32_t full,
                                          uint32_t empty, int groups) {
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * groups);  // every working consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Kernel 1: the row statistics and dq, one block per 128 query rows.  The
// exact softmax reads out (o) and lse; the max-free one ignores them.
template <int D, bool kMaxFree>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ Maps maps, const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ go, const float* __restrict__ lse,
          __nv_bfloat16* __restrict__ dq, float* __restrict__ stat_pad,
          float* __restrict__ delta_pad, int n, int npad, int heads,
          float scale, float scale_log2, int64_t osb, int64_t osn, int64_t osh,
          int64_t gsb, int64_t gsn, int64_t gsh) {
  using C = Chunks<D>;
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t own = smem_u32(&bars[0]);
  const uint32_t full = smem_u32(&bars[1]);               // + 8 * stage
  const uint32_t empty = smem_u32(&bars[1 + kStages]);
  const int q0 = blockIdx.x * kBM;
  const int groups = q0 + 64 < n ? 2 : 1;
  init_bars(own, full, empty, groups);

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int tiles = (n + kBT - 1) / kBT;
  // the max-free statistics take a first sweep over the same ring
  const int sweeps = kMaxFree ? 2 : 1;
  const int wg = threadIdx.x / 128;
  // owned q rows at [0, 2 kRows), g rows at [2 kRows, 4 kRows); a stage
  // holds a K tile, then a V tile
  if (wg == 2) {  // ---- producer ------------------------------------------------
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(own, groups * 2 * 64 * D * 2);
      for (int w = 0; w < groups; ++w) {
        load_rows<D>(base + w * L::kRows, maps.q, own, h, q0 + 64 * w, b);
        load_rows<D>(base + (2 + w) * L::kRows, maps.g, own, h, q0 + 64 * w, b);
      }
      for (int it = 0; it < sweeps * tiles; ++it) {
        const int s = it % kStages, row = (it % tiles) * kBT;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t st = base + L::kOwn + s * L::kStage;
        mbar_expect_tx(full + 8 * s, 2 * 64 * D * 2);
        load_rows<D>(st, maps.k, full + 8 * s, h, row, b);
        load_rows<D>(st + L::kRows, maps.v, full + 8 * s, h, row, b);
      }
    }
  } else if (wg < groups) {  // ---- consumers: 64 query rows each ---------------
    regs_inc<240>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const uint32_t qa = base + wg * L::kRows, ga = base + (2 + wg) * L::kRows;
    auto stage = [&](int it) { return base + L::kOwn + (it % kStages) * L::kStage; };
    float sc[32], tc[32];

    // The statistics of rows r0 and r1: st (lse in log2 units, or 1 / sum
    // e) and delta.  The four threads of a row group hold disjoint columns.
    float st0, st1, del0 = 0.f, del1 = 0.f;
    if constexpr (kMaxFree) {
      // sweep 1: l = sum_j e and u = sum_j e*t over the keys below N
      mbar_wait(own, 0);
      float l0 = 0.f, l1 = 0.f;
      for (int it = 0; it < tiles; ++it) {
        mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
        wgmma_fence();
        scores<D>(sc, qa, stage(it));               // S = Q.K^T
        scores<D>(tc, ga, stage(it) + L::kRows);    // T = G.V^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(tc);
        mbar_arrive(empty + 8 * (it % kStages));
        const int lim = n - it * kBT - 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x =
                8 * j + (e & 1) < lim ? exp_clamped(sc[4 * j + e]) : 0.f;
            if (e & 2) {
              l1 += x;
              del1 += x * tc[4 * j + e];
            } else {
              l0 += x;
              del0 += x * tc[4 * j + e];
            }
          }
        }
      }
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, m);
        l1 += __shfl_xor_sync(0xffffffffu, l1, m);
        del0 += __shfl_xor_sync(0xffffffffu, del0, m);
        del1 += __shfl_xor_sync(0xffffffffu, del1, m);
      }
      // 1 / sum e, 0 past N, where every p is then exactly 0
      st0 = r0 < n ? 1.f / l0 : 0.f;
      st1 = r1 < n ? 1.f / l1 : 0.f;
      del0 *= st0;
      del1 *= st1;
    } else {
      // delta = rowsum(out * g) of rows r0 and r1
      const __nv_bfloat16* ob = o + b * osb + h * osh;
      const __nv_bfloat16* gb = go + b * gsb + h * gsh;
#pragma unroll
      for (int c = 2 * t; c < D; c += 8) {
        if (r0 < n) del0 += dot2(ld32(ob + r0 * osn + c), ld32(gb + r0 * gsn + c));
        if (r1 < n) del1 += dot2(ld32(ob + r1 * osn + c), ld32(gb + r1 * gsn + c));
      }
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        del0 += __shfl_xor_sync(0xffffffffu, del0, m);
        del1 += __shfl_xor_sync(0xffffffffu, del1, m);
      }
      // lse in log2 units; +inf past N, where every p is then exactly 0
      const int64_t stat = static_cast<int64_t>(bh) * n;
      st0 = r0 < n ? lse[stat + r0] * kLog2e : CUDART_INF_F;
      st1 = r1 < n ? lse[stat + r1] * kLog2e : CUDART_INF_F;
    }
    if (r0 >= n) del0 = 0.f;
    if (r1 >= n) del1 = 0.f;
    if (t == 0) {
      const int64_t pad = static_cast<int64_t>(bh) * npad;
      if (r0 < npad) {
        stat_pad[pad + r0] = st0;
        delta_pad[pad + r0] = del0;
      }
      if (r1 < npad) {
        stat_pad[pad + r1] = st1;
        delta_pad[pad + r1] = del1;
      }
    }

    // dQ += dS.K over the key tiles, at ring iterations it0 + i.
    if constexpr (!kMaxFree) mbar_wait(own, 0);
    const int it0 = kMaxFree ? tiles : 0;
    float acc0[C::kW0 / 2], acc1[C::kW1 ? 8 : 1];
#pragma unroll
    for (int i = 0; i < C::kW0 / 2; ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (C::kW1 ? 8 : 1); ++i) acc1[i] = 0.f;
    fence_regs(acc0);  // zeroed before the first wgmma is issued
    fence_regs(acc1);
    // The update of tile i and the scores of tile i + 1 go to the tensor
    // cores back to back, and one wait covers both.
    auto issue_scores = [&](int i) {
      const int it = it0 + i;
      mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
      wgmma_fence();
      scores<D>(sc, qa, stage(it));               // S = Q.K^T
      scores<D>(tc, ga, stage(it) + L::kRows);    // T = G.V^T
      wgmma_commit();
    };
    auto consume = [&](int i) {
      const int it = it0 + i;
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(tc);
      fence_regs(acc0);
      fence_regs(acc1);
      if (i > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
      // ds = p (t - delta), 0 for a key past N (and, max-free, where the
      // score reached the clamp); packed as four 16-key k-steps of the A
      // operand.
      uint32_t df[4][4];
      const int k0 = i * kBT;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s_ = sc[4 * j + e];
          bool in = k0 + 8 * j + 2 * t + (e & 1) < n;
          const float st = (e & 2) ? st1 : st0, del = (e & 2) ? del1 : del0;
          float p;
          if constexpr (kMaxFree) {
            p = exp_clamped(s_) * st;
            in = in && s_ < kClamp;
          } else {
            p = ex2(fmaf(s_, scale_log2, -st));
          }
          d[e] = in ? p * (tc[4 * j + e] - del) : 0.f;
        }
        df[j >> 1][(j & 1) * 2] = pack_bf16(d[0], d[1]);      // row g
        df[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d[2], d[3]);  // row g + 8
      }
      wgmma_fence();
      update<D>(acc0, acc1, df, stage(it));       // dQ += dS.K
      wgmma_commit();
    };
    issue_scores(0);
    for (int i = 0; i + 1 < tiles; ++i) {
      consume(i);
      issue_scores(i + 1);
    }
    consume(tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    mbar_arrive(empty + 8 * ((it0 + tiles - 1) % kStages));
    const int64_t row_stride = static_cast<int64_t>(heads) * D;
    store_rows<D>(dq + static_cast<int64_t>(b) * n * row_stride + h * D,
                  row_stride, acc0, acc1, scale, r0, r1, n, t);
  }
}

// Kernel 2: dk and dv, one block per 128 keys; kPart 1 computes dv only, 2
// dk only, 3 both.
template <int D, int kPart, bool kMaxFree>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ Maps maps, const float* __restrict__ stat_pad,
           const float* __restrict__ delta_pad, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int n, int npad, int heads,
           float scale, float scale_log2) {
  using C = Chunks<D>;
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t own = smem_u32(&bars[0]);
  const uint32_t full = smem_u32(&bars[1]);
  const uint32_t empty = smem_u32(&bars[1 + kStages]);
  const int k0 = blockIdx.x * kBM;
  const int groups = k0 + 64 < n ? 2 : 1;
  init_bars(own, full, empty, groups);

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int tiles = npad / kBT;
  const int wg = threadIdx.x / 128;
  // owned k rows at [0, 2 kRows), v rows at [2 kRows, 4 kRows); a stage
  // holds a q tile, a g tile, 64 statistic and 64 delta entries
  if (wg == 2) {  // ---- producer ------------------------------------------------
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(own, groups * 2 * 64 * D * 2);
      for (int w = 0; w < groups; ++w) {
        load_rows<D>(base + w * L::kRows, maps.k, own, h, k0 + 64 * w, b);
        load_rows<D>(base + (2 + w) * L::kRows, maps.v, own, h, k0 + 64 * w, b);
      }
      const int64_t pad = static_cast<int64_t>(bh) * npad;
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const uint32_t st = base + L::kOwn + s * L::kStage;
        mbar_expect_tx(full + 8 * s, 2 * 64 * D * 2 + 2 * kBT * 4);
        load_rows<D>(st, maps.q, full + 8 * s, h, it * kBT, b);
        load_rows<D>(st + L::kRows, maps.g, full + 8 * s, h, it * kBT, b);
        bulk_load(st + 2 * L::kRows, stat_pad + pad + it * kBT, kBT * 4,
                  full + 8 * s);
        bulk_load(st + 2 * L::kRows + kBT * 4, delta_pad + pad + it * kBT,
                  kBT * 4, full + 8 * s);
      }
    }
  } else if (wg < groups) {  // ---- consumers: 64 keys each ---------------------
    regs_inc<240>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = k0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;  // this thread's keys
    constexpr bool kDv = kPart & 1, kDk = kPart & 2;

    float dk0[C::kW0 / 2], dk1[C::kW1 ? 8 : 1];
    float dv0[C::kW0 / 2], dv1[C::kW1 ? 8 : 1];
#pragma unroll
    for (int i = 0; i < C::kW0 / 2; ++i) dk0[i] = dv0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (C::kW1 ? 8 : 1); ++i) dk1[i] = dv1[i] = 0.f;
    // only the accumulators of this kPart stay: a fence would keep the
    // other pair's registers alive
    auto fence_acc = [&] {
      if constexpr (kDk) {
        fence_regs(dk0);
        fence_regs(dk1);
      }
      if constexpr (kDv) {
        fence_regs(dv0);
        fence_regs(dv1);
      }
    };
    fence_acc();  // zeroed before the first wgmma is issued
    const uint32_t ka = base + wg * L::kRows, va = base + (2 + wg) * L::kRows;
    float sc[32], tc[32];
    auto stage = [&](int it) { return base + L::kOwn + (it % kStages) * L::kStage; };
    auto issue_scores = [&](int it) {
      mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
      wgmma_fence();
      scores<D>(sc, ka, stage(it));               // S^T = K.Q^T
      if constexpr (kDk) scores<D>(tc, va, stage(it) + L::kRows);  // T^T = V.G^T
      wgmma_commit();
    };
    mbar_wait(own, 0);
    for (int it = 0; it < tiles; ++it) {
      issue_scores(it);
      wgmma_wait<0>();
      fence_regs(sc);
      if constexpr (kDk) fence_regs(tc);
      // p^T and ds^T; a column is a query, with its statistic (lse = +inf,
      // or 1 / sum e = 0, past N) and delta from the stage.
      const float* ls = reinterpret_cast<const float*>(
          smem_raw + (stage(it) - smem_u32(smem_raw)) + 2 * L::kRows);
      const float* dl = ls + kBT;
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lc = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
        const float2 dc = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l_ = (e & 1) ? lc.y : lc.x, d_ = (e & 1) ? dc.y : dc.x;
          const float s_ = sc[4 * j + e];
          if constexpr (kMaxFree)
            p[e] = exp_clamped(s_) * l_;
          else
            p[e] = ex2(fmaf(s_, scale_log2, -l_));
          if constexpr (kDk) {
            d[e] = p[e] * (tc[4 * j + e] - d_);
            if constexpr (kMaxFree) d[e] = s_ < kClamp ? d[e] : 0.f;
          }
        }
        if constexpr (kDv) {
          pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
          pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        }
        if constexpr (kDk) {
          df[j >> 1][(j & 1) * 2] = pack_bf16(d[0], d[1]);
          df[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
        }
      }
      wgmma_fence();
      if constexpr (kDv) update<D>(dv0, dv1, pf, stage(it) + L::kRows);  // dV += P^T.G
      if constexpr (kDk) update<D>(dk0, dk1, df, stage(it));  // dK += dS^T.Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc();
      mbar_arrive(empty + 8 * (it % kStages));
    }
    const int64_t row_stride = static_cast<int64_t>(heads) * D;
    const int64_t off = static_cast<int64_t>(b) * n * row_stride + h * D;
    if constexpr (kDk) store_rows<D>(dk + off, row_stride, dk0, dk1, scale, r0, r1, n, t);
    if constexpr (kDv) store_rows<D>(dv + off, row_stride, dv0, dv1, 1.f, r0, r1, n, t);
  }
}

// Encode the maps and launch both kernels on `stream`.  q, k, v, g: (B, N,
// H, D) bf16 with element strides sq, sk, sv, sg (each (s_b, s_n, s_h));
// o with so and lse: the exact softmax's forward out and log-sum-exp
// (ignored, and may be null, in the max-free mode).  stat_pad, delta_pad:
// (B*H, Npad) fp32 scratch each, Npad = padded(N).  Results are multiplied
// by `scale` (dq, dk) before rounding.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue if the driver refuses a tensor map.
inline int padded(int n) { return (n + kBT - 1) / kBT * kBT; }

template <int D, bool kMaxFree>
int launch(const void* q, const int64_t* sq, const void* k, const int64_t* sk,
           const void* v, const int64_t* sv, const void* go, const int64_t* sg,
           const void* o, const int64_t* so, const float* lse, void* dq, void* dk,
           void* dv, float* stat_pad, float* delta_pad, int batch, int n,
           int heads, float scale, float scale_log2, cudaStream_t stream) {
  using C = Chunks<D>;
  Maps maps = {};
  const void* ptr[4] = {q, k, v, go};
  const int64_t* str[4] = {sq, sk, sv, sg};
  CUtensorMap* dst[4] = {maps.q, maps.k, maps.v, maps.g};
  for (int i = 0; i < 4; ++i)
    for (int c = 0; c < C::kCount; ++c)
      if (!encode_operand(&dst[i][c], ptr[i], batch, n, heads, D, str[i][0],
                          str[i][1], str[i][2], C::width(c), 64))
        return static_cast<int>(cudaErrorInvalidValue);
  const int npad = padded(n);
  const int bytes = Layout<D>::kBytes > kOneBlockPerSm ? Layout<D>::kBytes
                                                       : kOneBlockPerSm;
  const dim3 grid((n + kBM - 1) / kBM, batch * heads);
  static uint32_t configured_dq = 0;  // a bit per device, each kernel
  smem_bytes_once(configured_dq, dq_kernel<D, kMaxFree>, bytes);
  dq_kernel<D, kMaxFree><<<grid, kThreads, bytes, stream>>>(
      maps, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(go), lse,
      static_cast<__nv_bfloat16*>(dq), stat_pad, delta_pad, n, npad, heads,
      scale, scale_log2, so ? so[0] : 0, so ? so[1] : 0, so ? so[2] : 0, sg[0],
      sg[1], sg[2]);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dkv = [&](auto kernel, uint32_t& configured) {
    smem_bytes_once(configured, kernel, bytes);
    kernel<<<grid, kThreads, bytes, stream>>>(
        maps, stat_pad, delta_pad, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), n, npad, heads, scale, scale_log2);
    return cudaGetLastError();
  };
  if constexpr (C::kW1 != 0) {  // D 80: dv, then dk
    static uint32_t configured_dv = 0, configured_dk = 0;
    const cudaError_t e = dkv(dkv_kernel<D, 1, kMaxFree>, configured_dv);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(dkv(dkv_kernel<D, 2, kMaxFree>, configured_dk));
  } else {
    static uint32_t configured_dkv = 0;
    return static_cast<int>(dkv(dkv_kernel<D, 3, kMaxFree>, configured_dkv));
  }
}

}  // namespace attn_bwd
