// Kernel Q2: the w8a8 product of the int8 inference path for Hopper
// (sm_90a):
//     C[m, n] = (f32(sum_k A[m, k] B[n, k]) * sa[m]) * sw[n]
//     or, with a bias, fma(f32(sum_k ...) * sa[m], sw[n], bias[n])
// A (M, K) int8 row-major (the quantized activations), B (N, K) int8
// row-major (the quantized nn.Linear weight), sa (M, 1), sw (N, 1) and bias
// (N,) fp32 -> C (M, N) fp32.  The int32 sum is exact, so C is bit for bit
// int8_linear_ref (dupl_tpu_torch/ops/quant.py) in any order of k; the
// rescale is two fp32 products in the JAX package's order (y * s_a * s_w,
// dupl_tpu/ops/quant.py), and QDense's bias add is fused with the second
// product, as XLA's CPU code contracts them under jit (__fmul_rn for the
// products that round on their own, __fmaf_rn for the one that does not).
//
// Replaces no Pallas kernel: the JAX package's int8 dot_general goes to
// XLA.  Bound: 2 M N K int8 operations on the tensor cores (1,979 TOP/s
// dense on the H100 SXM) against the bytes, A and B read once and C written
// once in fp32.  At ViT-B's fc1 shape (M 12,560, N 3072, K 768) that is
// 5.93e10 operations (0.030 ms) and 166 MB (0.050 ms): the fp32 output
// binds, as it does at qkv and proj; fc2 (K 3072) is bound by its
// operations.
//
// Design, on the machinery of the attention kernels (hopper.cuh): a
// persistent grid of CTA pairs (thread block clusters of two, one CTA an
// SM) walks the 128 x 128 output tiles, the pair on two vertically adjacent
// tiles at a time (the pairs at work share A's row tiles and all of B in
// L2).  Each CTA is warp-specialised:
//   * one producer thread (of a third warpgroup) streams 128-column K slices
//     of the tiles by TMA (2-D tensor maps, the 128-byte swizzle) into a
//     ring of kStages stages: A's 128 rows on its own, and half of B's
//     tile, which the pair shares, multicast into both CTAs.  Each stage
//     has a "full" mbarrier and an "empty" one that the consuming
//     warpgroups of both CTAs release (a remote arrival for the peer), so
//     neither producer refills a stage that either CTA still reads.  It runs
//     ahead across tiles;
//   * two consumer warpgroups take the CTA's tiles in turn (ping-pong), each
//     a whole 128 x 128 tile: wgmma m64n128k32 .s32.s8.s8 on its two 64-row
//     halves, both operands K-major from shared memory as they stand in
//     device memory, one slice's products in flight while the next is
//     issued.  Named barriers pass the turn when a warpgroup has issued its
//     tile's last products, so one warpgroup's products run while the other
//     writes its tile out;
//   * the epilogue rescales in registers in the twin's order and writes
//     each 64-row half into shared memory in the 128-byte swizzle (each row
//     of eight threads' float2 stores lands on all 32 banks), then one
//     thread sends it to C by four TMA stores of 64 x 32, which clip at M
//     and N; a half waits only until the previous stores have read shared
//     memory.
// On the card (PERF.md) the operand stream into each SM, not the tensor
// cores, sets the pace of the main loop; the pairs' multicast of B and the
// ping-pong each took some 5-10% off fc1 beside one 128 x 128 tile for
// both warpgroups.
// M and N may be ragged and K may end inside a slice: TMA fills what lies
// past the operands with zeros, which add nothing to the sums, and a pair's
// second tile past M computes zeros and stores nothing.  K is a multiple of
// 32 and N of 8 (16-byte rows for the tensor maps).
//
// Two more entries split the product where its sum spans several
// processes (a row-parallel product under tensor parallelism, whose K is
// sharded): dupl_int8_gemm_i32 is the same kernel with the int32
// accumulators stored as they stand (C (M, N) int32, no rescale), to be
// summed across the processes, which is exact; dupl_int8_rescale is the
// epilogue as a kernel of its own on that sum, (f32(C) * sa[m]) * sw[n]
// or fma(f32(C) * sa[m], sw[n], bias[n]), so that the split product gives
// the one-process product's bits.  The rescale reads 4 bytes and writes 4
// an element: it is bound by the bytes, a thread taking four elements of
// a row (16-byte loads and stores where N is a multiple of 4).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128, kBN = 128;  // output tile of a consumer warpgroup
constexpr int kBK = 128;             // int8 columns of a K slice: 128-byte rows
constexpr int kStages = 5;
// CTAs of a cluster, on vertically adjacent tiles: they share B's tile,
// each loading its half and multicasting it to both
constexpr int kCluster = 2;
constexpr int kThreads = 384;        // 2 consumer warpgroups + 1 producer
constexpr int kTileBytes = kBM * kBK;        // A's (or B's) share of a stage
constexpr int kStageBytes = 2 * kTileBytes;  // 32 KB
constexpr int kBoxCols = 32;                 // fp32 columns of a store box
constexpr int kBoxBytes = 64 * kBoxCols * 4;  // 8 KB
constexpr int kOutBytes = (kBN / kBoxCols) * kBoxBytes;  // 64 rows of a tile
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kOutBytes + 1024;

struct Maps {
  CUtensorMap a, b, c;
};

// D (64 x 128, s32) (+)= A (64 x 32, shared) . B (128 x 32, shared)^T,
// both K-major int8.  kInit: the first k-step of a tile, which writes D
// without reading it, so the previous tile's sums do not flow into the
// chain (see hopper.cuh's wgmma_ss_n128_init).
template <bool kInit>
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (kInit) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
          "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
          "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]),
          "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]),
          "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]),
          "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
          "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]),
          "=r"(d[28]), "=r"(d[29]), "=r"(d[30]), "=r"(d[31]),
          "=r"(d[32]), "=r"(d[33]), "=r"(d[34]), "=r"(d[35]),
          "=r"(d[36]), "=r"(d[37]), "=r"(d[38]), "=r"(d[39]),
          "=r"(d[40]), "=r"(d[41]), "=r"(d[42]), "=r"(d[43]),
          "=r"(d[44]), "=r"(d[45]), "=r"(d[46]), "=r"(d[47]),
          "=r"(d[48]), "=r"(d[49]), "=r"(d[50]), "=r"(d[51]),
          "=r"(d[52]), "=r"(d[53]), "=r"(d[54]), "=r"(d[55]),
          "=r"(d[56]), "=r"(d[57]), "=r"(d[58]), "=r"(d[59]),
          "=r"(d[60]), "=r"(d[61]), "=r"(d[62]), "=r"(d[63])
        : "l"(a), "l"(b), "r"(0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y)
               : "memory");
}

// kI32: C is int32, the accumulators as they stand (sa, sw, bias unused).
template <bool kI32>
__global__ void __launch_bounds__(kThreads, 1) __cluster_dims__(kCluster, 1, 1)
int8_gemm_kernel(const __grid_constant__ Maps maps, const float* __restrict__ sa,
                 const float* __restrict__ sw, const float* __restrict__ bias,
                 int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = smem_u32(&bars[0]);          // + 8 * stage
  const uint32_t empty = smem_u32(&bars[kStages]);
  // the cluster's tiles are kCluster vertically adjacent ones; this CTA's
  // is the rank-th
  const int rank = static_cast<int>(cluster_rank());
  const int n_tiles = (n + kBN - 1) / kBN;
  const int ctiles = ((m + kBM - 1) / kBM + kCluster - 1) / kCluster * n_tiles;
  const int k_tiles = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  // the j-th tile of this CTA: cluster tile first + j * step, this CTA's part
  const int first = static_cast<int>(cluster_id()), step = static_cast<int>(cluster_count());
  auto origin = [&](int j, int& m0, int& n0) {
    const int ct = first + j * step;
    m0 = (ct / n_tiles * kCluster + rank) * kBM;
    n0 = ct % n_tiles * kBN;
  };
  const int my_tiles = first < ctiles ? (ctiles - first + step - 1) / step : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      // the consuming warpgroup of every CTA of the cluster: a stage is
      // refilled (by this CTA's copies and its peers') only when all of
      // them have read it
      mbar_init(empty + 8 * s, kCluster);
    }
    mbar_fence_init();
  }
  cluster_sync();

  // The producer hands its registers to the consumers (two 64 x 128 int32
  // accumulators a thread and the epilogue), and the two roles never meet
  // again in the code, as setmaxnreg wants.  Each ends in the cluster
  // barrier, so that no CTA leaves while a peer may still copy into it or
  // arrive on its barriers.
  if (wg == 2) {  // ---- producer ------------------------------------------------
    regs_dec<40>();
    if (threadIdx.x == 256) {
      constexpr int kRowsB = kBN / kCluster;  // this CTA's share of B's tile
      constexpr uint16_t kEvery = (1u << kCluster) - 1;
      int it = 0;
      for (int j = 0; j < my_tiles; ++j) {
        int m0, n0;
        origin(j, m0, n0);
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t st = base + s * kStageBytes;
          mbar_expect_tx(full + 8 * s, kStageBytes);
          tma_load_2d(st, &maps.a, full + 8 * s, kt * kBK, m0);
          tma_load_2d_multicast(st + kTileBytes + rank * kRowsB * kBK, &maps.b,
                                full + 8 * s, kt * kBK, n0 + rank * kRowsB, kEvery);
        }
      }
    }
    cluster_sync();
    return;
  }
  // ---- consumers: every other tile each, 128 x 128 ---------------------------
  regs_inc<232>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
  const uint32_t out = base + kStages * kStageBytes + wg * kOutBytes;
  int acc[2][64];  // rows 0-63 and 64-127 of the tile
  // the four k32 steps of the slice in stage s; a tile's first writes D
  auto issue = [&](int s, auto first_slice) {
    const uint32_t a_tile = base + s * kStageBytes;
    const uint32_t b_tile = a_tile + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      const uint64_t db = kmajor_desc(b_tile, 64, kk);
      if (decltype(first_slice)::value && kk == 0) {
        wgmma_s8_n128<true>(acc[0], kmajor_desc(a_tile, 64, kk), db);
        wgmma_s8_n128<true>(acc[1], kmajor_desc(a_tile + 64 * kBK, 64, kk), db);
      } else {
        wgmma_s8_n128<false>(acc[0], kmajor_desc(a_tile, 64, kk), db);
        wgmma_s8_n128<false>(acc[1], kmajor_desc(a_tile + 64 * kBK, 64, kk), db);
      }
    }
    wgmma_commit();
  };
  // the slice at ring position `at` has been read: release it in every CTA
  auto release = [&](int at) {
    if (tid == 0)
      for (int r = 0; r < kCluster; ++r)
        mbar_arrive_cluster(empty + 8 * (at % kStages), r);
  };
  // Warpgroup wg takes this CTA's tiles wg, wg + 2, ...: the ring holds
  // their slices in tile order, and the two warpgroups take turns at the
  // products (named barriers 3 and 4 pass the turn), so one warpgroup's
  // products run while the other writes its tile out.  The turns also
  // keep a warpgroup's first wait on a stage at most one phase ahead of
  // the stage's barrier, as a parity wait needs.
  for (int j = wg; j < my_tiles; j += 2) {
    int m0, n0;
    origin(j, m0, n0);
    if (j > 0) bar_sync(3 + wg, 256);  // tile j - 1's products are issued
    int it = j * k_tiles;
    mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
    issue(it % kStages, std::true_type());
    ++it;
    for (int kt = 1; kt < k_tiles; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      issue(s, std::false_type());
      wgmma_wait<1>();  // the previous slice's products have read their stage
      release(it - 1);
    }
    if (j + 1 < my_tiles) bar_arrive(4 - wg, 256);  // the other's turn
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    release(it - 1);
    // each 64-row half: rescaled, into `out` in the 128-byte swizzle
    // (rows r and r + 8, columns 8 j + 2 t, + 1 of each thread), then to
    // C by four TMA stores of 64 x 32
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row0 = m0 + 64 * half, rw = warp * 16 + g;  // row in the half
      // (kI32 reads none of the scales and biases)
      const float sa0 = !kI32 && row0 + rw < m ? __ldg(sa + row0 + rw) : 0.0f;
      const float sa1 = !kI32 && row0 + rw + 8 < m ? __ldg(sa + row0 + rw + 8) : 0.0f;
      // the two halves read the same weight scales and biases: opaque
      // copies of the pointers keep the compiler from holding the first
      // half's loads in registers for the second (which spilled)
      const float* swp = sw;
      const float* bp = bias;
      asm volatile("" : "+l"(swp), "+l"(bp));
      if (tid == 0) bulk_wait_read<0>();  // the last stores have read `out`
      bar_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;  // n % 8 == 0: col + 1 < n with col
        const float2 w = !kI32 && col < n
                             ? __ldg(reinterpret_cast<const float2*>(swp + col))
                             : make_float2(0.0f, 0.0f);
        const float2 b = !kI32 && bias != nullptr && col < n
                             ? __ldg(reinterpret_cast<const float2*>(bp + col))
                             : make_float2(0.0f, 0.0f);
        const uint32_t chunk = 2 * (j % 4) + (t >> 1);  // 16-byte chunk in the row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0, v1;
          if constexpr (kI32) {   // the int32 sums' bits, for the store
            v0 = __int_as_float(acc[half][4 * j + 2 * h]);
            v1 = __int_as_float(acc[half][4 * j + 2 * h + 1]);
          } else {
            const float s = h ? sa1 : sa0;
            const float y0 = __fmul_rn(__int2float_rn(acc[half][4 * j + 2 * h]), s);
            const float y1 = __fmul_rn(__int2float_rn(acc[half][4 * j + 2 * h + 1]), s);
            v0 = bias != nullptr ? __fmaf_rn(y0, w.x, b.x) : __fmul_rn(y0, w.x);
            v1 = bias != nullptr ? __fmaf_rn(y1, w.y, b.y) : __fmul_rn(y1, w.y);
          }
          const uint32_t r = rw + 8 * h;
          st_shared_f2(out + (j / 4) * kBoxBytes + r * 128 + ((chunk ^ (r & 7)) << 4) +
                           ((t & 1) << 3),
                       v0, v1);
        }
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if (tid == 0) {
        if (row0 < m)
          for (int box = 0; box < kBN / kBoxCols; ++box)
            if (n0 + box * kBoxCols < n)
              tma_store_2d(&maps.c, out + box * kBoxBytes, n0 + box * kBoxCols, row0);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait<0>();  // shared memory stays until the stores end
  cluster_sync();
}

// Clusters of the kernel resident on the current device at once, cached
// per device.
int max_clusters() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev]) return cached[dev];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, int8_gemm_kernel<false>, &cfg) !=
          cudaSuccess ||
      clusters < 1) {
    cudaGetLastError();  // clear the query's error
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    clusters = sms / kCluster;
  }
  if (dev < 64) cached[dev] = clusters;
  return clusters;
}

// The rescale: a thread takes kVec consecutive elements of a row.
template <int kVec>
__global__ void __launch_bounds__(256)
int8_rescale_kernel(const int* __restrict__ acc, const float* __restrict__ sa,
                    const float* __restrict__ sw, const float* __restrict__ bias,
                    float* __restrict__ out, int64_t total, int n) {
  const int64_t e0 = (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x) * kVec;
  if (e0 >= total) return;
  const int64_t row = e0 / n;
  const int col = static_cast<int>(e0 - row * n);
  const float s = __ldg(sa + row);
  int a[kVec];
  if constexpr (kVec == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(acc + e0));
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  } else {
    a[0] = acc[e0];
  }
  float y[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float p = __fmul_rn(__int2float_rn(a[i]), s);
    y[i] = bias != nullptr ? __fmaf_rn(p, __ldg(sw + col + i), __ldg(bias + col + i))
                           : __fmul_rn(p, __ldg(sw + col + i));
  }
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(out + e0) = make_float4(y[0], y[1], y[2], y[3]);
  else
    out[e0] = y[0];
}

template <bool kI32>
int gemm(const void* a, const void* sa, const void* b, const void* sw,
         const void* bias, void* c, int m, int n, int k, void* stream) {
  if (m < 1 || n < 8 || n % 8 || k < 32 || k % 32 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps;
  if (!encode_2d(&maps.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, m, k, k, kBM, kBK) ||
      !encode_2d(&maps.b, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, n, k, k, kBN / kCluster,
                 kBK) ||
      !encode_2d(&maps.c, kI32 ? CU_TENSOR_MAP_DATA_TYPE_INT32
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                 c, m, n, static_cast<int64_t>(n) * 4, 64, kBoxCols))
    return static_cast<int>(cudaErrorInvalidValue);
  static uint32_t configured = 0;
  smem_bytes_once(configured, int8_gemm_kernel<kI32>, kSmemBytes);
  const int ctiles = ((m + kBM - 1) / kBM + kCluster - 1) / kCluster *
                     ((n + kBN - 1) / kBN);
  const int clusters = ctiles < max_clusters() ? ctiles : max_clusters();
  int8_gemm_kernel<kI32><<<clusters * kCluster, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const float*>(sa), static_cast<const float*>(sw),
      static_cast<const float*>(bias), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (m, k), b (n, k) int8 and c (m, n) fp32, 16-byte aligned; k a multiple
// of 32, n of 8; bias may be null
extern "C" int dupl_int8_gemm(const void* a, const void* sa, const void* b,
                              const void* sw, const void* bias, void* c, int m,
                              int n, int k, void* stream) {
  return gemm<false>(a, sa, b, sw, bias, c, m, n, k, stream);
}

// a (m, k), b (n, k) int8 and c (m, n) int32, as dupl_int8_gemm takes them:
// c = a b^T, the exact int32 sums
extern "C" int dupl_int8_gemm_i32(const void* a, const void* b, void* c, int m,
                                  int n, int k, void* stream) {
  return gemm<true>(a, nullptr, b, nullptr, nullptr, c, m, n, k, stream);
}

// acc (m, n) int32, sa (m,), sw (n,), bias (n,) or null fp32, out (m, n)
// fp32, on the device: out = (f32(acc) sa[m]) sw[n], or fma(f32(acc) sa[m],
// sw[n], bias[n]).  acc and out 16-byte aligned when n % 4 == 0.
extern "C" int dupl_int8_rescale(const void* acc, const void* sa, const void* sw,
                                 const void* bias, void* out, int m, int n,
                                 void* stream) {
  if (m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(m) * n;
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(acc) |
                                  reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int per = vec ? 4 : 1;
  const unsigned blocks = static_cast<unsigned>((total / per + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int*>(acc);
  const auto* s = static_cast<const float*>(sa);
  const auto* w = static_cast<const float*>(sw);
  const auto* bb = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (vec)
    int8_rescale_kernel<4><<<blocks, 256, 0, st>>>(a, s, w, bb, o, total, n);
  else
    int8_rescale_kernel<1><<<blocks, 256, 0, st>>>(a, s, w, bb, o, total, n);
  return static_cast<int>(cudaGetLastError());
}
