// Helpers shared by the mma.sync kernels of the experiment tools
// (exp_attention_ones.cu, exp_attention_bnhd.cu, crf_apply_bf16.cu): the
// m16n8k16 bf16 tensor-core product with fp32 accumulation, and packed bf16
// loads and conversions.
//
// Fragment layout of mma.sync.m16n8k16 for lane = 4 * g + t (g = 0..7, t =
// 0..3): A (16 x 16, row) a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8,
// same cols), a[2] = (row g, cols 2t+8, 2t+9), a[3] = (row g+8, those cols);
// B (16 x 8, col) b[0] = (rows 2t, 2t+1, col g), b[1] = (rows 2t+8, 2t+9,
// col g); C (16 x 8) c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = (row
// g+8, same cols).  The C layout of two neighbouring n-tiles is the A layout
// of one 16-deep k-step.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

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
