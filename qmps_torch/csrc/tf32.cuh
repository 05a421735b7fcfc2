// 3xTF32 on the tensor cores: the TF32 split of a float32 operand and the
// mma.sync.m16n8k8 tile that K6, K7 and K8 run their products on.
#pragma once

#include <cstdint>

namespace qmps {

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero:
// half an ulp added to the magnitude's bits, the low 13 bits cleared), as
// the b32 register mma takes.  cvt.rna.tf32.f32 computes the same for
// finite x, but compiles to compares and selects around it (no NaN or
// infinity reaches here: the planes are normalised)
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// 3xTF32's split: x = hi + lo, both TF32; hi hi + hi lo + lo hi keeps
// float32's accuracy (the lo lo term is below float32's rounding)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b for a 16 x 8 (row) by 8 x 8 (col) TF32 tile, float32 accumulators
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace qmps
