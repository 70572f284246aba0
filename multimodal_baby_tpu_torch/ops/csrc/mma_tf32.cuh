// f32 products on the tensor cores as three TF32 products (sm_80 and
// later, mma.sync m16n8k8): x = hi + lo with hi = x's top 19 bits (TF32,
// truncated) and lo = x - hi exactly in f32, of which the tensor core in
// turn reads the top 19 bits; a . b ~ hi_a hi_b + (lo_a hi_b + hi_a lo_b),
// the lo . lo term and lo's truncation each about 2^-20 of the product.
// The split is one integer and one float operation; hi is passed as x's own
// bits, which the tensor core truncates the same way. (A split by
// cvt.rna.tf32, a conversion of lower throughput, left the first version of
// K9 no faster than f32 FMAs; with integer operations, and the mma left to
// the compiler to schedule, its products took 27% fewer cycles.) K9
// (lstm.cu) and K4 (infonce.cu) keep the large term and the two small ones
// in separate accumulators and add them once at the end: main + corr.
//
// Fragments of m16n8k8 .tf32 (g = lane / 4, q = lane % 4):
//   A (16 x 8, row): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, col):  b0 (k = q, n = g), b1 (k = q + 4, n = g)
//   C (16 x 8):      c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));
}

// d += a . b (not volatile: a pure function of its registers, which the
// compiler may schedule among the loads and splits)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// main += a_hi b_hi; corr += a_lo b_hi, then corr += a_hi b_lo
__device__ __forceinline__ void mma_3xtf32(float (&main)[4], float (&corr)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(corr, alo, bhi);
  mma_tf32(corr, ahi, blo);
  mma_tf32(main, ahi, bhi);
}

}  // namespace
