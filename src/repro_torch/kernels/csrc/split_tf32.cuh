// Helpers shared by the kernels that keep float32 accuracy on Hopper's
// tensor cores (ssd_chunk.cu, flash_attention.cu): float32 products as
// three TF32 products of split operands, and the cp.async copies that
// stage their tiles.
//
// A float32 x is split as x = hi + lo with hi = tf32(x) (round to
// nearest, ties away from zero, at the 10th mantissa bit: cvt.rna's
// rounding) and lo = tf32(x - hi), which carries the bits hi drops;
// a * b is then lo_a * hi_b + hi_a * lo_b + hi_a * hi_b, each an mma.sync
// m16n8k8 .tf32 with float32 accumulation.  The dropped lo_a * lo_b is
// below 2^-22 of the product, so the sum keeps float32 accuracy at a
// third of the 495 TFLOP/s TF32 peak.  The CPU models of this arithmetic
// are ../_tf32.py's.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// x = hi + lo, both TF32 (lo carries the bits hi drops).  The rounding
// adds half a TF32 ulp to the bit pattern and leaves the low 13 bits in
// place: the mma reads only the upper 19 bits of a .tf32 operand (nvcc's
// own lowering of cvt.rna.tf32.f32 feeds it the same unmasked sum), so
// only the subtraction clears them.  Four integer and float operations,
// against seven for cvt.rna's lowering, which also keeps an infinity an
// infinity; here x must be finite (an infinity comes out as NaN).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// d += a * b, one m16n8k8 TF32 product.  Fragments (g = lane / 4,
// t = lane % 4): a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]}.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment split into TF32 (hi, lo), for reuse across column tiles
struct FragA {
  uint32_t h[4], l[4];
};

__device__ __forceinline__ FragA split_a(const float (&a)[4]) {
  FragA f;
#pragma unroll
  for (int k = 0; k < 4; ++k) split(a[k], f.h[k], f.l[k]);
  return f;
}

// d += a * b at f32 accuracy: the three TF32 products, small ones first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const float (&b)[2]) {
  uint32_t bh[2], bl[2];
  split(b[0], bh[0], bl[0]);
  split(b[1], bh[1], bl[1]);
  mma(d, a.l, bh);
  mma(d, a.h, bl);
  mma(d, a.h, bh);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K));
}
