// f32-class matrix products on the tensor cores: the error-compensated
// 3xTF32 split shared by the attention kernel (flash_attn_f32.cu) and the
// 3x3 conv kernels (conv3x3.cu).
//
// TF32 keeps 10 explicit mantissa bits, about three decimal digits, which is
// not enough for the codec (its kernels are held to 1e-4 against f32
// references). An f32 operand a is therefore split in two TF32 values,
//   a_hi = tf32(a),  a_lo = tf32(a - a_hi)      (both rounded to nearest),
// so that a_hi + a_lo carries 22 bits of a, and a product is taken as
//   a_lo * b_hi + a_hi * b_lo + a_hi * b_hi     (small terms first),
// three tensor-core products per multiply; a_lo * b_lo (2^-22 of the product
// at most) is dropped. ops/tf32.py holds the same arithmetic in plain PyTorch, and
// tests/test_torch_tf32x3.py holds it to a float64 product.
//
// The tensor cores add into their f32 accumulator by truncation, not by
// rounding to nearest, so a long chain of mma instructions into one
// accumulator drifts towards zero by up to one unit in the last place per
// instruction. Both kernels therefore let the tensor cores sum only a short
// chain starting from zero (one k8 step, or the 27 products of one channel
// group of the conv) and add that partial sum to the running f32 accumulator
// with an ordinary rounded add.
//
// The attention kernel's instruction is mma.sync.aligned.m16n8k8 with TF32
// operands from registers (below); the conv kernels issue wgmma.m64n64k8, whose
// A operand is the same fragment in each of a warpgroup's four warps
// (conv3x3.cu). With g = lane / 4 and t = lane % 4 a thread holds
//   A (16 x 8, row):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B ( 8 x 8, col):  b0 (k = t, n = g)           b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// An infinite operand gives a NaN low part (inf - inf) and so a NaN result.
#pragma once
#include <stdint.h>

namespace tf32x3 {

// a to the nearest TF32 value, ties away from zero, as cvt.rna.tf32.f32 gives
// it for every finite a, by integer arithmetic on the bits: the conversion
// instruction runs at a fraction of the integer and float rate, and the
// attention kernel splits each operand element in registers every time it
// uses it (the instruction cost it 15% of its time on an H100).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a - hi is exact in f32. A tensor core reads the upper 19 bits of an operand
// register and ignores the rest, so half a unit added to the bits of a - hi is
// all the rounding lo needs: what the product sees is tf32(a - hi), within
// 2^-22 of a, half the error of a lo that is simply cut off.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi)) + 0x1000u;
}

// d = a * b + c on one 16 x 8 x 8 tile.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2], const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d += a * b with both operands split: the three products, small terms first.
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4],
                                          const uint32_t (&b_hi)[2],
                                          const uint32_t (&b_lo)[2]) {
  mma(d, a_lo, b_hi, d);
  mma(d, a_hi, b_lo, d);
  mma(d, a_hi, b_hi, d);
}

}  // namespace tf32x3
