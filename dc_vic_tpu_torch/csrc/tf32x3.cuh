// f32-class matrix products on the tensor cores: the error-compensated
// 3xTF32 split and the warpgroup products (wgmma) that take it, shared by the
// attention kernel (flash_attn_f32.cu) and the 3x3 conv kernels (conv3x3.cu).
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
// rounding to nearest, so a long chain of products into one accumulator
// drifts towards zero by up to one unit in the last place per instruction.
// Both kernels therefore let the tensor cores sum only a short chain starting
// from zero (the conv: the 27 products of one channel group; the attention: 32
// channels of a score, 32 keys of an output, 12 products each) and add that
// partial sum to the running f32 accumulator with an ordinary rounded add.
//
// The instruction is wgmma.mma_async.m64nNk8 with TF32 operands: A (64 x 8)
// from registers, each of a warpgroup's four warps holding 16 rows as the
// m16n8k8 fragment, B (8 x N) from shared memory through a descriptor. TF32
// operands have no transpose: both are K-major. With g = lane / 4 and
// t = lane % 4 a thread of warp w holds
//   A (rows 16w..16w+15):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   D (rows 16w..16w+15):  d[4j] (g, 8j + 2t)      d[4j + 1] (g, 8j + 2t + 1)
//                          d[4j + 2] (g + 8, 8j + 2t)  d[4j + 3] (g + 8, 8j + 2t + 1)
// B is built of core matrices of 8 rows (along N) x 16 bytes (4 values along K),
// 128 contiguous bytes each: the two of an 8-wide k step 128 bytes apart, the
// 8-row groups along N 256 bytes apart.
// An infinite operand gives a NaN low part (inf - inf) and so a NaN result.
#pragma once
#include <stdint.h>

namespace tf32x3 {

// a to the nearest TF32 value, ties away from zero, as cvt.rna.tf32.f32 gives
// it for every finite a, by integer arithmetic on the bits: the conversion
// instruction runs at a fraction of the integer and float rate (it cost the
// first tensor-core attention kernel 15% of its time on an H100).
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

// ---- warpgroup products: D[64 x N] (+)= A[64 x 8] B[8 x N], asynchronous

// The descriptor of a K-major B operand in shared memory without swizzle:
// start address, 128 bytes between the core matrices along K, 256 bytes
// between the 8-row groups along N (all in 16-byte units).
__device__ __forceinline__ uint64_t b_descriptor(const void* smem) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(smem));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most kPending committed groups of this warpgroup are in flight.
template <int kPending> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// An empty statement that reads and writes the registers: the compiler can
// neither read what a wgmma writes before the wait in front of this, nor
// reuse what a wgmma in flight still reads before it.
template <int kN> __device__ __forceinline__ void hold(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (+)= a * b with both operands split, b as the descriptors of its hi and lo
// parts: the three products, small terms first; the first adds to d only if
// `accumulate` (0 starts a chain from zero).
template <int kN>
__device__ __forceinline__ void wgmma_split(float (&d)[kN], const uint32_t (&a_hi)[4],
                                            const uint32_t (&a_lo)[4], uint64_t b_hi,
                                            uint64_t b_lo, int accumulate) {
  wgmma(d, a_lo, b_hi, accumulate);
  wgmma(d, a_hi, b_lo, 1);
  wgmma(d, a_hi, b_hi, 1);
}

}  // namespace tf32x3
