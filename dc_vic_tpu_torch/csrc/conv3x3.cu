// 3x3 stride-1 SAME convolution for the reconstruction stacks, plain (kernel
// K5) and with the GroupNorm affine, swish, conv bias and residual folded in
// (kernel K6).
//
// K5 conv3x3_same replaces the TPU kernel
// dc_vic_tpu/ops/conv3x3.py::_conv_kernel (launched by _conv3x3_fwd_impl
// through pl.pallas_call): zero padding, f32 accumulation, no bias,
// x [B, C, H, W] against w [Cout, C, 3, 3] -> [B, Cout, H, W] in x's type.
// Its dxcat variant is a matrix-unit shaping of the same function and has no
// separate counterpart here.
// K6 conv3x3_gn_swish replaces dc_vic_tpu/ops/conv3x3.py::_fused_kernel
// (launched by _fused_fwd_impl):
//   conv3x3(swish(x * scale[b, c] + bias[b, c])) + cbias[co] (+ res),
// where the zero padding applies AFTER the affine and swish.
//
// What bounds them on Hopper: operations. At [4, 128, 768, 512] -> 128 in f32
// the conv is 464 GFLOP against 1.6 GB of traffic. The codec needs f32-class
// results, so the products run on the tensor cores as an error-compensated
// 3xTF32 split (tf32x3.cuh): three TF32 products per multiply, a third of the
// 495 TFLOP/s dense TF32 rate at best (2.8 ms). Only the warpgroup
// instruction wgmma reaches that rate (32 cycles per m64n64k8 on an SM;
// mma.sync.m16n8k8 issues at 65% of it, and its B fragments cost a warp as
// many shared-memory wavefronts as it has products). What is left to lose is
// the time around the products: staging, barriers, the accumulator handling.
//
// Design: an implicit GEMM over the staged tile, M = pixels, N = output
// channels, K = (tap, input channel), without an im2col copy. The tensors are
// NCHW and OIHW as the port keeps them. A block of 512 threads, four
// warpgroups, owns an output tile of 8 rows x 32 columns x 64 output channels
// and loops over the input channels 8 at a time; a warpgroup owns two rows of
// the tile, the M = 64 of its wgmma, with all 64 channels as N: 32 f32
// accumulators a thread. One k8 step is one tap of the 8 staged channels:
// A[m, c] = x_s[c][y + dy][x + dx] from registers, B[c, n] = w[c][tap][n]
// from shared memory.
//   * Split once, not at every use. The haloed input tile [8][10][34] (zero
//     outside the image) is written to shared memory as a hi plane and a lo
//     plane, rows padded to 36, so that the channel-plane stride of 360 puts
//     the 4 channels x 8 pixels of an A fragment load in 32 distinct banks,
//     and each of the four registers of a fragment is loaded in place. The
//     weights are split once per call by a small kernel that rewrites them
//     from OIHW into scratch memory the caller provides, as the [64 x 8] B
//     operands the tensor cores read (K-major core matrices, no swizzle), hi
//     and lo apart, so the slab of a step is a plain copy and B costs no
//     register and no load instruction.
//   * Overlap. Two shared-memory buffers (2 x 58.5 KB, one block per SM):
//     while the tensor cores work on step s, the input values of step s + 1
//     wait in registers (global -> registers -> shared, where K6's prologue
//     transforms them on the way in; where a value comes from and goes to is
//     worked out once per block) and its weight slab arrives by cp.async; one
//     barrier per step. A warpgroup waits for the three products of a tap
//     before it loads the next tap's A fragments (they read its registers);
//     the other three warpgroups keep the tensor cores busy meanwhile.
//   * Accuracy. Within a step a warpgroup sums its 9 taps (27 products) on
//     the tensor cores from zero; the partial sum is then added to the f32
//     accumulator with a rounded add (see tf32x3.cuh).
// f32 only: bf16 convolutions take csrc/conv3x3_bf16.cu. The TPU kernel's
// double-buffered DMA ring and its slot parity are pipeline mechanics of that
// machine and were not carried over.
//
// K6's prologue runs where the input tile is written to shared memory: v =
// x * scale + bias, v = v * sigmoid(v) for positions inside the image and a
// literal 0 outside, which is the whole of the TPU kernel's "re-zero the
// halo" step. The sum over input channels and taps runs in one warpgroup's
// accumulators in a fixed order (no split over channels across blocks, no
// atomics), so the output has the same bits on every run. Global offsets are
// 64-bit per image and channel group, 32-bit inside one (8 planes). Needs
// C % 8 == 0 and Cout % 64 == 0; ragged tiles are masked on store.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 512;  // four warpgroups
constexpr int kTW = 32;        // output columns of a tile
constexpr int kTCO = 64;       // output channels of a tile: the N of a wgmma
constexpr int kTH = 8;         // output rows of a tile: two per warpgroup, its M = 64
constexpr int kKC = 8;         // input channels staged per step (one k8)
constexpr int kXRows = kTH + 2;
constexpr int kXCols = kTW + 2;
constexpr int kXStride = kXCols + 2;            // row stride of the staged input
constexpr int kXPlane = kXRows * kXStride;      // 360 = 8 (mod 32): see above
constexpr int kXTile = kKC * kXPlane;           // floats of a staged tile, hi or lo
constexpr int kXElems = kKC * kXRows * kXCols;  // values of a staged tile
constexpr int kXPer = (kXElems + kThreads - 1) / kThreads;  // values per thread
constexpr int kBOperand = kTCO * kKC * 4;       // bytes of one wgmma B operand
constexpr int kWSlab = 9 * 2 * kBOperand / 16;  // float4 of a step's weight slab
constexpr int kBufBytes = 2 * kXTile * 4 + kWSlab * 16;  // input hi, lo, weights
constexpr int kSmemBytes = 2 * kBufBytes;
static_assert(kXPlane % 32 == 8, "channel planes must be 8 banks apart");
static_assert(kXTile % 2 == 0 && kBufBytes % 16 == 0, "the weight slabs stay 16-byte aligned");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// w [Cout][C][9] (f32) -> wt [C / 8][9][hi, lo][Cout / 8][2][8] float4: per 8
// input channels, tap and part, the [Cout x 8] B operand of a wgmma in the
// K-major layout without swizzle, built of 8 x 16-byte core matrices: output
// channel n8 * 8 + r, input channels c8 * 8 + half * 4 + (0..3) at float4
// index (n8 * 2 + half) * 8 + r.
__global__ void __launch_bounds__(kThreads)
repack_weights_kernel(const float* __restrict__ w, float4* __restrict__ wt, int C, int Cout) {
  const int64_t n8s = Cout / 8;
  const int64_t total = static_cast<int64_t>(C / 8) * 9 * 2 * n8s * 16;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int r = static_cast<int>(idx % 8), half = static_cast<int>((idx / 8) % 2);
  const int64_t n8 = (idx / 16) % n8s;
  const int lo_part = static_cast<int>((idx / 16 / n8s) % 2);
  const int64_t tap = (idx / 16 / n8s / 2) % 9;
  const int64_t c8 = idx / 16 / n8s / 2 / 9;
  const int64_t co = n8 * 8 + r, c = c8 * 8 + half * 4;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t hi, lo;
    tf32x3::split(w[(co * C + c + i) * 9 + tap], hi, lo);
    v[i] = __uint_as_float(lo_part ? lo : hi);
  }
  wt[idx] = make_float4(v[0], v[1], v[2], v[3]);
}

// The warpgroup products, their descriptor and fences are tf32x3.cuh's. Here
// D [64 x 64] (+)= A [64 x 8] B [8 x 64]: A from registers, B from shared memory.

template <bool kFused>
__device__ __forceinline__ void conv_tile(
    const float* __restrict__ x, const float4* __restrict__ wt,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ cbias, const float* __restrict__ res,
    float* __restrict__ out, int C, int Cout, int H, int W, int tiles_w) {
  // two buffers, each the hi plane [kKC][kXRows][kXStride], the lo plane and
  // the [9][hi, lo] B operands; addressed as offsets from the one shared
  // array, so that every access compiles to a shared-memory instruction
  extern __shared__ float4 smem4[];
  float* const x_s = reinterpret_cast<float*>(smem4);
  float4* const w_s = smem4 + kXTile / 2;
  constexpr int kXBuf = kBufBytes / 4, kWBuf = kBufBytes / 16;  // buffer strides

  const int co_chunks = Cout / kTCO;
  const int co0 = (blockIdx.x % co_chunks) * kTCO;
  const int tile = blockIdx.x / co_chunks;
  const int h0 = (tile / tiles_w) * kTH;
  const int w0 = (tile % tiles_w) * kTW;
  const int64_t b = blockIdx.y;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int n8s = Cout / 8;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a warpgroup owns two rows of the tile, the 64 pixels of its wgmma; warp w
  // of it holds pixels 16 w .. 16 w + 15: row w / 2, columns from (w % 2) * 16
  const int row0 = (warp >> 2) * 2 + ((warp >> 1) & 1);
  const int x0 = (warp & 1) * 16;
  const int g = lane >> 2, t = lane & 3;

  // Staging of the input tile: value e = tid + i * kThreads of the tile is
  // (c, r, col) in row-major order. Where it lies in the image plane and in
  // x_s does not change from step to step, so it is worked out once.
  float xr[kXPer];                 // the next step's input values, on their way in
  int x_from[kXPer], x_to[kXPer];  // offset in the 8 planes of x; place in x_s
  unsigned inside = 0;             // which of them lie inside the image
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int e = tid + i * kThreads;
    const int c = e / (kXRows * kXCols), rem = e - c * (kXRows * kXCols);
    const int r = rem / kXCols, col = rem - r * kXCols;
    const int gh = h0 - 1 + r, gw = w0 - 1 + col;
    x_from[i] = c * static_cast<int>(plane) + gh * W + gw;
    x_to[i] = e < kXElems ? c * kXPlane + r * kXStride + col : -1;
    if (e < kXElems && gh >= 0 && gh < H && gw >= 0 && gw < W) inside |= 1u << i;
  }
  // global -> registers
  auto load_x = [&](int c0) {
    const float* from = x + (b * C + c0) * plane;
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      xr[i] = 0.f;  // the SAME padding, in the space the conv reads
      if (inside >> i & 1u) xr[i] = from[x_from[i]];
    }
  };
  // registers -> shared, through K6's prologue, split in hi and lo
  auto store_x = [&](int c0, float* dst) {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      float v = xr[i];
      if (kFused && (inside >> i & 1u)) {
        const int64_t ch = b * C + c0 + x_to[i] / kXPlane;
        v = __fadd_rn(__fmul_rn(v, scale[ch]), bias[ch]);
        // swish with the fast exponential and reciprocal (a few units in the
        // last place): every warp of the block is here at once with the
        // tensor cores idle
        v = __fdividef(v, 1.0f + __expf(-v));
      }
      uint32_t hi, lo;
      tf32x3::split(v, hi, lo);
      if (x_to[i] >= 0) {
        dst[x_to[i]] = __uint_as_float(hi);
        dst[kXTile + x_to[i]] = __uint_as_float(lo);
      }
    }
  };
  // the weight slab of step c8 for this block's 64 output channels
  auto load_w = [&](int c8, float4* dst) {
    constexpr int kPerPart = (kTCO / 8) * 16;  // float4 of one tap's hi or lo operand
    for (int i = tid; i < kWSlab; i += kThreads)
      cp_async16(dst + i, wt + ((static_cast<int64_t>(c8) * 18 + i / kPerPart) * n8s +
                                co0 / 8) * 16 + i % kPerPart);
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const int steps = C / kKC;
  load_w(0, w_s);
  load_x(0);
  store_x(0, x_s);
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {  // the other buffer was last read in step s - 1
      load_w(s + 1, w_s + (cur ^ 1) * kWBuf);
      load_x((s + 1) * kKC);
    }

    float part[32];  // this step's sum over the 9 taps, from zero
    const float* xa = x_s + cur * kXBuf + t * kXPlane + row0 * kXStride + x0 + g;
    const uint64_t b0 = tf32x3::b_descriptor(w_s + cur * kWBuf);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* p = xa + (tap / 3) * kXStride + tap % 3;
      uint32_t a_hi[4] = {__float_as_uint(p[0]), __float_as_uint(p[8]),
                          __float_as_uint(p[4 * kXPlane]),
                          __float_as_uint(p[4 * kXPlane + 8])};
      uint32_t a_lo[4] = {__float_as_uint(p[kXTile]), __float_as_uint(p[kXTile + 8]),
                          __float_as_uint(p[kXTile + 4 * kXPlane]),
                          __float_as_uint(p[kXTile + 4 * kXPlane + 8])};
      // a tap's hi operand, then its lo operand, 2 KB each (16-byte units)
      const uint64_t b_hi = b0 + tap * 2 * (kBOperand >> 4);
      const uint64_t b_lo = b_hi + (kBOperand >> 4);
      tf32x3::wgmma_fence();
      // small terms first; the first product of a step starts from zero
      tf32x3::wgmma_split(part, a_hi, a_lo, b_hi, b_lo, tap > 0);
      tf32x3::wgmma_commit();
      // the products read a_hi and a_lo until they are done; the other
      // warpgroups keep the tensor cores busy meanwhile
      tf32x3::wgmma_wait<0>();
      tf32x3::hold(a_hi);
      tf32x3::hold(a_lo);
    }
    tf32x3::hold(part);
    if (more) store_x((s + 1) * kKC, x_s + (cur ^ 1) * kXBuf);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];

    // the weights cp.async wrote are read next by the tensor cores' own path
    if (more) {
      cp_async_wait_all();
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();  // step s + 1 is staged; step s is read by all
  }

  // acc[nt * 4 + i]: row row0, pixel w0 + x0 + g (+ 8 for i >= 2), channel
  // co0 + nt * 8 + 2t (+ 1 for odd i)
  const int h = h0 + row0;
  if (h >= H) return;
#pragma unroll
  for (int nt = 0; nt < kTCO / 8; ++nt) {
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int co = co0 + nt * 8 + 2 * t + odd;
      const int64_t row = ((b * Cout + co) * H + h) * static_cast<int64_t>(W);
      const float cb = kFused ? cbias[co] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wq = w0 + x0 + g + half * 8;
        if (wq >= W) continue;
        float v = acc[nt * 4 + half * 2 + odd];
        if (kFused) {
          v += cb;
          if (res != nullptr) v += res[row + wq];
        }
        out[row + wq] = v;
      }
    }
  }
}

// ---------------------------------------------------------------- K5
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_same_kernel(const float* __restrict__ x, const float4* __restrict__ wt,
                    float* __restrict__ out, int C, int Cout, int H, int W, int tiles_w) {
  conv_tile<false>(x, wt, nullptr, nullptr, nullptr, nullptr, out, C, Cout, H, W,
                      tiles_w);
}

// ---------------------------------------------------------------- K6
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_gn_swish_kernel(const float* __restrict__ x, const float4* __restrict__ wt,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        const float* __restrict__ cbias, const float* __restrict__ res,
                        float* __restrict__ out, int C, int Cout, int H, int W, int tiles_w) {
  conv_tile<true>(x, wt, scale, bias, cbias, res, out, C, Cout, H, W, tiles_w);
}

struct Geometry {
  dim3 grid;
  int tiles_w;
  int repack_blocks;
  bool ok;
};

Geometry geometry(int B, int C, int Cout, int H, int W) {
  Geometry g{};
  g.ok = B > 0 && B <= 65535 && C > 0 && C % kKC == 0 && Cout > 0 &&
         Cout % kTCO == 0 && H > 0 && W > 0 &&
         static_cast<int64_t>(kKC) * H * W <= 2147483647LL;  // staging offsets are int
  if (!g.ok) return g;
  g.tiles_w = (W + kTW - 1) / kTW;
  const int64_t tiles_h = (H + kTH - 1) / kTH;
  const int64_t blocks = tiles_h * g.tiles_w * (Cout / kTCO);
  // one thread per float4 of the repacked weights
  const int64_t repack =
      (static_cast<int64_t>(C) * 9 * Cout / 2 + kThreads - 1) / kThreads;
  g.ok = blocks <= 2147483647LL && repack <= 2147483647LL;
  g.grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  g.repack_blocks = static_cast<int>(repack);
  return g;
}

template <typename K> cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

int launch(const void* x, const void* w, float* wt, const float* scale,
           const float* bias, const float* cbias, const void* res, void* out,
           int B, int C, int Cout, int H, int W, bool fused, cudaStream_t stream) {
  const Geometry g = geometry(B, C, Cout, H, W);
  if (!g.ok || reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float4* wt4 = reinterpret_cast<float4*>(wt);
  repack_weights_kernel<<<g.repack_blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(w), wt4, C, Cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = fused ? allow_smem(conv3x3_gn_swish_kernel) : allow_smem(conv3x3_same_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* xt = static_cast<const float*>(x);
  float* ot = static_cast<float*>(out);
  if (fused)
    conv3x3_gn_swish_kernel<<<g.grid, kThreads, kSmemBytes, stream>>>(
        xt, wt4, scale, bias, cbias, static_cast<const float*>(res), ot, C, Cout, H, W,
        g.tiles_w);
  else
    conv3x3_same_kernel<<<g.grid, kThreads, kSmemBytes, stream>>>(
        xt, wt4, ot, C, Cout, H, W, g.tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, C, H, W], w [Cout, C, 3, 3], out [B, Cout, H, W]: contiguous device
// f32 device memory; dtype must be 0 (f32: bf16 convolutions take
// csrc/conv3x3_bf16.cu). wt: scratch of
// 2 * C * 9 * Cout floats (the weights' hi and lo parts), 16-byte aligned.
// Needs C % 8 == 0 and Cout % 64 == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dcvic_conv3x3_same(const void* x, const void* w, float* wt, void* out,
                                  int B, int C, int Cout, int H, int W, int dtype,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, w, wt, nullptr, nullptr, nullptr, nullptr, out, B, C, Cout, H, W, false, s);
}

// As above, plus scale, bias [B, C] f32, cbias [Cout] f32 and res
// [B, Cout, H, W] f32, or null for no residual.
extern "C" int dcvic_conv3x3_gn_swish(const void* x, const void* w, float* wt,
                                      const float* scale, const float* bias,
                                      const float* cbias, const void* res, void* out,
                                      int B, int C, int Cout, int H, int W, int dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, w, wt, scale, bias, cbias, res, out, B, C, Cout, H, W, true, s);
}
