// 3x3 stride-1 SAME convolution in bf16 for the reconstruction stacks, plain
// (kernel K5) and with the GroupNorm affine, swish, conv bias and residual
// folded in (kernel K6). The f32 kernels are in conv3x3.cu.
//
// K5 conv3x3_same_bf16 replaces the TPU kernel
// dc_vic_tpu/ops/conv3x3.py::_conv_kernel (launched by _conv3x3_fwd_impl
// through pl.pallas_call; its dxcat variant is a matrix-unit shaping of the
// same function) for bf16 operands: zero padding, f32 accumulation, no bias,
// x [B, C, H, W] against w [Cout, C, 3, 3] -> [B, Cout, H, W] in bf16.
// K6 conv3x3_gn_swish_bf16 replaces dc_vic_tpu/ops/conv3x3.py::_fused_kernel
// (launched by _fused_fwd_impl) for bf16 operands:
//   conv3x3(bf16(swish(x * scale[b, c] + bias[b, c]))) + cbias[co] (+ res),
// where the zero padding applies AFTER the affine and swish, the conv's f32
// sum takes cbias and res in f32, and the result is rounded to bf16 once.
// The TPU kernel runs bf16 operands on its matrix unit with f32
// accumulation; a bf16 wgmma with f32 accumulation is its counterpart.
//
// What bounds them on Hopper: operations. At [4, 128, 768, 512] -> 128 the
// conv is 464 GFLOP against about 0.8 GB of traffic: 0.469 ms at the 989
// TFLOP/s dense bf16 rate, 0.24 ms at 3.35 TB/s. Only wgmma reaches that rate.
//
// Design: an implicit GEMM over a staged tile, M = pixels, N = output
// channels, K = (tap, input channel), without an im2col copy. A block of 512
// threads, four warpgroups, owns an output tile of 4 rows x 64 columns x 128
// output channels and loops over the input channels 16 at a time (one step);
// a warpgroup owns one row of the tile, the M = 64 of its
// wgmma.m64n128k16.f32.bf16.bf16, with 64 f32 accumulators a thread.
//   * Both operands from shared memory through descriptors, K-major, no
//     swizzle: a core matrix is 8 rows x 16 bytes, 128 contiguous bytes. The
//     input tile of a step is staged channel-innermost as
//     [channel group (2)][row (6)][column (66)][8 channels], 16 bytes a
//     pixel, so 8 consecutive pixels x 8 channels are one core matrix: along
//     M the core matrices are 128 bytes apart, along K (the next 8 channels)
//     one staged plane. A tap's shift is only a start-address offset: dx is
//     +16 bytes, dy one staged row (66 x 16 bytes). The nine taps read the
//     one staged tile.
//   * The weights are rewritten once per call from OIHW into the B operands
//     the tensor cores read, bf16 K-major core matrices, by a small kernel
//     into scratch the caller provides:
//     [C / 16][tap][Coutp / 8][k half][8 output channels][8 input channels]
//     (Coutp: Cout rounded up to 128, zeros beyond Cout), so the weight slab
//     of a step and a 128-channel tile is nine contiguous 4 KB runs.
//   * Issue and wait. A step issues its nine products back to back, commits
//     once and waits with wgmma.wait_group 1: the products of step s run
//     while later steps are staged. One barrier per step.
//   * Staging, with every load issued a step before it is needed (measured:
//     staging whose loads are waited for in the same step took as long as
//     the products). A ring of four stages (input tile plus weight slab,
//     48.4 KB each): at the start of step s, before its products are
//     issued, the weights of step s + 2 are requested from the bulk-copy
//     engine (cp.async.bulk, nine 4 KB runs by one thread, completing on the
//     stage's mbarrier; 2,304 16-byte cp.async a step by every thread, or
//     the bulk copies asked for after the products, were slower), and later
//     in the step the input values of step s + 2 are loaded into registers,
//     while those of step s + 1, loaded a step earlier, go to shared memory.
//     At the barrier that ends step s every warpgroup has finished step
//     s - 1, so step s + 2 may take the stage of step s - 2. The input goes global
//     -> registers -> shared memory as 8 two-byte loads a pixel and channel
//     group (neighbouring threads on neighbouring pixels) and one 16-byte
//     store; K6's prologue runs in f32 on the way: v = x * scale + bias,
//     v * sigmoid(v) with the fast exponential and reciprocal, a literal 0
//     outside the image, then rounded to bf16, which is the whole of the
//     TPU kernel's "re-zero the halo" step. Transposing on the way rules out
//     TMA for the input.
//   * Accumulation. bf16 products are exact in f32 and the tensor cores add
//     them into the f32 accumulators, which stay in registers across the
//     whole channel loop: one chain, no split, no partial sums. The order is
//     fixed (no split over channels across blocks, no atomics), so a launch
//     gives the same bits on every run.
//   * Epilogue. The accumulators go through shared memory as f32 (the ring
//     is free by then), and each thread then takes 8 runs of 8 consecutive
//     columns of one channel row (its residual loads all issued first):
//     cbias and res are added in f32 and the sum is rounded to bf16 once,
//     stored 16 bytes at a time where the row allows.
// One block an SM (512 threads at up to 128 registers, 198 KB of shared
// memory): a block's first staging and its epilogue are not overlapped with
// products.
// The TPU kernel's double-buffered DMA ring and its slot parity are pipeline
// mechanics of that machine and were not carried over.
//
// Needs C % 16 == 0 and Cout % 64 == 0 (a Cout that is not a multiple of 128
// computes zeros in the padded channels and does not store them); ragged H
// and W tiles are masked on store. Global offsets are 64-bit per image and
// channel step, 32-bit inside one (16 planes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // four warpgroups
constexpr int kTH = 4;         // output rows of a tile: one per warpgroup
constexpr int kTW = 64;        // output columns of a tile: the M of a wgmma
constexpr int kTCO = 128;      // output channels of a tile: the N of a wgmma
constexpr int kKC = 16;        // input channels staged per step: the K of a wgmma
constexpr int kStages = 4;
constexpr int kXRows = kTH + 2;
constexpr int kXCols = kTW + 2;
constexpr int kXPlane = kXRows * kXCols;   // pixels of a staged channel group
constexpr int kXItems = 2 * kXPlane;       // (channel group, pixel) pairs of a step
constexpr int kXPer = (kXItems + kThreads - 1) / kThreads;
constexpr int kWTap = kTCO * kKC * 2;      // bytes of one tap's B operand: 4 KB
constexpr int kWBytes = 9 * kWTap;         // a step's weight slab
constexpr int kXBytes = kXItems * 16;      // a step's input tile
constexpr int kStageBytes = kWBytes + kXBytes;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kBarBytes = 64;              // the stages' mbarriers, after the ring
constexpr int kOutStride = kTH * kTW + 4;  // f32 of a staged output channel row
static_assert(kWTap % 128 == 0 && kStageBytes % 128 == 0, "stages stay 128-byte aligned");
static_assert(kTCO * kOutStride * 4 <= kRingBytes, "the output tile fits in the ring");
static_assert((2 * kOutStride) % 32 == 8, "two channel rows are 8 banks apart");
static_assert(kTCO * kTH * kTW % (8 * kThreads) == 0, "the epilogue's runs split evenly");
static_assert(8 * kStages <= kBarBytes, "an mbarrier a stage");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// A stage's weights arrive by the bulk-copy engine and complete on an
// mbarrier: one arrival (the thread that asks for them) plus the bytes.
__device__ __forceinline__ void mbarrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbarrier_expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// the st.shared writes of this thread become visible to the tensor cores'
// own path (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A shared-memory matrix descriptor, K-major, no swizzle: start address, the
// bytes between core matrices along K (leading) and along M or N (stride),
// all in 16-byte units.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t k_bytes,
                                               uint32_t mn_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(k_bytes >> 4) << 16) |
         (static_cast<uint64_t>(mn_bytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// An empty statement that reads and writes the accumulators: the compiler
// can neither read them before a wait nor move them while a product is in
// flight.
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] += A[64 x 16] B[16 x 128], bf16 operands from shared memory,
// f32 accumulators, asynchronous.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f32(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// w [Cout][C][9] -> wt [C / 16][9][Coutp / 8][2][8][8]: element (c16, tap,
// n8, half, r, k) is w[n8 * 8 + r][c16 * 16 + half * 8 + k][tap], 0 for an
// output channel at or beyond Cout. One thread per 16-byte row (r) of a core
// matrix.
__global__ void __launch_bounds__(256)
repack_weights_bf16_kernel(const uint16_t* __restrict__ w, uint4* __restrict__ wt, int C,
                           int Cout, int Coutp) {
  const int64_t n8s = Coutp / 8;
  const int64_t total = static_cast<int64_t>(C / 16) * 9 * n8s * 16;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int r = static_cast<int>(idx % 8), half = static_cast<int>((idx / 8) % 2);
  const int64_t n8 = (idx / 16) % n8s;
  const int64_t tap = (idx / 16 / n8s) % 9;
  const int64_t c16 = idx / 16 / n8s / 9;
  const int64_t co = n8 * 8 + r, c = c16 * 16 + half * 8;
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (co < Cout) {
    const uint16_t* p = w + (co * C + c) * 9 + tap;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = static_cast<uint32_t>(p[(2 * i) * 9]) |
             (static_cast<uint32_t>(p[(2 * i + 1) * 9]) << 16);
  }
  wt[idx] = make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bf16_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ wt,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const float* __restrict__ cbias, const uint16_t* __restrict__ res,
                    uint16_t* __restrict__ out, int C, int Cout, int Coutp, int H, int W,
                    int tiles_w) {
  extern __shared__ __align__(128) uint8_t smem[];
  // after the ring: the stages' mbarriers, then (K6) this image's scale and bias
  const uint32_t full_bar = smem_addr(smem + kRingBytes);
  float* const scale_s = reinterpret_cast<float*>(smem + kRingBytes + kBarBytes);
  float* const bias_s = scale_s + C;

  const int co_tiles = Coutp / kTCO;
  const int co0 = (blockIdx.x % co_tiles) * kTCO;
  const int tile = blockIdx.x / co_tiles;
  const int h0 = (tile / tiles_w) * kTH;
  const int w0 = (tile % tiles_w) * kTW;
  const int64_t b = blockIdx.y;
  const int plane = H * W;
  const int64_t n8s = Coutp / 8;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;          // warpgroup: the tile row it owns
  const int warp = (tid >> 5) & 3;  // warp of the warpgroup: pixels 16 warp .. + 15
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if (tid == 0)
    for (int q = 0; q < kStages; ++q) mbarrier_init(full_bar + 8 * q);
  if (kFused) {
    for (int c = tid; c < C; c += kThreads) {
      scale_s[c] = scale[b * C + c];
      bias_s[c] = bias[b * C + c];
    }
  }

  // Staging of the input tile: item e = tid + i * kThreads is (channel group
  // e / kXPlane, staged pixel e % kXPlane) and lands at byte 16 e of the
  // stage's input tile. Where it comes from does not change from step to
  // step, so it is worked out once.
  int x_from[kXPer];
  unsigned inside = 0;
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int e = tid + i * kThreads;
    const int grp = e / kXPlane, pix = e - grp * kXPlane;
    const int r = pix / kXCols, col = pix - r * kXCols;
    const int gh = h0 - 1 + r, gw = w0 - 1 + col;
    x_from[i] = grp * 8 * plane + gh * W + gw;
    if (e < kXItems && gh >= 0 && gh < H && gw >= 0 && gw < W) inside |= 1u << i;
  }
  // step s's input tile: global -> registers (load_x), then -> K6's
  // prologue -> shared memory (store_x) a step later
  uint16_t raw[kXPer][8];
  auto load_x = [&](int s) {
    const uint16_t* from = x + (b * C + s * kKC) * static_cast<int64_t>(plane);
#pragma unroll
    for (int i = 0; i < kXPer; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        raw[i][k] = (inside >> i & 1u) ? from[x_from[i] + k * plane] : uint16_t(0);
  };
  auto store_x = [&](int s, uint8_t* dst) {
    const int c0 = s * kKC;
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads;
      if (e >= kXItems) continue;
      uint32_t v[4];
      if (kFused) {
        const int ch = c0 + (e / kXPlane) * 8;
        float f[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float a = __fadd_rn(__fmul_rn(lo_f32(raw[i][k]), scale_s[ch + k]), bias_s[ch + k]);
          a = __fdividef(a, 1.0f + __expf(-a));
          f[k] = (inside >> i & 1u) ? a : 0.0f;  // the SAME padding, after the swish
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = pack2(f[2 * k], f[2 * k + 1]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = static_cast<uint32_t>(raw[i][2 * k]) |
                 (static_cast<uint32_t>(raw[i][2 * k + 1]) << 16);
      }
      *reinterpret_cast<uint4*>(dst + 16 * e) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  // step s's weight slab for this block's 128 output channels, nine runs of
  // 4 KB, into stage q by the bulk-copy engine: asked for by thread 0,
  // waited for on the stage's mbarrier by every thread
  auto stage_w = [&](int s, int q) {
    const uint32_t bar = full_bar + 8 * q;
    mbarrier_expect_bytes(bar, kWBytes);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap)
      bulk_copy(smem_addr(smem + q * kStageBytes + tap * kWTap),
                wt + ((static_cast<int64_t>(s) * 9 + tap) * n8s + co0 / 8) * 16, kWTap, bar);
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // weights of steps 0 and 1 on their way, input of step 0 in shared memory,
  // of step 1 in registers
  const int steps = C / kKC;
  __syncthreads();  // the mbarriers; (K6) scale_s, bias_s
  if (tid == 0) {
    stage_w(0, 0);
    if (steps > 1) stage_w(1, 1);
  }
  load_x(0);
  store_x(0, smem + kWBytes);
  if (steps > 1) load_x(1);
  fence_proxy_async();
  __syncthreads();

  // this warpgroup's A operand in a stage: tile row wg, 64 pixels from
  // column 0; along M 128 bytes between core matrices, along K one staged
  // channel group
  const uint32_t ring = smem_addr(smem);
  const uint32_t a_row = kWBytes + wg * kXCols * 16;
  for (int s = 0; s < steps; ++s) {
    const int q = s % kStages;
    const uint32_t stage = ring + q * kStageBytes;
    mbarrier_wait(full_bar + 8 * q, (s / kStages) & 1);  // step s's weights have landed
    // step s + 2's weights into the stage step s - 2 read, asked for before
    // the products are issued (measured: asked for after them, the copies
    // came late)
    if (tid == 0 && s + 2 < steps) stage_w(s + 2, (s + 2) % kStages);
    wgmma_fence();
    hold(acc);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t a = stage + a_row + ((tap / 3) * kXCols + tap % 3) * 16;
      wgmma_m64n128k16(acc, descriptor(a, kXPlane * 16, 128),
                       descriptor(stage + tap * kWTap, 128, 256));
    }
    wgmma_commit();
    hold(acc);
    // step s + 1's input (its stage was last read by step s - 3) and step s
    // + 2's input values
    if (s + 1 < steps) store_x(s + 1, smem + ((s + 1) % kStages) * kStageBytes + kWBytes);
    if (s + 2 < steps) load_x(s + 2);
    wgmma_wait<1>();  // step s - 1 is done
    hold(acc);
    fence_proxy_async();
    __syncthreads();  // step s + 1 is staged; every warpgroup is past step s - 1
  }
  wgmma_wait<0>();
  hold(acc);
  __syncthreads();  // the ring is free

  // acc[4 j + i]: tile row wg, column 16 warp + g (+ 8 for i >= 2), output
  // channel co0 + 8 j + 2 t (+ 1 for odd i)
  float* const out_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kTCO / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out_s[(8 * j + 2 * t + (i & 1)) * kOutStride + wg * kTW + 16 * warp + g + 8 * (i >> 1)] =
          acc[4 * j + i];
  __syncthreads();

  // run u = tid + n * kThreads: 8 consecutive columns of one output channel
  // row; where the run lies in the output, and its residual, first
  constexpr int kRunsPer = kTCO * kTH * (kTW / 8) / kThreads;
  int64_t run_at[kRunsPer];
  uint4 run_res[kRunsPer];
#pragma unroll
  for (int n = 0; n < kRunsPer; ++n) {
    const int u = tid + n * kThreads;
    const int co_l = u / (kTH * kTW / 8), rem = u % (kTH * kTW / 8);
    const int row = rem / (kTW / 8), col = (rem % (kTW / 8)) * 8;
    const int co = co0 + co_l, h = h0 + row, wc = w0 + col;
    run_at[n] = co < Cout && h < H && wc < W
                    ? ((b * Cout + co) * H + h) * static_cast<int64_t>(W) + wc : -1;
    run_res[n] = make_uint4(0u, 0u, 0u, 0u);
    if (kFused && res != nullptr && run_at[n] >= 0 && wc + 8 <= W &&
        reinterpret_cast<uintptr_t>(res + run_at[n]) % 16 == 0)
      run_res[n] = *reinterpret_cast<const uint4*>(res + run_at[n]);
  }
#pragma unroll
  for (int n = 0; n < kRunsPer; ++n) {
    if (run_at[n] < 0) continue;
    const int u = tid + n * kThreads;
    const int co_l = u / (kTH * kTW / 8), rem = u % (kTH * kTW / 8);
    const int row = rem / (kTW / 8), col = (rem % (kTW / 8)) * 8;
    const int co = co0 + co_l, wc = w0 + col;
    const int64_t at = run_at[n];
    const float4* src = reinterpret_cast<const float4*>(out_s + co_l * kOutStride + row * kTW + col);
    const float4 p0 = src[0], p1 = src[1];
    float v[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const bool whole = wc + 8 <= W && reinterpret_cast<uintptr_t>(out + at) % 16 == 0;
    if (kFused) {
      const float cb = cbias[co];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] += cb;
      if (res != nullptr) {
        if (wc + 8 <= W && reinterpret_cast<uintptr_t>(res + at) % 16 == 0) {
          const uint32_t rw[4] = {run_res[n].x, run_res[n].y, run_res[n].z, run_res[n].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[2 * k] += lo_f32(rw[k]);
            v[2 * k + 1] += hi_f32(rw[k]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (wc + k < W) v[k] += lo_f32(res[at + k]);
        }
      }
    }
    if (whole) {
      *reinterpret_cast<uint4*>(out + at) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (wc + k < W) out[at + k] = static_cast<uint16_t>(pack2(v[k], 0.f));
    }
  }
}

int padded_cout(int Cout) { return (Cout + kTCO - 1) / kTCO * kTCO; }

cudaError_t repack(const void* w, void* wt, int C, int Cout, cudaStream_t stream) {
  if (C <= 0 || C % kKC != 0 || Cout <= 0 || Cout % 64 != 0 ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return cudaErrorInvalidValue;
  const int Coutp = padded_cout(Cout);
  const int64_t rows = static_cast<int64_t>(C) * 9 * Coutp / 8;  // 16-byte rows
  const int64_t blocks = (rows + 255) / 256;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  repack_weights_bf16_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const uint16_t*>(w), static_cast<uint4*>(wt), C, Cout, Coutp);
  return cudaGetLastError();
}

int launch(const void* x, const void* w, void* wt, const float* scale, const float* bias,
           const float* cbias, const void* res, void* out, int B, int C, int Cout, int H,
           int W, bool fused, cudaStream_t stream) {
  const int tiles_w = W > 0 ? (W + kTW - 1) / kTW : 0;
  const int64_t tiles_h = H > 0 ? (H + kTH - 1) / kTH : 0;
  const int Coutp = padded_cout(Cout);
  const int64_t blocks = tiles_h * tiles_w * (Coutp / kTCO);
  const size_t smem = kRingBytes + kBarBytes + (fused ? 2 * sizeof(float) * C : 0);
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || blocks > 2147483647LL ||
      static_cast<int64_t>(kKC) * H * W > 2147483647LL ||  // staging offsets are int
      smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = repack(w, wt, C, Cout, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  const uint16_t* xt = static_cast<const uint16_t*>(x);
  const uint4* wtt = static_cast<const uint4*>(wt);
  uint16_t* ot = static_cast<uint16_t*>(out);
  if (fused) {
    e = cudaFuncSetAttribute(conv3x3_bf16_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    conv3x3_bf16_kernel<true><<<grid, kThreads, smem, stream>>>(
        xt, wtt, scale, bias, cbias, static_cast<const uint16_t*>(res), ot, C, Cout, Coutp, H,
        W, tiles_w);
  } else {
    e = cudaFuncSetAttribute(conv3x3_bf16_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    conv3x3_bf16_kernel<false><<<grid, kThreads, smem, stream>>>(
        xt, wtt, nullptr, nullptr, nullptr, nullptr, ot, C, Cout, Coutp, H, W, tiles_w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w [Cout, C, 3, 3] bf16 -> wt: the B operands as the kernels read them,
// C * 9 * Coutp bf16 (Coutp: Cout rounded up to 128), 16-byte aligned.
// Needs C % 16 == 0 and Cout % 64 == 0. Returns the cudaError_t of the launch.
extern "C" int dcvic_repack_weights_bf16(const void* w, void* wt, int C, int Cout,
                                         void* stream) {
  return static_cast<int>(repack(w, wt, C, Cout, static_cast<cudaStream_t>(stream)));
}

// x [B, C, H, W], w [Cout, C, 3, 3], out [B, Cout, H, W]: contiguous bf16
// device memory. wt: scratch for the repacked weights, as above. Needs C % 16
// == 0 and Cout % 64 == 0. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int dcvic_conv3x3_same_bf16(const void* x, const void* w, void* wt, void* out,
                                       int B, int C, int Cout, int H, int W, void* stream) {
  return launch(x, w, wt, nullptr, nullptr, nullptr, nullptr, out, B, C, Cout, H, W, false,
                static_cast<cudaStream_t>(stream));
}

// As above, plus scale, bias [B, C] f32, cbias [Cout] f32 and res
// [B, Cout, H, W] bf16, or null for no residual.
extern "C" int dcvic_conv3x3_gn_swish_bf16(const void* x, const void* w, void* wt,
                                           const float* scale, const float* bias,
                                           const float* cbias, const void* res, void* out,
                                           int B, int C, int Cout, int H, int W,
                                           void* stream) {
  return launch(x, w, wt, scale, bias, cbias, res, out, B, C, Cout, H, W, true,
                static_cast<cudaStream_t>(stream));
}
