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
// the conv is 464 GFLOP against 1.6 GB of traffic, so the f32 FFMA rate
// (67 TFLOP/s) is the limit, not memory. This first version stays on FFMA;
// tensor cores (a TF32 split or bf16 wgmma) are for a later change.
//
// Design. The tensors are NCHW and OIHW as the port keeps them. A block of
// 256 threads owns an output tile of 8 rows x 32 columns x 64 output
// channels and loops over the input channels 8 at a time. Per step it stages
// in shared memory the haloed input tile [8][10][34] (zero outside the
// image) and the weight slab [8 * 9][64]; 30 KB in all, so two blocks fit an
// SM and one block's loads overlap the other's arithmetic. The TPU kernel's
// double-buffered DMA ring and its slot parity are pipeline mechanics of
// that machine and were not carried over. Each thread keeps an 8-pixel x
// 8-channel register tile (64 f32 accumulators): per input channel and
// kernel row it reads 3 + 6 16-byte words from shared memory for 192 FFMAs.
// The 8 channels of a thread are two groups of 4, 32 apart, so that the
// eight channel-threads of a warp read one contiguous 128-byte line of the
// slab (no bank conflict) while the four pixel-threads read four distinct
// bank groups of the input rows.
//
// Weights arrive OIHW; a small kernel first repacks them to [C][3][3][Cout]
// f32 in scratch memory the caller provides, so that the slab loads are
// contiguous 16-byte reads. K6's prologue runs where the input tile is
// written to shared memory: v = x * scale + bias, v = v * sigmoid(v) for
// positions inside the image and a literal 0 outside, which is the whole of
// the TPU kernel's "re-zero the halo" step. The sum over input channels runs
// in one thread in a fixed order (no split over channels, no atomics), so the
// output has the same bits on every run. All global offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8;         // output rows of a tile
constexpr int kTW = 32;        // output columns of a tile
constexpr int kTCO = 64;       // output channels of a tile
constexpr int kKC = 8;         // input channels staged per step
constexpr int kXRows = kTH + 2;
constexpr int kXCols = kTW + 2;
constexpr int kXStride = 36;   // row stride of the staged input: 16-byte aligned rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// v rounded to T and back: the working type of the normalised activations.
template <typename T> __device__ __forceinline__ float round_as(float v) {
  if (std::is_same<T, float>::value) return v;
  return __bfloat162float(__float2bfloat16(v));
}

// w [Cout][C][9] (T) -> wt [C][9][Cout] (f32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
repack_weights_kernel(const T* __restrict__ w, float* __restrict__ wt, int C, int Cout) {
  const int64_t rows = static_cast<int64_t>(C) * 9;
  const int64_t total = rows * Cout;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t co = idx % Cout, r = idx / Cout;
  wt[idx] = to_f32(w[co * rows + r]);
}

template <typename T, bool kFused>
__device__ __forceinline__ void conv_tile(
    const T* __restrict__ x, const float* __restrict__ wt,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ cbias, const T* __restrict__ res,
    T* __restrict__ out, int C, int Cout, int H, int W, int tiles_w, int vec_ok) {
  __shared__ __align__(16) float x_s[kKC][kXRows][kXStride];
  __shared__ __align__(16) float w_s[kKC * 9][kTCO];

  const int co_chunks = Cout / kTCO;
  const int co0 = (blockIdx.x % co_chunks) * kTCO;
  const int tile = blockIdx.x / co_chunks;
  const int h0 = (tile / tiles_w) * kTH;
  const int w0 = (tile % tiles_w) * kTW;
  const int64_t b = blockIdx.y;
  const int64_t plane = static_cast<int64_t>(H) * W;

  const int tid = threadIdx.x;
  const int cg = tid & 7;          // channel group: channels cg*4.. and 32+cg*4..
  const int tg = (tid >> 3) & 3;   // pixel group: columns tg*8 .. tg*8+7
  const int ty = tid >> 5;         // row of the tile (the warp index)

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // the previous step's reads are done
    for (int e = tid; e < kKC * kXRows * kXCols; e += kThreads) {
      const int c = e / (kXRows * kXCols);
      const int rem = e - c * (kXRows * kXCols);
      const int r = rem / kXCols;
      const int col = rem - r * kXCols;
      const int gh = h0 - 1 + r, gw = w0 - 1 + col;
      float v = 0.f;  // the SAME padding, in the space the conv reads
      if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
        const int64_t ch = b * C + c0 + c;
        v = to_f32(x[ch * plane + static_cast<int64_t>(gh) * W + gw]);
        if (kFused) {
          v = __fadd_rn(__fmul_rn(v, scale[ch]), bias[ch]);
          v = round_as<T>(v * (1.0f / (1.0f + expf(-v))));
        }
      }
      x_s[c][r][col] = v;
    }
    for (int e = tid; e < kKC * 9 * (kTCO / 4); e += kThreads) {
      const int r = e / (kTCO / 4), q = e % (kTCO / 4);
      const float4 v = *reinterpret_cast<const float4*>(
          wt + (static_cast<int64_t>(c0) * 9 + r) * Cout + co0 + q * 4);
      *reinterpret_cast<float4*>(&w_s[r][q * 4]) = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kKC; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float4* xr = reinterpret_cast<const float4*>(&x_s[c][ty + dy][tg * 8]);
        const float4 x0 = xr[0], x1 = xr[1], x2 = xr[2];
        const float xin[10] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w,
                               x2.x, x2.y};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wrow = w_s[c * 9 + dy * 3 + dx];
          const float4 wa = *reinterpret_cast<const float4*>(wrow + cg * 4);
          const float4 wb = *reinterpret_cast<const float4*>(wrow + 32 + cg * 4);
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const float xv = xin[p + dx];
            acc[p][0] = fmaf(xv, wa.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wa.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wa.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wa.w, acc[p][3]);
            acc[p][4] = fmaf(xv, wb.x, acc[p][4]);
            acc[p][5] = fmaf(xv, wb.y, acc[p][5]);
            acc[p][6] = fmaf(xv, wb.z, acc[p][6]);
            acc[p][7] = fmaf(xv, wb.w, acc[p][7]);
          }
        }
      }
    }
  }

  const int h = h0 + ty;
  if (h >= H) return;
  const int wbase = w0 + tg * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + (j - 4));
    const int64_t row = ((b * Cout + co) * H + h) * static_cast<int64_t>(W);
    float v[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) v[p] = acc[p][j];
    if (kFused) {
      const float cb = cbias[co];
#pragma unroll
      for (int p = 0; p < 8; ++p) v[p] += cb;
      if (res != nullptr) {
#pragma unroll
        for (int p = 0; p < 8; ++p)
          if (wbase + p < W) v[p] += to_f32(res[row + wbase + p]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int wq = wbase + half * 4;
      if (std::is_same<T, float>::value && vec_ok && wq + 3 < W) {
        *reinterpret_cast<float4*>(out + row + wq) =
            make_float4(v[half * 4], v[half * 4 + 1], v[half * 4 + 2], v[half * 4 + 3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (wq + p < W) from_f32(out + row + wq + p, v[half * 4 + p]);
      }
    }
  }
}

// ---------------------------------------------------------------- K5
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_same_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                    T* __restrict__ out, int C, int Cout, int H, int W,
                    int tiles_w, int vec_ok) {
  conv_tile<T, false>(x, wt, nullptr, nullptr, nullptr, nullptr, out, C, Cout, H, W,
                      tiles_w, vec_ok);
}

// ---------------------------------------------------------------- K6
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_gn_swish_kernel(const T* __restrict__ x, const float* __restrict__ wt,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        const float* __restrict__ cbias, const T* __restrict__ res,
                        T* __restrict__ out, int C, int Cout, int H, int W,
                        int tiles_w, int vec_ok) {
  conv_tile<T, true>(x, wt, scale, bias, cbias, res, out, C, Cout, H, W, tiles_w,
                     vec_ok);
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
         Cout % kTCO == 0 && H > 0 && W > 0;
  if (!g.ok) return g;
  g.tiles_w = (W + kTW - 1) / kTW;
  const int64_t tiles_h = (H + kTH - 1) / kTH;
  const int64_t blocks = tiles_h * g.tiles_w * (Cout / kTCO);
  const int64_t repack = (static_cast<int64_t>(C) * 9 * Cout + kThreads - 1) / kThreads;
  g.ok = blocks <= 2147483647LL && repack <= 2147483647LL;
  g.grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  g.repack_blocks = static_cast<int>(repack);
  return g;
}

template <typename T>
int launch(const void* x, const void* w, float* wt, const float* scale,
           const float* bias, const float* cbias, const void* res, void* out,
           int B, int C, int Cout, int H, int W, bool fused, cudaStream_t stream) {
  const Geometry g = geometry(B, C, Cout, H, W);
  if (!g.ok) return static_cast<int>(cudaErrorInvalidValue);
  repack_weights_kernel<T><<<g.repack_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(w), wt, C, Cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec_ok = W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (fused)
    conv3x3_gn_swish_kernel<T><<<g.grid, kThreads, 0, stream>>>(
        xt, wt, scale, bias, cbias, static_cast<const T*>(res), ot, C, Cout, H, W,
        g.tiles_w, vec_ok);
  else
    conv3x3_same_kernel<T><<<g.grid, kThreads, 0, stream>>>(
        xt, wt, ot, C, Cout, H, W, g.tiles_w, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, C, H, W], w [Cout, C, 3, 3], out [B, Cout, H, W]: contiguous device
// memory of one type, f32 (dtype 0) or bf16 (dtype 1). wt: scratch of
// C * 9 * Cout floats, 16-byte aligned. Needs C % 8 == 0 and Cout % 64 == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dcvic_conv3x3_same(const void* x, const void* w, float* wt, void* out,
                                  int B, int C, int Cout, int H, int W, int dtype,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, wt, nullptr, nullptr, nullptr, nullptr, out, B, C, Cout,
                         H, W, false, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, wt, nullptr, nullptr, nullptr, nullptr, out, B, C,
                                 Cout, H, W, false, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, plus scale, bias [B, C] f32, cbias [Cout] f32 and res
// [B, Cout, H, W] of x's type, or null for no residual.
extern "C" int dcvic_conv3x3_gn_swish(const void* x, const void* w, float* wt,
                                      const float* scale, const float* bias,
                                      const float* cbias, const void* res, void* out,
                                      int B, int C, int Cout, int H, int W, int dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, wt, scale, bias, cbias, res, out, B, C, Cout, H, W, true, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, wt, scale, bias, cbias, res, out, B, C, Cout, H, W,
                                 true, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
