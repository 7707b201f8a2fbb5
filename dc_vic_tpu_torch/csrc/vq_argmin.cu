// Nearest-codeword search for the VQGAN quantizer (kernel K1).
//
// Replaces the TPU kernel dc_vic_tpu/ops/vq.py::_vq_kernel (launched by
// _vq_argmin_pallas through pl.pallas_call): for each row z of the latent it
// returns argmin_n(||e_n||^2 - 2 z.e_n) over a codebook [N, 4], the first
// minimum winning ties.
//
// What bounds it on Hopper: the f32 pipe. A (row, codeword) pair is four
// multiply-adds of the cross term and the norm's share; the bytes (16 a row
// in, 4 out) are far fewer. At the contract's M = 98,304 rows (batch 16 of
// 768x512 at stride 8) against N = 256 that is 25 M pairs: 3.76 us at
// 67 TFLOP/s counting 10 operations a pair, against 0.6 us for the bytes.
// The TPU kernel fed the cross term through the MXU because its vector unit
// is narrow; here the product is too thin (K = 4) for the tensor cores.
//
// Design:
// * The codebook and its squared norms go to shared memory once per block
//   (N * 20 bytes, up to 11,622 entries in the 227 KB).
// * kG = 4 lanes share a row. Lane g scans the codewords n = g, g + kG,
//   g + 2 kG, ... in ascending order with a strict '<', so it keeps the lowest
//   index among its own minima. The lanes of a row read neighbouring
//   codewords, which shared memory serves without bank conflicts; the rows of
//   a warp read the same ones, a broadcast. The kG candidates meet in a
//   butterfly of shuffles that keeps the smaller distance and, on an exact
//   tie, the lower index, so the first minimum of the whole codebook wins, as
//   torch.argmin and jnp.argmin have it.
// * Each thread holds R rows (R = 4, 2 or 1: the most that still gives every
//   SM two blocks, chosen by the caller), so one shared-memory read of a
//   codeword serves R rows. A lane reads kAhead codewords before it uses the
//   first, so their latency overlaps.
// * -2 is folded into z once (exact: a power of two). A pair then costs four
//   FFMAs from ||e||^2, a compare and two selects.
// * The latent is read where it lies, through strides: component d of row
//   m = b HW + hw sits at b sb + d sd + hw shw. The NCHW quantizer input
//   [B, 4, H, W] has sb = 4 HW, sd = HW, shw = 1, so each component is a
//   coalesced load across the rows of a warp and no permuted copy is made;
//   flat rows [M, 4] are B = 1, HW = M, sd = 1, shw = 4.
// The ragged tail of M and a codebook whose size is not a multiple of kG are
// masked. Every product is an explicit fmaf, so the result does not depend on
// the compiler's contraction of a * b + c.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kG = 4;                     // lanes a row
constexpr int kGroups = kThreads / kG;    // rows a block holds at once, per R
constexpr int kAhead = 8;                 // codewords a lane reads from shared memory at once

// One codeword n (e, ||e||^2 = s) against the thread's R rows: the distance
// from ||e||^2 by four FFMAs, kept where it is strictly smaller.
template <int R>
__device__ __forceinline__ void scan(float4 e, float s, int n, const float4 (&zr)[R],
                                     float (&best)[R], int (&best_n)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float d = fmaf(zr[r].x, e.x, s);
    d = fmaf(zr[r].y, e.y, d);
    d = fmaf(zr[r].z, e.z, d);
    d = fmaf(zr[r].w, e.w, d);
    if (d < best[r]) {
      best[r] = d;
      best_n[r] = n;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                 int* __restrict__ idx, int M, int N, int HW,
                 long long sb, long long sd, long long shw) {
  extern __shared__ float4 smem4[];
  float4* cb_s = smem4;                                   // [N] codewords
  float* sq_s = reinterpret_cast<float*>(smem4 + N);      // [N] ||e||^2
  const int g = threadIdx.x % kG;
  const int row0 = blockIdx.x * (kGroups * R) + threadIdx.x / kG;

  // this thread's rows, loaded before the codebook copy so the two overlap
  float4 zr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = row0 + r * kGroups;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < M) {
      const int b = m / HW;
      const float* p = z + b * sb + static_cast<long long>(m - b * HW) * shw;
      v = make_float4(p[0], p[sd], p[2 * sd], p[3 * sd]);
    }
    zr[r] = make_float4(-2.f * v.x, -2.f * v.y, -2.f * v.z, -2.f * v.w);
  }
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float4 e = make_float4(cb[4 * n], cb[4 * n + 1], cb[4 * n + 2], cb[4 * n + 3]);
    cb_s[n] = e;
    float s = __fmul_rn(e.x, e.x);
    s = fmaf(e.y, e.y, s);
    s = fmaf(e.z, e.z, s);
    s = fmaf(e.w, e.w, s);
    sq_s[n] = s;
  }
  __syncthreads();

  float best[R];
  int best_n[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = INFINITY;
    best_n[r] = g;
  }
  const int full = N / kG;                // rounds in which every lane has a codeword
  int k = 0;
  for (; k + kAhead <= full; k += kAhead) {
    float4 e[kAhead];                     // kAhead rounds' codewords, read before any is used
    float s[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      e[u] = cb_s[(k + u) * kG + g];
      s[u] = sq_s[(k + u) * kG + g];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) scan<R>(e[u], s[u], (k + u) * kG + g, zr, best, best_n);
  }
  for (; k < full; ++k) {
    const int n = k * kG + g;
    scan<R>(cb_s[n], sq_s[n], n, zr, best, best_n);
  }
  const int n = full * kG + g;            // the ragged last round
  if (n < N) scan<R>(cb_s[n], sq_s[n], n, zr, best, best_n);

  // butterfly over the kG lanes of a row: smaller distance, then lower index
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float od = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int on = __shfl_xor_sync(0xffffffffu, best_n[r], off);
      if (od < best[r] || (od == best[r] && on < best_n[r])) {
        best[r] = od;
        best_n[r] = on;
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = row0 + r * kGroups;
      if (m < M) idx[m] = best_n[r];
    }
  }
}

template <int R>
int launch(const float* z, const float* cb, int* idx, int M, int N, int HW, long long sb,
           long long sd, long long shw, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N) * (sizeof(float4) + sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vq_argmin_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows = kGroups * R;
  vq_argmin_kernel<R><<<(M + rows - 1) / rows, kThreads, smem, stream>>>(
      z, cb, idx, M, N, HW, sb, sd, shw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The latent z: M = B * HW rows of 4 f32 components, component d of row
// m = b HW + hw at z[b sb + d sd + hw shw]; cb [N, 4] f32 contiguous; idx [M]
// int32. R (1, 2 or 4) rows a thread. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int dcvic_vq_argmin(const float* z, const float* cb, int* idx, int M, int N,
                               int HW, long long sb, long long sd, long long shw, int R,
                               void* stream) {
  if (M <= 0 || N <= 0 || HW <= 0 || M % HW) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return launch<1>(z, cb, idx, M, N, HW, sb, sd, shw, s);
    case 2: return launch<2>(z, cb, idx, M, N, HW, sb, sd, shw, s);
    case 4: return launch<4>(z, cb, idx, M, N, HW, sb, sd, shw, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
