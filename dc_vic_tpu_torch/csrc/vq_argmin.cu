// Nearest-codeword search for the VQGAN quantizer (kernel K1).
//
// Replaces the TPU kernel dc_vic_tpu/ops/vq.py::_vq_kernel (launched by
// _vq_argmin_pallas through pl.pallas_call): for each row z of [M, D] it
// returns argmin_n(||e_n||^2 - 2 z.e_n) over a codebook [N, D], the first
// minimum winning ties.
//
// What bounds it on Hopper: almost nothing. At the main path's shapes
// (M = 24,576 rows for four 768x512 images, N = 256, D = 4) the work is
// 25 MFMA and 0.5 MB of traffic, so the call is launch-bound. The TPU kernel
// fed the cross term through the MXU because its vector unit is narrow; here
// the matrix product is too thin (K = 4) for tensor cores to matter.
//
// Design: the codebook and its squared norms live in shared memory
// (N * (D + 1) floats, 5 KB at N = 256), copied once per block. One thread
// owns one row, keeps z in registers, and scans n in ascending order with a
// strict '<', so the lowest index wins a tie exactly as torch.argmin and
// jnp.argmin do. Every thread of a warp reads the same codeword at each step,
// which shared memory serves as a broadcast. The ragged tail of M is masked.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kD = 4;  // the VQGAN f8-n256 embed_dim; the wrapper rejects others

__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                 int* __restrict__ idx, int M, int N) {
  extern __shared__ float4 smem4[];
  float4* cb_s = smem4;                                   // [N] codewords
  float* sq_s = reinterpret_cast<float*>(smem4 + N);      // [N] ||e||^2
  const float4* cb4 = reinterpret_cast<const float4*>(cb);
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float4 e = cb4[n];
    cb_s[n] = e;
    float s = e.x * e.x;
    s = fmaf(e.y, e.y, s);
    s = fmaf(e.z, e.z, s);
    s = fmaf(e.w, e.w, s);
    sq_s[n] = s;
  }
  __syncthreads();

  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= M) return;
  const float4 zr = reinterpret_cast<const float4*>(z)[row];
  float best = INFINITY;
  int best_n = 0;
  for (int n = 0; n < N; ++n) {
    const float4 e = cb_s[n];
    float cross = zr.x * e.x;
    cross = fmaf(zr.y, e.y, cross);
    cross = fmaf(zr.z, e.z, cross);
    cross = fmaf(zr.w, e.w, cross);
    const float dist = sq_s[n] - 2.0f * cross;
    if (dist < best) {
      best = dist;
      best_n = n;
    }
  }
  idx[row] = best_n;
}

}  // namespace

// z [M, 4] f32, cb [N, 4] f32, idx [M] int32, all contiguous device memory.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dcvic_vq_argmin(const float* z, const float* cb, int* idx,
                               int M, int N, int D, void* stream) {
  if (D != kD || M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(N) * (sizeof(float4) + sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vq_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (M + kThreads - 1) / kThreads;
  vq_argmin_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      z, cb, idx, M, N);
  return static_cast<int>(cudaGetLastError());
}
