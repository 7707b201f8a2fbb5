// GroupNorm statistics and affine for the reconstruction stacks (kernels K3
// and K4).
//
// K3 gn_channel_sums replaces the TPU kernel
// dc_vic_tpu/ops/gn.py::_gn_stats_kernel (launched by channel_sums through
// pl.pallas_call): per (image, channel) f32 [sum x, sum x^2] over the plane,
// x [B, C, H, W] -> [B, 2, C].
// K4 gn_apply replaces dc_vic_tpu/ops/gn.py::_gn_apply_kernel (launched by
// _apply_affine): act(x * scale[b, c] + bias[b, c]) computed in f32 and cast
// back to x's type, act in {none, swish}.
//
// What bounds them on Hopper: bytes. K3 reads the plane once (3 flops per
// element), K4 reads and writes it once; at [4, 128, 768, 512] f32 that is
// 0.8 GB and 1.6 GB against 3.35 TB/s. The design only has to keep enough
// 16-byte loads in flight.
//
// Design. The port is NCHW, so a channel's plane is contiguous: the TPU
// kernel's lane-preserving reduce and its [8, C] sublane padding have no
// counterpart. K3 gives one block to each (b, c) plane: 16-byte loads,
// unrolled four deep, two f32 partials per thread, a warp-shuffle tree, one
// shared-memory stage across the warps. One block per plane and a fixed tree
// mean no atomics: the sums have the same bits on every run. K4 gives a
// plane to blockIdx.x and strides over it with blockIdx.y, so scale and bias
// are two scalar loads per block. Both fall back to scalar loads when the
// plane size or the base pointer does not allow 16-byte accesses (a ragged
// plane). All offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T: 4 floats or 8 bf16 values.
template <typename T> struct alignas(16) Vec16 {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__device__ __forceinline__ Vec16<T> load16(const T* p) {
  Vec16<T> out;
  *reinterpret_cast<uint4*>(out.v) = *reinterpret_cast<const uint4*>(p);
  return out;
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const Vec16<T>& val) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(val.v);
}

// ---------------------------------------------------------------- K3

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_channel_sums_kernel(const T* __restrict__ x, float* __restrict__ out,
                       int C, int64_t HW, int vec_ok) {
  constexpr int kN = Vec16<T>::kN;
  const int64_t plane = blockIdx.x;            // b * C + c
  const T* xp = x + plane * HW;
  float s = 0.f, s2 = 0.f;
  if (vec_ok) {
    const int64_t nvec = HW / kN;
    int64_t i = threadIdx.x;
    // four independent 16-byte loads in flight per thread
    for (; i + 3 * kThreads < nvec; i += 4 * kThreads) {
      Vec16<T> v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = load16(xp + (i + u * kThreads) * kN);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float f = to_f32(v[u].v[j]);
          s += f;
          s2 = fmaf(f, f, s2);
        }
      }
    }
    for (; i < nvec; i += kThreads) {
      const Vec16<T> v = load16(xp + i * kN);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float f = to_f32(v.v[j]);
        s += f;
        s2 = fmaf(f, f, s2);
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < HW; i += kThreads) {
      const float f = to_f32(xp[i]);
      s += f;
      s2 = fmaf(f, f, s2);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  __shared__ float part[2][kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = s;
    part[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, a2 = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      a += part[0][w];
      a2 += part[1][w];
    }
    const int64_t b = plane / C, c = plane % C;
    out[(b * 2 + 0) * C + c] = a;
    out[(b * 2 + 1) * C + c] = a2;
  }
}

// ---------------------------------------------------------------- K4

// The affine is a rounded multiply and a rounded add (no fused
// multiply-add), so it has the bits of the two PyTorch operations of the
// plain version.
template <bool kSwish>
__device__ __forceinline__ float affine_act(float x, float scale, float bias) {
  float y = __fadd_rn(__fmul_rn(x, scale), bias);
  if (kSwish) y = y * (1.0f / (1.0f + expf(-y)));
  return y;
}

template <typename T, bool kSwish>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ out,
                int64_t HW, int vec_ok) {
  constexpr int kN = Vec16<T>::kN;
  const int64_t plane = blockIdx.x;            // b * C + c
  const float sc = scale[plane], bi = bias[plane];
  const T* xp = x + plane * HW;
  T* op = out + plane * HW;
  const int64_t start = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.y) * kThreads;
  if (vec_ok) {
    const int64_t nvec = HW / kN;
    for (int64_t i = start; i < nvec; i += step) {
      Vec16<T> v = load16(xp + i * kN);
#pragma unroll
      for (int j = 0; j < kN; ++j)
        from_f32(&v.v[j], affine_act<kSwish>(to_f32(v.v[j]), sc, bi));
      store16(op + i * kN, v);
    }
  } else {
    for (int64_t i = start; i < HW; i += step)
      from_f32(op + i, affine_act<kSwish>(to_f32(xp[i]), sc, bi));
  }
}

template <typename T>
int vec16_ok(const void* a, const void* b, int64_t HW) {
  constexpr int kN = 16 / sizeof(T);
  return HW % kN == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
int launch_sums(const void* x, float* out, int B, int C, int64_t HW,
                cudaStream_t stream) {
  gn_channel_sums_kernel<T><<<static_cast<unsigned>(B) * C, kThreads, 0, stream>>>(
      static_cast<const T*>(x), out, C, HW, vec16_ok<T>(x, x, HW));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* x, const float* scale, const float* bias, void* out,
                 int B, int C, int64_t HW, int swish, cudaStream_t stream) {
  constexpr int kN = 16 / sizeof(T);
  const int vec = vec16_ok<T>(x, out, HW);
  const int64_t items = vec ? HW / kN : HW;
  // up to four items per thread along the plane
  int64_t chunks = (items + 4 * kThreads - 1) / (4 * kThreads);
  if (chunks < 1) chunks = 1;
  if (chunks > 65535) chunks = 65535;
  const dim3 grid(static_cast<unsigned>(B) * C, static_cast<unsigned>(chunks));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (swish)
    gn_apply_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, scale, bias, ot, HW, vec);
  else
    gn_apply_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, scale, bias, ot, HW, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, C, HW] contiguous device memory, f32 (dtype 0) or bf16 (dtype 1);
// out [B, 2, C] f32. Returns the cudaError_t of the launch (0 on success).
extern "C" int dcvic_gn_channel_sums(const void* x, float* out, int B, int C,
                                     long long HW, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || static_cast<long long>(B) * C > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_sums<float>(x, out, B, C, HW, s);
  if (dtype == 1) return launch_sums<__nv_bfloat16>(x, out, B, C, HW, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, out [B, C, HW] contiguous, f32 (dtype 0) or bf16 (dtype 1); scale, bias
// [B, C] f32; swish != 0 applies y * sigmoid(y) after the affine.
extern "C" int dcvic_gn_apply(const void* x, const float* scale, const float* bias,
                              void* out, int B, int C, long long HW, int dtype,
                              int swish, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || static_cast<long long>(B) * C > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_apply<float>(x, scale, bias, out, B, C, HW, swish, s);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(x, scale, bias, out, B, C, HW, swish, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
