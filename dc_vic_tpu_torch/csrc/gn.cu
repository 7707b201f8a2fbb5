// GroupNorm statistics and affine for the reconstruction stacks (kernels K3
// and K4, and the fused residual block's statistics gn_fold).
//
// K3 gn_channel_sums replaces the TPU kernel
// dc_vic_tpu/ops/gn.py::_gn_stats_kernel (launched by channel_sums through
// pl.pallas_call): per (image, channel) f32 [sum x, sum x^2] over the plane,
// x [B, C, H, W] -> [B, 2, C].
// K4 gn_apply replaces dc_vic_tpu/ops/gn.py::_gn_apply_kernel (launched by
// _apply_affine): act(x * scale[b, c] + bias[b, c]) computed in f32 and cast
// back to x's type, act in {none, swish}.
// gn_fold replaces no TPU kernel: it is the fused residual block's GroupNorm
// statistics (dc_vic_tpu/models/vqgan.py:61 _gn_fold), which XLA fuses into
// reductions that never store an f32 map. Per (image, group) the mean and the
// two-pass variance (the mean of squared deviations from the group mean, not
// E[x^2] - E[x]^2), folded with gamma and beta into the per-(image, channel)
// affine scale = gamma * rsqrt(var + eps), bias = beta - mean * scale that
// kernel K6 (conv3x3_gn_swish) takes.
//
// What bounds them on Hopper: bytes. K3 reads the plane once (3 flops per
// element), K4 reads and writes it once; at [4, 128, 768, 512] f32 that is
// 0.8 GB and 1.6 GB against 3.35 TB/s. gn_fold reads the map once: 2 bytes an
// element in bf16, 4 in f32. The design only has to keep enough 16-byte loads
// in flight.
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
//
// gn_fold: in a row-major map the group g of image b is one contiguous run of
// n = (C / G) * H * W elements. It is cut into chunks of 128 KB (a function of
// n and the type alone, never of B), one block each, so the grid is B * G *
// chunks blocks and the card fills at batch 1 too. Each element is read from
// device memory once, with four 16-byte loads a thread in flight. A thread
// takes the exact two-pass moments of the values it holds in registers (their
// mean, then their squared deviations from it) and merges (count, mean, M2)
// triples by Chan's formula, M2 = M2a + M2b + d^2 na nb / n: across its
// rounds, then down a shuffle tree in the warp, then across the warps, then,
// in the last block of the group to finish, across the group's chunks in
// index order. That block learns it is last from an atomic ticket on a
// per-group counter, which it sets back to 0, and writes the group's C / G
// scales and biases in the same launch. Every merge runs in a fixed order and
// no float is added atomically, so image k's outputs have the same bits at
// any batch size and on every run.
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

// ------------------------------------------------------------- gn_fold

constexpr int kFoldLoads = 4;    // 16-byte loads a thread has in flight
constexpr int kFoldRounds = 8;   // rounds of them a thread makes over a chunk

// Elements of a chunk: 128 KB of x.
template <typename T>
__host__ __device__ constexpr int64_t fold_chunk() {
  return static_cast<int64_t>(kThreads) * kFoldLoads * kFoldRounds * (16 / sizeof(T));
}

// Count, mean and sum of squared deviations from the mean.
template <typename N> struct Moments {
  N n;
  float mean, m2;
};

// Chan's merge of two partial moments; a is the earlier part.
template <typename N>
__device__ __forceinline__ Moments<N> merge(const Moments<N>& a, const Moments<N>& b) {
  if (b.n == 0) return a;
  if (a.n == 0) return b;
  const N n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float wb = static_cast<float>(b.n) / static_cast<float>(n);
  return {n, fmaf(d, wb, a.mean), a.m2 + b.m2 + d * d * (static_cast<float>(a.n) * wb)};
}

template <typename N>
__device__ __forceinline__ Moments<N> shfl_down(const Moments<N>& m, int off) {
  return {__shfl_down_sync(0xffffffffu, m.n, off), __shfl_down_sync(0xffffffffu, m.mean, off),
          __shfl_down_sync(0xffffffffu, m.m2, off)};
}

// The block's moments, in thread 0: a shuffle tree in each warp (lane i
// takes lane i + off), then warp 0 over the warps in order.
template <typename N>
__device__ Moments<N> block_moments(Moments<N> m, Moments<N>* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = merge(m, shfl_down(m, off));
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? part[lane] : Moments<N>{0, 0.f, 0.f};
#pragma unroll
    for (int off = kThreads / 64; off > 0; off >>= 1) m = merge(m, shfl_down(m, off));
  }
  return m;
}

// A thread's moments over its share of the elements [begin, end) of the
// group at xg: rounds of kFoldLoads 16-byte loads (kVec), or of as many
// elements one by one, neighbouring threads on neighbouring addresses.
template <typename T, bool kVec>
__device__ Moments<int> thread_moments(const T* __restrict__ xg, int64_t begin, int64_t end) {
  constexpr int kPer = kVec ? Vec16<T>::kN : 1;                 // values a load
  constexpr int kLoads = kFoldLoads * (Vec16<T>::kN / kPer);    // loads a round
  const int64_t i1 = end / kPer;
  Moments<int> acc{0, 0.f, 0.f};
  for (int64_t i = begin / kPer + threadIdx.x; i < i1;
       i += static_cast<int64_t>(kLoads) * kThreads) {
    float v[kLoads][kPer];
    int loaded = 0;                    // the loads in range are a prefix
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int64_t k = i + static_cast<int64_t>(u) * kThreads;
      if (k < i1) {
        if constexpr (kVec) {
          const Vec16<T> w = load16(xg + k * kPer);
#pragma unroll
          for (int j = 0; j < kPer; ++j) v[u][j] = to_f32(w.v[j]);
        } else {
          v[u][0] = to_f32(xg[k]);
        }
        loaded = u + 1;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (u < loaded) {
        float su = 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) su += v[u][j];
        s += su;
      }
    }
    const int cnt = loaded * kPer;
    const float mean = s / static_cast<float>(cnt);
    float m2 = 0.f;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (u < loaded) {
        float mu = 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float d = v[u][j] - mean;
          mu = fmaf(d, d, mu);
        }
        m2 += mu;
      }
    }
    acc = merge(acc, Moments<int>{cnt, mean, m2});
  }
  return acc;
}

// Block grp * chunks + chunk of the grid, grp = b * G + g. partials holds
// each chunk's (mean, M2), tickets one counter a group (0 between launches);
// mean_out, rstd_out [B, G] and scale, bias [B, C] f32.
template <typename T, typename P, bool kVec>
__global__ void __launch_bounds__(kThreads)
gn_fold_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
               const P* __restrict__ beta, float* __restrict__ scale,
               float* __restrict__ bias, float* __restrict__ mean_out,
               float* __restrict__ rstd_out, float2* __restrict__ partials,
               int* __restrict__ tickets, int C, int G, int64_t n, int chunks, float eps) {
  constexpr int64_t kChunk = fold_chunk<T>();
  __shared__ Moments<int> part[kThreads / 32];
  __shared__ Moments<int64_t> part_all[kThreads / 32];
  __shared__ float stats[2];
  __shared__ int last;
  const int64_t grp = blockIdx.x / chunks;
  const int64_t begin = static_cast<int64_t>(blockIdx.x % chunks) * kChunk;
  const int64_t end = n - begin < kChunk ? n : begin + kChunk;
  const Moments<int> mine = block_moments(thread_moments<T, kVec>(x + grp * n, begin, end),
                                          part);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = make_float2(mine.mean, mine.m2);
    __threadfence();                             // the partial before the ticket
    last = atomicAdd(tickets + grp, 1) == chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // thread t merges chunks t, t + kThreads, ... in order, then the tree
  Moments<int64_t> all{0, 0.f, 0.f};
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const float2 p = __ldcg(partials + grp * chunks + c);
    const int64_t left = n - static_cast<int64_t>(c) * kChunk;
    all = merge(all, Moments<int64_t>{left < kChunk ? left : kChunk, p.x, p.y});
  }
  all = block_moments(all, part_all);
  if (threadIdx.x == 0) {
    const float r = rsqrtf(all.m2 / static_cast<float>(n) + eps);
    mean_out[grp] = all.mean;
    rstd_out[grp] = r;
    stats[0] = all.mean;
    stats[1] = r;
    tickets[grp] = 0;                            // every block of the group has counted
  }
  __syncthreads();
  // the plain version's rounded products and difference, no fused multiply-add
  const int cg = C / G;
  const int64_t b = grp / G, c0 = (grp % G) * cg;
  for (int j = threadIdx.x; j < cg; j += kThreads) {
    const float sc = __fmul_rn(to_f32(gamma[c0 + j]), stats[1]);
    scale[b * C + c0 + j] = sc;
    bias[b * C + c0 + j] = __fsub_rn(to_f32(beta[c0 + j]), __fmul_rn(stats[0], sc));
  }
}

template <typename T>
int64_t fold_chunks(int64_t n) {
  return (n + fold_chunk<T>() - 1) / fold_chunk<T>();
}

template <typename T>
int launch_fold(const void* x, const void* gamma, const void* beta, int pdtype,
                float* scale, float* bias, float* mean, float* rstd, float* partials,
                int* tickets, int B, int C, int G, int64_t n, float eps,
                cudaStream_t stream) {
  constexpr int kN = 16 / sizeof(T);
  const int64_t chunks = fold_chunks<T>(n);
  const int64_t blocks = static_cast<int64_t>(B) * G * chunks;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = n % kN == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  float2* parts = reinterpret_cast<float2*>(partials);
  const int ch = static_cast<int>(chunks);
#define DCVIC_FOLD(P, V)                                                           \
  gn_fold_kernel<T, P, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>( \
      xt, static_cast<const P*>(gamma), static_cast<const P*>(beta), scale, bias,  \
      mean, rstd, parts, tickets, C, G, n, ch, eps)
  if (pdtype == 0) {
    if (vec) DCVIC_FOLD(float, true); else DCVIC_FOLD(float, false);
  } else {
    if (vec) DCVIC_FOLD(__nv_bfloat16, true); else DCVIC_FOLD(__nv_bfloat16, false);
  }
#undef DCVIC_FOLD
  return static_cast<int>(cudaGetLastError());
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

// Chunks of each of gn_fold's groups of n elements of dtype (0 f32, 1 bf16):
// the partials it is given hold 2 * B * G * chunks floats. 0 for another dtype.
extern "C" long long dcvic_gn_fold_chunks(long long n, int dtype) {
  if (n <= 0) return 0;
  if (dtype == 0) return fold_chunks<float>(n);
  if (dtype == 1) return fold_chunks<__nv_bfloat16>(n);
  return 0;
}

// x [B, C, HW] contiguous, f32 (dtype 0) or bf16 (dtype 1), C % G == 0;
// gamma, beta [C] f32 (pdtype 0) or bf16 (pdtype 1); out: scale, bias [B, C]
// and mean, rstd [B, G] f32. partials: 2 * B * G * dcvic_gn_fold_chunks
// floats of scratch; tickets: B * G ints, 0 on entry and 0 again when the
// kernel ends. Launches on stream after any earlier use of tickets.
extern "C" int dcvic_gn_fold(const void* x, const void* gamma, const void* beta,
                             float* scale, float* bias, float* mean, float* rstd,
                             float* partials, int* tickets, int B, int C, int G,
                             long long HW, float eps, int dtype, int pdtype, void* stream) {
  if (B <= 0 || C <= 0 || G <= 0 || HW <= 0 || C % G != 0 ||
      static_cast<long long>(B) * C > 2147483647LL || (pdtype != 0 && pdtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(C / G) * HW;
  if (dtype == 0)
    return launch_fold<float>(x, gamma, beta, pdtype, scale, bias, mean, rstd, partials,
                              tickets, B, C, G, n, eps, s);
  if (dtype == 1)
    return launch_fold<__nv_bfloat16>(x, gamma, beta, pdtype, scale, bias, mean, rstd,
                                      partials, tickets, B, C, G, n, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
