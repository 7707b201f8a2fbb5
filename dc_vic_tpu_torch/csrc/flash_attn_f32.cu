// Single-head attention forward, softmax(q k^T) v with q pre-scaled, in f32
// (kernel K2).
//
// Replaces the TPU kernel dc_vic_tpu/ops/attention.py::_attn_kernel
// (launched by _flash_attention_fwd_impl through pl.pallas_call): an
// online-softmax pass over K/V blocks with a running max and rescale, f32
// accumulation, and no [N, N] score matrix in device memory. The VQGAN's
// attention blocks call it on [B, N, C] with C = 512 and N = 6,144 tokens
// for a 768x512 image (three blocks in the encode, four in the decode).
//
// What bounds it on Hopper: arithmetic. One call at [4, 6144, 512] is
// 310 GFLOP against 0.1 GB of operands, far above the card's f32 ridge
// point. Without TF32 or bf16 operands (a later step) the ceiling is the
// 67 TFLOP/s of plain FFMA, and what decides the rate is how many FFMAs each
// shared-memory load feeds.
//
// Design: one block of 256 threads owns BQ = 32 query rows of one image and
// walks the keys in tiles of BK = 64. Its Q tile stays in shared memory for
// the whole walk; K and then V of the current tile share one buffer. At
// C = 512 that is 202 KB of dynamic shared memory (the launch raises the
// per-kernel limit above 48 KB), so one block runs per SM. Each warp owns
// four query rows in both products:
//   * S = Q K^T: lane j computes the scores of keys j and j + 32 for the
//     warp's four rows; a q float4 is a broadcast read, a k float4 is one
//     conflict-free read because rows are padded by four floats;
//   * the row max and sum are warp shuffles, so the running max m, the sum l
//     and the rescale factor stay in registers;
//   * O += P V: lane owns columns lane*4 + 128g (g < 4) of the warp's four
//     rows, 64 f32 accumulators in registers; each step reads one
//     broadcast probability per row and one float4 of V per group.
// Keys past N score -inf (probability 0) and their V rows are zero-filled;
// query rows past N are computed on zeros and not stored. Any N is allowed;
// C must be a multiple of 4 and at most 512 (the wrapper checks both).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;          // query rows per block (8 warps x 4 rows)
constexpr int kRows = 4;         // query rows per warp
constexpr int kBK = 64;          // keys per tile (2 per lane)
constexpr int kMaxC = 512;
constexpr int kGroups = kMaxC / 128;  // float4 column groups per lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + rows) of a row-major [N, C] matrix into shared
// memory with row stride ld floats; rows at or past N become zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int rows, int N, int C, int ld) {
  const int c4n = C >> 2;
  for (int i = threadIdx.x; i < rows * c4n; i += kThreads) {
    const int r = i / c4n;
    const int c4 = i - r * c4n;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N)
      v = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * C) + c4);
    *reinterpret_cast<float4*>(dst + r * ld + c4 * 4) = v;
  }
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int N, int C) {
  extern __shared__ float4 smem4[];
  const int ld = C + 4;
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][ld]
  float* KVs = Qs + kBQ * ld;                   // [kBK][ld], K then V
  float* Ps = KVs + kBK * ld;                   // [kBQ][kBK] probabilities

  const size_t base = static_cast<size_t>(blockIdx.y) * N * C;
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRows;

  load_tile(Qs, q + base, q0, kBQ, N, C, ld);

  float m[kRows], l[kRows];
  float4 acc[kRows][kGroups];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // Q tile written / previous tile's V reads finished
    load_tile(KVs, k + base, k0, kBK, N, C, ld);
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
    const float* ka_row = KVs + lane * ld;
    const float* kb_row = KVs + (lane + 32) * ld;
    for (int d = 0; d < C; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(ka_row + d);
      const float4 kb = *reinterpret_cast<const float4*>(kb_row + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + i) * ld + d);
        s[i][0] = dot4(qv, ka, s[i][0]);
        s[i][1] = dot4(qv, kb, s[i][1]);
      }
    }

    const bool va = k0 + lane < N;
    const bool vb = k0 + lane + 32 < N;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float sa = va ? s[i][0] : -INFINITY;
      const float sb = vb ? s[i][1] : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(fmaxf(sa, sb)));
      const float pa = va ? expf(sa - m_new) : 0.f;
      const float pb = vb ? expf(sb - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      l[i] = l[i] * alpha + warp_sum(pa + pb);
      m[i] = m_new;
      Ps[(r0 + i) * kBK + lane] = pa;
      Ps[(r0 + i) * kBK + lane + 32] = pb;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        acc[i][g].x *= alpha;
        acc[i][g].y *= alpha;
        acc[i][g].z *= alpha;
        acc[i][g].w *= alpha;
      }
    }

    __syncthreads();  // every warp is done with K before V overwrites it
    load_tile(KVs, v + base, k0, kBK, N, C, ld);
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(r0 + i) * kBK + j];
      const float* v_row = KVs + j * ld;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int c = g * 128 + lane * 4;
        if (c < C) {
          const float4 vv = *reinterpret_cast<const float4*>(v_row + c);
#pragma unroll
          for (int i = 0; i < kRows; ++i) fma4(acc[i][g], p[i], vv);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= N) continue;
    float* o_row = o + base + static_cast<size_t>(row) * C;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int c = g * 128 + lane * 4;
      if (c < C) {
        const float4 a = acc[i][g];
        *reinterpret_cast<float4*>(o_row + c) =
            make_float4(a.x / l[i], a.y / l[i], a.z / l[i], a.w / l[i]);
      }
    }
  }
}

}  // namespace

// q, k, v, o: contiguous [B, N, C] f32 device memory, 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dcvic_flash_attn_f32(const float* q, const float* k, const float* v,
                                    float* o, int B, int N, int C, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || C > kMaxC || C % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = C + 4;
  const size_t smem = sizeof(float) * static_cast<size_t>(kBQ * ld + kBK * ld + kBQ * kBK);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + kBQ - 1) / kBQ, B);
  flash_attn_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, N, C);
  return static_cast<int>(cudaGetLastError());
}
