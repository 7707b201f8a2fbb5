// Single-head attention forward, softmax(q k^T) v with q pre-scaled, on f32
// operands with f32-class results (kernel K2).
//
// Replaces the TPU kernel dc_vic_tpu/ops/attention.py::_attn_kernel
// (launched by _flash_attention_fwd_impl through pl.pallas_call): an
// online-softmax pass over K/V blocks with a running max and rescale, f32
// accumulation, and no [N, N] score matrix in device memory. The VQGAN's
// attention blocks call it on [B, N, C] with C = 512 and N = 6,144 tokens
// for a 768x512 image (three blocks in the encode, four in the decode).
//
// What bounds it on Hopper: operations. One call at [4, 6144, 512] is
// 309 GFLOP against 0.2 GB of operands. The codec needs f32-class results,
// so the products run on the tensor cores as an error-compensated 3xTF32
// split (tf32x3.cuh): three mma.sync.m16n8k8 per multiply, a third of what
// that instruction reaches (322 of the 495 TFLOP/s TF32 on an H100) at best.
// With operands in registers each element has to be split (four
// instructions) by every warp that uses it, so next to
// the tensor cores what decides the rate is how many products each split and
// each shared-memory load feed, and how well those instructions hide behind
// the products: a warp issues in order, and the split, the product and the
// rounded add of one step depend on each other.
//
// Design. A block of 256 threads (8 warps) owns BQ = 64 query rows of one
// image and walks the keys in tiles of BK = 32. Registers cannot hold a
// 16-row slab of O at C = 512 (256 accumulators a thread) nor Q, so:
//   * the Q tile stays in shared memory for the whole walk (130 KB at
//     C = 512), which leaves no room for whole K and V tiles; K and V stream
//     through a ring of four 17 KB stages filled by cp.async, first the K
//     tile in chunks of 128 channels, then the V tile in chunks of 8 keys.
//     Loads run three chunks ahead of the products; one block-wide barrier
//     per chunk hands a stage over;
//   * S = Q K^T: warp (rs, kh) computes the 16 rows rs x 16 keys kh of the
//     64 x 32 score tile, its accumulators live across the K chunks;
//   * the softmax is f32 and online: the two warps that share 16 rows
//     exchange their partial row maxima through shared memory (one barrier),
//     each takes exp on its scores, and writes its probabilities, already
//     split in hi and lo, to shared memory with the partial row sums and the
//     rescale factor exp(m_old - m_new);
//   * O += P V: warp w owns all 64 rows x C / 8 columns of O (128
//     accumulators at C = 512), so every V element is split by one warp only
//     and P comes from shared memory in the operand layout.
// The width C is a template argument: with every stride and trip count known
// the compiler lays a chunk's loads, splits, products and adds out as one
// straight block and overlaps the latencies of one step with the next; with
// C read at run time each column tile became a block of its own in which the
// load, the split, the products and the adds waited for each other.
// Every tensor-core chain is one or two k8 steps from zero, added to the f32
// accumulator with a rounded add (see tf32x3.cuh). Row strides are padded so
// that the lanes of each fragment load hit distinct banks: C + 8 for Q and
// 136 for a K chunk (8-byte loads, the 4 rows x 4 pairs of a half warp in 16
// distinct bank pairs), 36 for P (rows 4 banks apart, 4 columns a row),
// C + 8 for a V chunk (rows 8 banks apart, 8 columns a row).
//
// Keys past N score -inf (probability 0) and their V rows are zero-filled;
// query rows past N are computed on zeros and not stored. Any N is allowed;
// C must be 128, 256, 384 or 512 (the wrapper checks it). All sums run in a
// fixed order inside one block (no split over keys across blocks, no
// atomics), so the output has the same bits on every run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per tile
constexpr int kKC = 128;         // channels of a K chunk
constexpr int kVK = 8;           // keys of a V chunk (one k8 step)
constexpr int kStages = 4;       // ring of K/V chunks in shared memory
constexpr int kMaxC = 512;
constexpr int kLdK = kKC + 8;    // row stride of a K chunk
constexpr int kLdP = kBK + 4;    // row stride of the probabilities
constexpr int kStageFloats = kBK * kLdK;
constexpr int kMT = kBQ / 16;    // m16 row slabs of the block
constexpr int kVChunks = kBK / kVK;
static_assert(kStageFloats >= kVK * (kMaxC + 8), "a V chunk must fit a stage");

constexpr size_t smem_floats(int C) {
  return static_cast<size_t>(kBQ) * (C + 8) + kStages * kStageFloats + 2 * kBQ * kLdP +
         6 * kBQ;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Start the copy of kRows rows from row0 on, kCols columns from col0 on, of a
// row-major [N, kC] matrix into shared memory with row stride kLd floats;
// rows at or past N become zeros.
template <int kRows, int kCols, int kLd, int kC>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int col0, int N) {
  constexpr int kC4 = kCols / 4;
  constexpr int kIters = kRows * kC4 / kThreads;  // 16-byte pieces per thread
  static_assert(kRows * kC4 % kThreads == 0, "the copy must divide among the threads");
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kC4;
    const int c = (i - r * kC4) * 4;
    const bool valid = row0 + r < N;
    cp_async16(dst + r * kLd + c,
               src + static_cast<size_t>(valid ? row0 + r : 0) * kC + col0 + c, valid);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store_split2(float* hi, float* lo, float p0, float p1) {
  uint32_t h0, l0, h1, l1;
  tf32x3::split(p0, h0, l0);
  tf32x3::split(p1, h1, l1);
  *reinterpret_cast<float2*>(hi) = make_float2(__uint_as_float(h0), __uint_as_float(h1));
  *reinterpret_cast<float2*>(lo) = make_float2(__uint_as_float(l0), __uint_as_float(l1));
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int N) {
  constexpr int kLdQ = kC + 8, kLdV = kC + 8;
  constexpr int kKChunks = kC / kKC;             // K chunks of a tile
  constexpr int kPer = kKChunks + kVChunks;      // chunks of a tile, K then V
  constexpr int kNT = kC / 64;                   // n8 tiles of O a warp owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][kLdQ]
  float* ring = Qs + kBQ * kLdQ;                 // [kStages][kStageFloats]
  float* Ph = ring + kStages * kStageFloats;     // [kBQ][kLdP] probabilities, hi
  float* Pl = Ph + kBQ * kLdP;                   // [kBQ][kLdP] probabilities, lo
  float* pmax = Pl + kBQ * kLdP;                 // [2][kBQ] row maxima of each key half
  float* psum = pmax + 2 * kBQ;                  // [2][kBQ] row sums of each key half
  float* alpha_s = psum + 2 * kBQ;               // [kBQ] exp(m_old - m_new) of the tile
  float* l_s = alpha_s + kBQ;                    // [kBQ] running softmax denominators

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rs = warp >> 1, kh = warp & 1;       // the warp's part of the score tile
  const int r0 = rs * 16 + g, r1 = r0 + 8;       // its two score rows
  const size_t base = static_cast<size_t>(blockIdx.y) * N * kC;
  const int q0 = blockIdx.x * kBQ;
  const int col_w = warp * (kC / 8);             // the warp's first column of O

  if (tid < kBQ) l_s[tid] = 0.f;

  // Start the copy of chunk j of a key tile into a stage of the ring.
  auto issue = [&](int tile, int j, int stage) {
    if (tile * kBK < N) {
      float* dst = ring + stage * kStageFloats;
      if (j < kKChunks)
        load_rows<kBK, kKC, kLdK, kC>(dst, k + base, tile * kBK, j * kKC, N);
      else
        load_rows<kVK, kC, kLdV, kC>(dst, v + base, tile * kBK + (j - kKChunks) * kVK, 0, N);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  // the loader runs kAhead chunks ahead of the products, less than one tile
  constexpr int kAhead = kStages - 1;
  static_assert(kAhead <= kPer, "the chunks in flight stay within two tiles");
  load_rows<kBQ, kC, kLdQ, kC>(Qs, q + base, q0, 0, N);  // lands with chunk 0
#pragma unroll
  for (int c = 0; c < kAhead; ++c) issue(0, c, c);

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mt][nt][x] = 0.f;
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float m0 = -INFINITY, m1 = -INFINITY;          // running maxima of rows r0, r1

  for (int tile = 0; tile * kBK < N; ++tile) {
#pragma unroll 1
    for (int j = 0; j < kPer; ++j) {
      cp_async_wait<kStages - 2>();  // this thread's part of the chunk has landed
      __syncthreads();               // everyone's has; the chunk before is consumed
      const int stage = (tile * kPer + j) % kStages;
      {                              // into the stage that chunk occupied
        const bool wrap = j + kAhead >= kPer;
        issue(tile + wrap, j + kAhead - (wrap ? kPer : 0), (stage + kAhead) % kStages);
      }
      const float* st = ring + stage * kStageFloats;

      if (j < kKChunks) {
        // ---- S += Q[:, chunk] K[:, chunk]^T for this warp's 16 x 16 part
        // A k8 step takes channels 2t and 2t + 1 of its eight for the lane's
        // two k positions (t, t + 4), in Q and K alike: a sum over channels
        // has no order, and each operand pair is then one 8-byte load. Two
        // steps share a tensor-core chain before the rounded add.
        const float* qa = Qs + r0 * kLdQ + j * kKC + 2 * t;
        const float* kb = st + (kh * 16 + g) * kLdK + 2 * t;
#pragma unroll 2
        for (int ks = 0; ks < kKC / 8; ks += 2) {
          float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = ks; kk < ks + 2; ++kk) {
            const float2 q0v = *reinterpret_cast<const float2*>(qa + kk * 8);
            const float2 q1v = *reinterpret_cast<const float2*>(qa + 8 * kLdQ + kk * 8);
            const float a[4] = {q0v.x, q1v.x, q0v.y, q1v.y};
            uint32_t a_hi[4], a_lo[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) tf32x3::split(a[x], a_hi[x], a_lo[x]);
#pragma unroll
            for (int jn = 0; jn < 2; ++jn) {
              const float2 kv = *reinterpret_cast<const float2*>(kb + jn * 8 * kLdK + kk * 8);
              uint32_t b_hi[2], b_lo[2];
              tf32x3::split(kv.x, b_hi[0], b_lo[0]);
              tf32x3::split(kv.y, b_hi[1], b_lo[1]);
              tf32x3::mma_split(d[jn], a_hi, a_lo, b_hi, b_lo);
            }
          }
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
#pragma unroll
            for (int x = 0; x < 4; ++x) s[jn][x] += d[jn][x];
        }

        if (j == kKChunks - 1) {
          // ---- online softmax of the finished score tile
          const int key0 = tile * kBK + kh * 16 + 2 * t;
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            if (key0 + jn * 8 >= N) s[jn][0] = s[jn][2] = -INFINITY;
            if (key0 + jn * 8 + 1 >= N) s[jn][1] = s[jn][3] = -INFINITY;
          }
          const float mx0 =
              quad_max(fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
          const float mx1 =
              quad_max(fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
          if (t == 0) {
            pmax[kh * kBQ + r0] = mx0;
            pmax[kh * kBQ + r1] = mx1;
          }
          __syncthreads();
          // tile 0 holds key 0, so the new maxima are finite from the start
          const float mn0 = fmaxf(m0, fmaxf(pmax[r0], pmax[kBQ + r0]));
          const float mn1 = fmaxf(m1, fmaxf(pmax[r1], pmax[kBQ + r1]));
          float p[2][4];
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            p[jn][0] = expf(s[jn][0] - mn0);
            p[jn][1] = expf(s[jn][1] - mn0);
            p[jn][2] = expf(s[jn][2] - mn1);
            p[jn][3] = expf(s[jn][3] - mn1);
            const int col = kh * 16 + jn * 8 + 2 * t;
            store_split2(Ph + r0 * kLdP + col, Pl + r0 * kLdP + col, p[jn][0], p[jn][1]);
            store_split2(Ph + r1 * kLdP + col, Pl + r1 * kLdP + col, p[jn][2], p[jn][3]);
            s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
          }
          const float sum0 = quad_sum((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
          const float sum1 = quad_sum((p[0][2] + p[0][3]) + (p[1][2] + p[1][3]));
          if (t == 0) {
            psum[kh * kBQ + r0] = sum0;
            psum[kh * kBQ + r1] = sum1;
            if (kh == 0) {
              alpha_s[r0] = expf(m0 - mn0);  // 0 on the first tile
              alpha_s[r1] = expf(m1 - mn1);
            }
          }
          m0 = mn0;
          m1 = mn1;
        }
      } else {
        // ---- O += P[:, 8 keys] V[8 keys, :] for this warp's columns
        const int jv = j - kKChunks;
        if (jv == 0) {
          // the barrier above published P, the row sums and the rescale factors
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const float al0 = alpha_s[mt * 16 + g], al1 = alpha_s[mt * 16 + g + 8];
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              acc[mt][nt][0] *= al0;
              acc[mt][nt][1] *= al0;
              acc[mt][nt][2] *= al1;
              acc[mt][nt][3] *= al1;
            }
          }
          if (tid < kBQ) l_s[tid] = l_s[tid] * alpha_s[tid] + (psum[tid] + psum[kBQ + tid]);
        }
        uint32_t p_hi[kMT][4], p_lo[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int at = (mt * 16 + g) * kLdP + jv * kVK + t;
          p_hi[mt][0] = __float_as_uint(Ph[at]);
          p_hi[mt][1] = __float_as_uint(Ph[at + 8 * kLdP]);
          p_hi[mt][2] = __float_as_uint(Ph[at + 4]);
          p_hi[mt][3] = __float_as_uint(Ph[at + 8 * kLdP + 4]);
          p_lo[mt][0] = __float_as_uint(Pl[at]);
          p_lo[mt][1] = __float_as_uint(Pl[at + 8 * kLdP]);
          p_lo[mt][2] = __float_as_uint(Pl[at + 4]);
          p_lo[mt][3] = __float_as_uint(Pl[at + 8 * kLdP + 4]);
        }
        const float* vb = st + t * kLdV + col_w + g;
#pragma unroll
        for (int n0 = 0; n0 < kNT; n0 += 4) {  // four column tiles' loads in flight
          float vraw[4][2];
#pragma unroll
          for (int n = 0; n < 4 && n0 + n < kNT; ++n) {
            vraw[n][0] = vb[(n0 + n) * 8];
            vraw[n][1] = vb[4 * kLdV + (n0 + n) * 8];
          }
#pragma unroll
          for (int n = 0; n < 4 && n0 + n < kNT; ++n) {
            uint32_t b_hi[2], b_lo[2];
            tf32x3::split(vraw[n][0], b_hi[0], b_lo[0]);
            tf32x3::split(vraw[n][1], b_hi[1], b_lo[1]);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              tf32x3::mma_split(d, p_hi[mt], p_lo[mt], b_hi, b_lo);
#pragma unroll
              for (int x = 0; x < 4; ++x) acc[mt][n0 + n][x] += d[x];
            }
          }
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + half * 8;
      if (q0 + r >= N) continue;
      const float inv = 1.f / l_s[r];
      float* o_row = o + base + static_cast<size_t>(q0 + r) * kC + col_w + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<float2*>(o_row + nt * 8) =
            make_float2(acc[mt][nt][half * 2] * inv, acc[mt][nt][half * 2 + 1] * inv);
    }
  }
}

template <int kC>
int launch(const float* q, const float* k, const float* v, float* o, int B, int N,
           cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(float) * smem_floats(kC));
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attn_f32_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kBQ - 1) / kBQ, B);
  flash_attn_f32_kernel<kC><<<grid, kThreads, smem, stream>>>(q, k, v, o, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous [B, N, C] f32 device memory, 16-byte aligned;
// C one of 128, 256, 384, 512.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dcvic_flash_attn_f32(const float* q, const float* k, const float* v,
                                    float* o, int B, int N, int C, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch<128>(q, k, v, o, B, N, s);
    case 256: return launch<256>(q, k, v, o, B, N, s);
    case 384: return launch<384>(q, k, v, o, B, N, s);
    case 512: return launch<512>(q, k, v, o, B, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
