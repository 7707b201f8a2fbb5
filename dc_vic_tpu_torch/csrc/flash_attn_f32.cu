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
// split (tf32x3.cuh): three TF32 products per multiply, 1.874 ms at the
// card's 495 TFLOP/s. Only the warpgroup instruction wgmma reaches that rate.
// At C = 512 both on-chip stores are full: the 64 x 512 f32 output takes half
// the register file (255 registers a thread, a few spilled), Q 128 KB of the
// 227 KB of shared memory. What holds the kernel at about a third of its
// bound is the time around the products: a warpgroup's products of a chunk
// take 192 tensor-core cycles, the staging, adds and hand-over of that chunk
// about 600 more (clock64 stamps, tools/attn_stamps.py), and neither the
// registers nor the shared memory leave room for larger chunks or a second
// group of products in flight.
//
// Design. A block of two warpgroups owns BQ = 64 query rows of one image,
// the M of every wgmma, and walks the keys in tiles of BK = 32:
//   * warpgroup wg owns the channels [wg C/2, (wg + 1) C/2): it takes the
//     score tile S = Q K^T over its half of the channels (wgmma m64n32k8,
//     keys as N), and O = P V over its half of the columns (wgmma m64n64k8,
//     columns as N; 128 accumulators a thread at C = 512);
//   * the two partial score tiles meet through shared memory (one barrier of
//     the two warpgroups per tile, a buffer per tile parity); both
//     warpgroups then hold the whole tile and take the same online softmax
//     in registers, with the same bits;
//   * P stays in registers: the score accumulator gives a thread keys 2t and
//     2t + 1 of each 8-key group, which serve as the k positions t and t + 4
//     of the A fragment of P V, so V's keys are staged in the order
//     0, 2, 4, 6 | 1, 3, 5, 7 of each group;
//   * Q is staged once per block, raw, in the order of the A fragments (a
//     warp's four registers of a k8 step are one 16-byte load, 128 KB at
//     C = 512), and split into hi and lo in registers at each use: one split
//     feeds a 32-key product;
//   * K and V are split once per block, into shared memory: a warpgroup
//     walks its own chunks of 4 KB (K: 32 keys x 32 channels; V: 16 keys x
//     64 columns), each copied raw by cp.async into a ring of kRaw = 4 slots,
//     then split by the warpgroup into one of two stages of hi and lo planes
//     in the K-major core-matrix layout that wgmma reads as B (V transposed
//     on the way); each element is split by one thread and read by a whole
//     warpgroup product;
//   * overlap: the copies run three chunks ahead (a load from L2 takes
//     longer than a chunk's products: staged through registers one chunk
//     ahead, the loads set the pace). While the
//     tensor cores take chunk s, the warpgroup splits chunk s + 1 into the
//     other stage; one barrier of the warpgroup's own 128 threads per chunk
//     hands the stages over. The two warpgroups take turns to issue (a pair
//     of named barriers), so that each one's staging runs under the other's
//     products. There is no producer warp: the two warpgroups need all the
//     registers, and a warpgroup's own threads issue its copies, which takes
//     them no registers.
// Numerics (tf32x3.cuh): each tensor-core chain starts from zero and is added
// to an f32 accumulator with a rounded add: a score chain is the 32 channels
// of a K chunk (4 k8 steps, 12 products), a value chain the 32 keys of a tile
// (two V chunks, 4 k8 steps, 12 products), added as O = O * exp(m_old -
// m_new) + chain by one fmaf. (Score chains of 64 channels did not hold the
// scores of +-500 at C = 128 to 1e-4 of float64.) The width C is a template
// argument, so every chunk of a tile is unrolled with its accumulators in
// registers.
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

constexpr int kThreads = 256;        // two warpgroups
constexpr int kBQ = 64;              // query rows of a block: the M of every product
constexpr int kBK = 32;              // keys of a tile: the N of the score product
constexpr int kKC = 32;              // channels of a K chunk: four k8 steps
constexpr int kVC = 64;              // columns of a V chunk: the N of the value product
constexpr int kVK = 16;              // keys of a V chunk: two k8 steps
constexpr int kPlane = kBK * kKC;    // floats of a chunk, raw or one split plane: 4 KB
static_assert(kPlane == kVC * kVK, "K and V chunks are of one size");
constexpr int kStage = 2 * kPlane;   // floats of a split stage: hi and lo planes
constexpr int kRaw = 4;              // raw chunks a warpgroup has in flight or landed
constexpr int kXch = kBQ * kBK;      // floats of one warpgroup's partial score tile
constexpr int kBarExchange = 1;      // named barriers (0 is __syncthreads) ...
constexpr int kBarGroup = 2;         // ... 2 + wg for warpgroup wg's chunks ...
constexpr int kBarTurn = 4;          // ... and 4 + wg: warpgroup wg may issue

constexpr int smem_bytes(int C) {
  // Q; per warpgroup two split stages and kRaw raw chunks; the partial
  // scores of two tiles
  return static_cast<int>(sizeof(float)) *
         (kBQ * C + 2 * (2 * kStage + kRaw * kPlane) + 4 * kXch);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
// this thread's shared-memory writes, visible to the tensor cores' reads
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// four values split, hi to one 16-byte slot and lo to another
__device__ __forceinline__ void store_split4(float4* hi, float4* lo, float x0, float x1,
                                             float x2, float x3) {
  uint32_t h[4], l[4];
  tf32x3::split(x0, h[0], l[0]);
  tf32x3::split(x1, h[1], l[1]);
  tf32x3::split(x2, h[2], l[2]);
  tf32x3::split(x3, h[3], l[3]);
  *hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                    __uint_as_float(h[3]));
  *lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                    __uint_as_float(l[3]));
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int N) {
  constexpr int kHalf = kC / 2;           // channels of S and columns of O a warpgroup owns
  constexpr int kCG = kHalf / kVC;        // column groups of O a warpgroup owns
  constexpr int kNK = kHalf / kKC;        // K chunks of a tile
  constexpr int kNV = kCG * (kBK / kVK);  // V chunks of a tile: column group, key half
  constexpr int kPer = kNK + kNV;         // chunks of a tile, K then V
  constexpr int kSteps = kC / 8;          // k8 steps of a Q row
  static_assert(kPer >= 2, "a tile is at least two chunks");

  extern __shared__ float4 smem4[];
  float4* const qf = smem4;                                         // [4 warps][kSteps][32 lanes]
  float* const split = reinterpret_cast<float*>(smem4 + kBQ * kC / 4);  // [2 wg][2][kStage]
  float* const raw = split + 4 * kStage;                            // [2 wg][kRaw][kPlane]
  float4* const xch = reinterpret_cast<float4*>(raw + 2 * kRaw * kPlane);  // [2][2 wg][kXch]

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, w = (tid >> 5) & 3;      // w: the warp within its warpgroup
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.y) * N * kC;
  const int q0 = blockIdx.x * kBQ;
  const int tiles = (N + kBK - 1) / kBK;
  const float* const kg = k + base + wg * kHalf;
  const float* const vg = v + base + wg * kHalf;
  float* const my_split = split + wg * 2 * kStage;
  float* const my_raw = raw + wg * kRaw * kPlane;

  // ---- Q, once: slot (w, j, lane) holds that lane's A fragment of k8 step j
#pragma unroll 4
  for (int e = tid; e < kBQ * kC / 4; e += kThreads) {
    const int ln = e & 31, j = (e >> 5) % kSteps, wq = (e >> 5) / kSteps;
    const int r = q0 + 16 * wq + (ln >> 2);
    const float* p = q + base + static_cast<size_t>(r) * kC + 8 * j + (ln & 3);
    const bool in0 = r < N, in1 = r + 8 < N;
    qf[e] = make_float4(in0 ? p[0] : 0.f, in1 ? p[8 * kC] : 0.f, in0 ? p[4] : 0.f,
                        in1 ? p[8 * kC + 4] : 0.f);
  }

  // ---- a chunk's way in: global -> raw slot (cp.async) -> split stage.
  // K chunk qi: keys x channels qi * 32 + [0, 32). Its raw slot is already in
  // the order of the B operands: float4 e (= wtid + 128 i) holds channels
  // (e / 64) * 8 + (e / 8 % 2) * 4 + (0..3) of key (e / 16 % 4) * 8 + e % 8,
  // which is where k8 step e / 64's [32 x 8] operand wants it, so the split
  // writes float4 e of each plane. V chunk qi = kNK + 2 cg + kh: keys
  // kh * 16 + [0, 16) x columns cg * 64 + [0, 64), raw row-major; the split
  // writes column n's keys m * 8 + h + (0, 2, 4, 6) (h = wtid / 64) as one
  // float4 of k8 step m's [64 x 8] operand: V transposed, keys in the order
  // of P's fragment. Keys at or past N are zero-filled.
  auto fetch = [&](float* dst, int tile, int qi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = wtid + 128 * i;
      int key;
      const float* src;
      if (qi < kNK) {
        key = tile * kBK + ((e >> 4) & 3) * 8 + (e & 7);
        src = kg + qi * kKC + (e >> 6) * 8 + ((e >> 3) & 1) * 4;
      } else {
        key = tile * kBK + ((qi - kNK) & 1) * kVK + (e >> 4);
        src = vg + ((qi - kNK) >> 1) * kVC + (e & 15) * 4;
      }
      const bool in = key < N;
      cp_async16(dst + 4 * e, src + static_cast<size_t>(in ? key : 0) * kC, in);
    }
  };
  float rv[8];  // a thread's raw values of the chunk it splits next
  auto split_load = [&](const float* src, int qi) {
    if (qi < kNK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 x = reinterpret_cast<const float4*>(src)[wtid + 128 * i];
        rv[4 * i] = x.x;
        rv[4 * i + 1] = x.y;
        rv[4 * i + 2] = x.z;
        rv[4 * i + 3] = x.w;
      }
    } else {
      const float* r = src + (wtid >> 6) * kVC + (wtid & 63);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) rv[4 * m + i] = r[(m * 8 + 2 * i) * kVC];
    }
  };
  auto split_store = [&](float* dst, int qi) {
    float4* const hi = reinterpret_cast<float4*>(dst);
    if (qi < kNK) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        store_split4(hi + wtid + 128 * i, hi + kPlane / 4 + wtid + 128 * i, rv[4 * i],
                     rv[4 * i + 1], rv[4 * i + 2], rv[4 * i + 3]);
    } else {
      const int n = wtid & 63;
      float4* const at = hi + ((n >> 3) * 2 + (wtid >> 6)) * 8 + (n & 7);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        store_split4(at + m * kVC * 2, at + kPlane / 4 + m * kVC * 2, rv[4 * m],
                     rv[4 * m + 1], rv[4 * m + 2], rv[4 * m + 3]);
    }
  };

  float acc[kCG][32];  // O: rows 16w + g (+ 8), columns wg C/2 + c * 64 + 8j + 2t (+ 1)
#pragma unroll
  for (int c = 0; c < kCG; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;
  float sacc[16], spart[16], part[32];
  uint32_t p_hi[4][4], p_lo[4][4];  // P as the A fragments of the tile's four k8 steps
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // running denominators
  float al0 = 0.f, al1 = 0.f;            // exp(m_old - m_new) of the tile

  // chunk c of the walk is chunk c % kPer of tile c / kPer; its raw slot is c % kRaw
#pragma unroll
  for (int c = 0; c < kRaw; ++c) {
    fetch(my_raw + c * kPlane, c / kPer, c % kPer);
    cp_async_commit();
  }
  cp_async_wait<kRaw - 1>();  // chunk 0, this thread's part
  __syncthreads();            // everyone's; Q is staged
  split_load(my_raw, 0);
  split_store(my_split, 0);
  cp_async_wait<kRaw - 2>();  // chunk 1
  fence_to_async();
  __syncthreads();

  for (int tile = 0; tile < tiles; ++tile) {
#pragma unroll
    for (int qi = 0; qi < kPer; ++qi) {
      const int s = tile * kPer + qi;
      const uint64_t b = tf32x3::b_descriptor(my_split + (s & 1) * kStage);
      // first the loads whose latency the turn and the products hide: the
      // next chunk's raw values, and the copy of the chunk kRaw on into the
      // raw slot the next chunk's split has left (its loads already landed)
      split_load(my_raw + ((s + 1) % kRaw) * kPlane, (qi + 1) % kPer);
      fetch(my_raw + (s % kRaw) * kPlane, tile + (qi + kRaw) / kPer, (qi + kRaw) % kPer);
      cp_async_commit();
      // the warpgroups take turns to issue, warpgroup 0 first: each one's
      // split, copies and adds run while the other's products do
      if (wg == 1 || s > 0) bar_sync(kBarTurn + wg, kThreads);
      uint32_t a_hi[4][4], a_lo[4][4];  // Q's A fragments of a K chunk's k8 steps
      if (qi < kNK) {
        // ---- S (+)= Q[:, 32 channels] K[tile, 32 channels]^T: one chain
        const float4* qa = qf + (w * kSteps + wg * (kHalf / 8) + qi * 4) * 32 + lane;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 f = qa[kk * 32];
          tf32x3::split(f.x, a_hi[kk][0], a_lo[kk][0]);
          tf32x3::split(f.y, a_hi[kk][1], a_lo[kk][1]);
          tf32x3::split(f.z, a_hi[kk][2], a_lo[kk][2]);
          tf32x3::split(f.w, a_hi[kk][3], a_lo[kk][3]);
        }
        tf32x3::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 16-byte units: 1 KB a k8 step, lo 4 KB on
          tf32x3::wgmma_split(spart, a_hi[kk], a_lo[kk], b + kk * kBK * 2,
                              b + kPlane / 4 + kk * kBK * 2, kk > 0);
        tf32x3::wgmma_commit();
        bar_arrive(kBarTurn + (wg ^ 1), kThreads);
      } else {
        // ---- O[:, 64 columns] (+)= P[:, 16 keys] V[16 keys, 64 columns]: half a chain
        const int kh = (qi - kNK) & 1;
        tf32x3::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)  // 2 KB a k8 step, lo 4 KB on
          tf32x3::wgmma_split(part, p_hi[2 * kh + kk], p_lo[2 * kh + kk], b + kk * kVC * 2,
                              b + kPlane / 4 + kk * kVC * 2, kh || kk > 0);
        tf32x3::wgmma_commit();
        bar_arrive(kBarTurn + (wg ^ 1), kThreads);
      }
      // meanwhile the next chunk into the other split stage
      split_store(my_split + ((s + 1) & 1) * kStage, (qi + 1) % kPer);
      tf32x3::wgmma_wait<0>();
      if (qi < kNK) {
        tf32x3::hold(spart);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tf32x3::hold(a_hi[kk]);
          tf32x3::hold(a_lo[kk]);
        }
#pragma unroll
        for (int x = 0; x < 16; ++x) sacc[x] = qi == 0 ? spart[x] : sacc[x] + spart[x];
      } else {
        tf32x3::hold(part);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tf32x3::hold(p_hi[kk]);
          tf32x3::hold(p_lo[kk]);
        }
        if ((qi - kNK) & 1) {  // a 32-key chain ends: O = O * alpha + chain
          const int c = (qi - kNK) >> 1;
#pragma unroll
          for (int x = 0; x < 32; ++x) acc[c][x] = fmaf(acc[c][x], x & 2 ? al1 : al0, part[x]);
        }
      }
      if (qi == kNK - 1) {
        // ---- the two halves of the score tile meet; online softmax
        // tile parity: a warpgroup writes tile t + 2's scores only after the
        // other has passed this barrier for tile t + 1, so after its reads
        float4* const mine = xch + ((tile & 1) * 2 + wg) * (kXch / 4);
        const float4* const other = xch + ((tile & 1) * 2 + (wg ^ 1)) * (kXch / 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mine[i * 128 + wtid] =
              make_float4(sacc[4 * i], sacc[4 * i + 1], sacc[4 * i + 2], sacc[4 * i + 3]);
        bar_sync(kBarExchange, kThreads);
        float sc[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 y = other[i * 128 + wtid];  // the same positions, other channels
          sc[4 * i] = sacc[4 * i] + y.x;
          sc[4 * i + 1] = sacc[4 * i + 1] + y.y;
          sc[4 * i + 2] = sacc[4 * i + 2] + y.z;
          sc[4 * i + 3] = sacc[4 * i + 3] + y.w;
        }
        const int key0 = tile * kBK + 2 * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (key0 + 8 * i >= N) sc[4 * i] = sc[4 * i + 2] = -INFINITY;
          if (key0 + 8 * i + 1 >= N) sc[4 * i + 1] = sc[4 * i + 3] = -INFINITY;
        }
        float mx0 = fmaxf(sc[0], sc[1]), mx1 = fmaxf(sc[2], sc[3]);
#pragma unroll
        for (int i = 1; i < 4; ++i) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
        }
        // tile 0 holds key 0, so the new maxima are finite from the start
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        al0 = expf(m0 - mn0);  // 0 on the first tile
        al1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p0 = expf(sc[4 * i] - mn0), p1 = expf(sc[4 * i + 1] - mn0);
          const float p2 = expf(sc[4 * i + 2] - mn1), p3 = expf(sc[4 * i + 3] - mn1);
          sum0 += p0 + p1;
          sum1 += p2 + p3;
          // k position t is key 2t, k position t + 4 is key 2t + 1
          tf32x3::split(p0, p_hi[i][0], p_lo[i][0]);
          tf32x3::split(p2, p_hi[i][1], p_lo[i][1]);
          tf32x3::split(p1, p_hi[i][2], p_lo[i][2]);
          tf32x3::split(p3, p_hi[i][3], p_lo[i][3]);
        }
        l0 = l0 * al0 + quad_sum(sum0);
        l1 = l1 * al1 + quad_sum(sum1);
      }
      cp_async_wait<kRaw - 2>();  // chunk s + 2, this thread's part
      fence_to_async();
      bar_sync(kBarGroup + wg, 128);  // chunk s + 1 is split, s + 2 has landed; s is read
    }
  }

  if (wg == 0) bar_sync(kBarTurn, kThreads);  // warpgroup 1's last turn handed back
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + 16 * w + g;
  float* const o0 = o + base + static_cast<size_t>(r0) * kC + wg * kHalf + 2 * t;
#pragma unroll
  for (int c = 0; c < kCG; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r0 < N)
        *reinterpret_cast<float2*>(o0 + c * kVC + 8 * j) =
            make_float2(acc[c][4 * j] * inv0, acc[c][4 * j + 1] * inv0);
      if (r0 + 8 < N)
        *reinterpret_cast<float2*>(o0 + 8 * kC + c * kVC + 8 * j) =
            make_float2(acc[c][4 * j + 2] * inv1, acc[c][4 * j + 3] * inv1);
    }
}

template <int kC>
int launch(const float* q, const float* k, const float* v, float* o, int B, int N,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes(kC);
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

// The dynamic shared memory a block of the kernel takes at width C, in
// bytes (-1 for a width it does not take).
extern "C" int dcvic_flash_attn_f32_smem(int C) {
  return C == 128 || C == 256 || C == 384 || C == 512 ? smem_bytes(C) : -1;
}
