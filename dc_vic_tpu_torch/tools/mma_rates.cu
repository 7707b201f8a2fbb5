// Issue rates of the tensor-core instructions the port's kernels use, with
// nothing else in the loop: TF32 mma.sync.m16n8k8 (per warp) and
// wgmma.mma_async.m64n64k8 and m64n32k8 (per warpgroup, A from registers, B
// from shared memory), and bf16 wgmma.mma_async.m64n64k16 and m64n128k16 with A from
// shared memory or from registers (B from shared memory). The kernels of the
// port are judged against these ceilings. Built and run by mma_rates.py;
// prints one line per configuration.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kTiles independent accumulators a warp, each hit kChain times in a row.
template <int kTiles, int kChain>
__global__ void mma_loop(float* out, long long* cycles, int iters) {
  float d[kTiles][4];
  for (int i = 0; i < kTiles; ++i)
    for (int x = 0; x < 4; ++x) d[i][x] = 0.f;
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, 3u, 4u};
  const uint32_t b[2] = {threadIdx.x * 3u, 7u};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int r = 0; r < kChain; ++r) mma(d[i], a, b);
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < kTiles; ++i)
    for (int x = 0; x < 4; ++x) s += d[i][x];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

#define ACC32(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),    \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

// kGroup products, a commit and a wait for all of them per round, as the conv
// kernel issues the three products of a tap.
template <int kGroup>
__global__ void wgmma_loop(float* out, long long* cycles, int iters) {
  extern __shared__ float4 sm[];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) sm[i] = make_float4(1e-3f, 2e-3f, 0.f, 1e-3f);
  __syncthreads();
  // K-major core matrices without swizzle: 128 B apart along K, 256 B along N
  const uint64_t desc = ((static_cast<uint64_t>(__cvta_generic_to_shared(sm)) & 0x3FFFF) >> 4) |
                        (uint64_t(8) << 16) | (uint64_t(16) << 32);
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      asm volatile(
          "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "{%32, %33, %34, %35}, %36, 1, 1, 1;"
          : ACC32(d)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc + r * 128));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < 32; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

// As wgmma_loop at N = 32 (the attention kernel's score product): kGroup
// products of m64n32k8, a commit and a wait for all of them per round.
template <int kGroup>
__global__ void wgmma_n32_loop(float* out, long long* cycles, int iters) {
  extern __shared__ float4 sm[];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) sm[i] = make_float4(1e-3f, 2e-3f, 0.f, 1e-3f);
  __syncthreads();
  const uint64_t desc = ((static_cast<uint64_t>(__cvta_generic_to_shared(sm)) & 0x3FFFF) >> 4) |
                        (uint64_t(8) << 16) | (uint64_t(16) << 32);
  float d[16];
  for (int i = 0; i < 16; ++i) d[i] = 0.f;
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      asm volatile(
          "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
          "{%16, %17, %18, %19}, %20, 1, 1, 1;"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc + (r % 8) * 64));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

#define ACC64(d)                                                                       \
  ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),           \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),    \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),    \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),    \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define REGS32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REGS64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "    \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// One bf16 product D[64 x N] += A[64 x 16] B[16 x N], B from shared memory,
// A from shared memory (kASmem) or registers.
template <int kN, bool kASmem>
__device__ __forceinline__ void wgmma_bf16(float (&d)[kN / 2], uint64_t desc_a,
                                           const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (kN == 64 && kASmem)
    asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
                 ", %32, %33, 1, 1, 1, 0, 0;"
                 : ACC32(d) : "l"(desc_a), "l"(desc_b));
  if constexpr (kN == 64 && !kASmem)
    asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
                 ", {%32, %33, %34, %35}, %36, 1, 1, 1, 0;"
                 : ACC32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
  if constexpr (kN == 128 && kASmem)
    asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
                 ", %64, %65, 1, 1, 1, 0, 0;"
                 : ACC64(d) : "l"(desc_a), "l"(desc_b));
  if constexpr (kN == 128 && !kASmem)
    asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
                 ", {%64, %65, %66, %67}, %68, 1, 1, 1, 0;"
                 : ACC64(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// Nine bf16 products per commit (one per tap, as the bf16 conv kernels issue
// a step), then a wait that leaves the last group in flight.
template <int kN, bool kASmem>
__global__ void __launch_bounds__(512) wgmma_bf16_loop(float* out, long long* cycles, int iters) {
  extern __shared__ float4 sm[];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x)
    sm[i] = make_float4(1e-3f, 2e-3f, 0.f, 1e-3f);  // bf16 pairs of small values
  __syncthreads();
  // K-major core matrices without swizzle: 128 B apart along K, 256 B along
  // M or N; A at 0, the nine B operands from 8 KB on, 4 KB apart
  const uint64_t base = (static_cast<uint64_t>(__cvta_generic_to_shared(sm)) & 0x3FFFF) >> 4;
  const uint64_t desc_a = base | (uint64_t(8) << 16) | (uint64_t(16) << 32);
  const uint64_t desc_b = desc_a + (8192 >> 4);
  float d[kN / 2];
  for (int i = 0; i < kN / 2; ++i) d[i] = 0.f;
  const uint32_t a[4] = {0x3A833A83u, threadIdx.x, 2u, 3u};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int r = 0; r < 9; ++r) wgmma_bf16<kN, kASmem>(d, desc_a, a, desc_b + r * (4096 >> 4));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < kN / 2; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

// Runs the kernel twice on every SM and reports the second launch: cycles per
// instruction on one SM, the clock, and the rate of the whole card in the
// instruction's type.
template <typename Launch>
void report(const char* name, const char* type, int sms, double per_sm, double flop_each,
            Launch launch) {
  long long* cycles;
  cudaMalloc(&cycles, 8);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch(cycles);
  cudaEventRecord(e0);
  launch(cycles);
  cudaEventRecord(e1);
  cudaDeviceSynchronize();
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c = 0;
  cudaMemcpy(&c, cycles, 8, cudaMemcpyDeviceToHost);
  printf("%s: %.2f cycles per instruction per SM, clock %.0f MHz, %.1f TFLOP/s %s (%s)\n",
         name, c / per_sm, c / (ms * 1e3), per_sm * sms * flop_each / (ms * 1e-3) / 1e12, type,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(cycles);
}

template <int kN, bool kASmem> void bf16_rates(int sms, float* out) {
  cudaFuncSetAttribute(wgmma_bf16_loop<kN, kASmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       65536);
  char name[112];
  for (int groups : {1, 2, 4}) {
    const int iters = 3000;
    snprintf(name, sizeof name, "wgmma m64n%dk16 bf16, A from %s, %d warpgroups an SM, 9 per "
             "commit, wait 1", kN, kASmem ? "shared memory" : "registers", groups);
    report(name, "bf16", sms, double(iters) * 9 * groups, 2.0 * 64 * kN * 16, [&](long long* c) {
      wgmma_bf16_loop<kN, kASmem><<<sms, groups * 128, 65536>>>(out, c, iters);
    });
  }
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  float* out;
  cudaMalloc(&out, sms * 1024 * sizeof(float));
  char name[96];
  for (int warps : {4, 8, 16}) {
    const int iters = 5000;
    snprintf(name, sizeof name, "mma.sync m16n8k8, %2d warps an SM, 16 chains of 3", warps);
    report(name, "TF32", sms, double(iters) * 48 * warps, 2.0 * 16 * 8 * 8, [&](long long* c) {
      mma_loop<16, 3><<<sms, warps * 32>>>(out, c, iters);
    });
  }
  report("mma.sync m16n8k8,  4 warps an SM, one chain (latency)", "TF32", sms, 20000.0 * 4,
         2048.0,
         [&](long long* c) { mma_loop<1, 1><<<sms, 128>>>(out, c, 20000); });
  cudaFuncSetAttribute(wgmma_loop<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  for (int groups : {1, 2, 4}) {
    const int iters = 6000;
    snprintf(name, sizeof name, "wgmma m64n64k8, %d warpgroups an SM, 3 per commit and wait",
             groups);
    report(name, "TF32", sms, double(iters) * 3 * groups, 2.0 * 64 * 64 * 8,
           [&](long long* c) { wgmma_loop<3><<<sms, groups * 128, 65536>>>(out, c, iters); });
  }
  cudaFuncSetAttribute(wgmma_n32_loop<12>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  for (int groups : {1, 2, 4}) {
    const int iters = 3000;
    snprintf(name, sizeof name, "wgmma m64n32k8, %d warpgroups an SM, 12 per commit and wait",
             groups);
    report(name, "TF32", sms, double(iters) * 12 * groups, 2.0 * 64 * 32 * 8,
           [&](long long* c) { wgmma_n32_loop<12><<<sms, groups * 128, 65536>>>(out, c, iters); });
  }
  bf16_rates<64, true>(sms, out);
  bf16_rates<64, false>(sms, out);
  bf16_rates<128, true>(sms, out);
  bf16_rates<128, false>(sms, out);
  return 0;
}
