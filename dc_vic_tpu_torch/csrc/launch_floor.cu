// An empty kernel: the time from launch to finish that every kernel pays,
// measured with the same CUDA-event method as the real kernels. It is the
// lower bound of a launch-bound kernel such as K1 (vq_argmin), whose
// arithmetic takes a microsecond.
#include <cuda_runtime.h>

namespace {
__global__ void launch_floor_kernel() {}
}  // namespace

// One block of `threads` threads on `stream`. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dcvic_launch_floor(int blocks, int threads, void* stream) {
  launch_floor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
