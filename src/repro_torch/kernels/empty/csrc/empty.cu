// An empty kernel: the yardstick for the fixed cost of one launch.
//
// Replaces no TPU kernel. chip_smoke.py times it with the same CUDA-event
// method as every kernel of the port, so the time of a launch that does no
// work stands beside the kernels' own times (the floor under small
// launches). No main path launches it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
