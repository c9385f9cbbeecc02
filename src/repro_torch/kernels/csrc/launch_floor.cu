// A kernel that does nothing. `launch.kernel_times` times its launch with
// the method it times the port's kernels with (CUDA events over many
// launches, queued behind a device sleep): the floor under every kernel's
// time at launch size. It is not a kernel of the port and no path calls it.
#include "error.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
