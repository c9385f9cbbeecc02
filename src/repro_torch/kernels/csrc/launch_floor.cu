// Two probes for `launch.kernel_times`' yardsticks; neither is a kernel of
// the port and no path calls them.
//
// launch_floor: a kernel that does nothing, timed with the method the port's
// kernels are timed with (CUDA events over many launches, queued behind a
// device sleep): the floor under every kernel's time at launch size.
//
// fma_latency: the dependent latency of the FMA the Task Bench body issues
// (fmaf(v, 0.5f, 0.1f), bodies.cuh), in SM clock cycles, read with clock64
// marks by one thread: a chain of n FMAs and one of 2n, cycles[0] and
// cycles[1], so that (cycles[1] - cycles[0]) / n leaves out the marks' own
// cost. The bound of a kernel whose chains are too few to fill the FMA pipes
// is iterations x this latency.
#include "bodies.cuh"

namespace {

__global__ void empty_kernel() {}

constexpr int UNROLL = 16;  // FMAs between the loop's own instructions

// n: a multiple of UNROLL.
__device__ __forceinline__ long long chain_cycles(float& v, int n) {
  const long long t0 = clock64();
  for (int i = 0; i < n; i += UNROLL) {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) v = fmaf(v, tb::FMA_A, tb::FMA_B);
  }
  // keeps the chain between the two marks in program order
  asm volatile("" : "+f"(v));
  const long long t1 = clock64();
  return t1 - t0;
}

__global__ void fma_latency_kernel(float* sink, long long* cycles, int n) {
  float v = sink[0];
  cycles[0] = chain_cycles(v, n);
  cycles[1] = chain_cycles(v, 2 * n);
  sink[1] = v;
}

}  // namespace

extern "C" int launch_floor(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// sink: 2 floats (sink[0] seeds the chain); cycles: 2 int64; n: a multiple
// of 16.
extern "C" int fma_latency(float* sink, long long* cycles, int n, void* stream) {
  fma_latency_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(sink, cycles, n);
  return static_cast<int>(cudaGetLastError());
}
