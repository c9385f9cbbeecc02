// K2: the memory-bound Task Bench body (scratch sweep), one row per CTA.
//
// Replaces: src/repro/kernels/bodies.py::memory_bound_pallas (Pallas body
// `_memory_kernel`).
//
// Bound on an H100: HBM traffic is only the row in and the row out, so at
// any grain above zero the kernel is bound by shared-memory bandwidth: each
// pass reads and writes `scratch` floats of the row's working set.
//
// Design: one CTA per row holds the row's working set in shared memory as
// two buffers of `scratch` floats (16 KB at scratch 2048, so about a dozen
// CTAs fit on an SM) and ping-pongs between them, one __syncthreads() per
// pass. Neighbouring threads touch neighbouring words, so the passes are
// free of bank conflicts. The sweep itself is tb::memory_sweep_row, shared
// with the megakernel.
#include "bodies.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    memory_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int payload, int iterations, int scratch) {
  extern __shared__ float smem[];
  const long long base = static_cast<long long>(blockIdx.x) * payload;
  tb::memory_sweep_row(x + base, out + base, payload, iterations, scratch,
                       smem, smem + scratch);
}

}  // namespace

extern "C" int memory_bound(const float* x, float* out, int rows, int payload,
                            int iterations, int scratch, void* stream) {
  const size_t smem =
      iterations == 0 ? 0 : 2 * static_cast<size_t>(scratch) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        memory_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  memory_kernel<<<rows, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, payload, iterations, scratch);
  return static_cast<int>(cudaGetLastError());
}
