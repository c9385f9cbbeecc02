// K1: the compute-bound Task Bench body, x <- 0.5*x + 0.1 iterated.
//
// Replaces: src/repro/kernels/taskbench_compute.py::taskbench_compute_pallas
// (Pallas body `_fma_kernel`).
//
// Bound on an H100: each element is read once and written once (8 bytes)
// and takes 2*iterations f32 operations, so the kernel is bound by HBM bytes
// below ~4 iterations per element (3.35 TB/s against 67 TFLOP/s) and by the
// FMA pipes above that.
//
// Design: the element array is flat; thread t owns the CHAINS elements
// t, t + q, t + 2q, t + 3q (q = ceil(n / CHAINS)), so each load and store
// instruction of a warp touches consecutive addresses and each thread keeps
// CHAINS independent FMA chains in registers for the whole grain. No shared
// memory: nothing is reused across threads.
#include "bodies.cuh"

namespace {

constexpr int CHAINS = 4;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    fma_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long n, long long q, int iterations) {
  const long long t = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (t >= q) return;
  float v[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    const long long e = t + j * q;
    v[j] = e < n ? x[e] : 0.f;
  }
  tb::fma_body(v, iterations);
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    const long long e = t + j * q;
    if (e < n) out[e] = v[j];
  }
}

}  // namespace

extern "C" int taskbench_compute(const float* x, float* out, long long n,
                                 int iterations, void* stream) {
  const long long q = (n + CHAINS - 1) / CHAINS;
  const long long blocks = (q + THREADS - 1) / THREADS;
  fma_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(x, out, n, q, iterations);
  return static_cast<int>(cudaGetLastError());
}
