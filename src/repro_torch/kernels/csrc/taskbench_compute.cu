// K1: the compute-bound Task Bench body, x <- 0.5*x + 0.1 iterated.
//
// Replaces: src/repro/kernels/taskbench_compute.py::taskbench_compute_pallas
// (Pallas body `_fma_kernel`).
//
// Bound on an H100: each element is read once and written once (8 bytes)
// and takes 2*iterations f32 operations, so the kernel is bound by HBM bytes
// below ~4 iterations per element (3.35 TB/s against 67 TFLOP/s) and by the
// FMA pipes above that; and each element is one chain of `iterations`
// dependent FMAs, so where the elements are too few to fill the card's FMA
// pipes, by iterations x the FMA's latency.
//
// Design: thread t owns C consecutive elements, its C independent FMA
// chains. C = 4 (the wrapper's plan for a large n): one 16-byte load and one
// 16-byte store when both pointers are 16-byte aligned, a scalar path in the
// same launch for a ragged last thread (n % 4 != 0) and unaligned pointers.
// C = 1 where the elements are too few to give every SM sub-partition a
// warp of 4-chain threads (n < 132 SMs x 4 sub-partitions x 32 lanes x 4):
// there a lone warp issuing 4 chains is bound by its issue rate, while
// threads of one chain spread over the sub-partitions run at the FMA's
// latency. The wrapper sizes the CTAs from the threads and the SM count
// (taskbench_compute.py::compute_plan): at most 256 threads a CTA, and as
// few as it takes for every SM to get a CTA, so a small n (8448 elements at
// 132 rows) still spreads over all SMs. No shared memory: nothing is reused
// across threads.
#include "bodies.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(256)
    fma_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long n, int iterations, int vec) {
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * C;
  if (e0 >= n) return;
  float v[C];
  bool full = false;  // one 16-byte load and store
  if constexpr (C == 4) {
    full = vec && e0 + C <= n;
    if (full) {
      const float4 t = *reinterpret_cast<const float4*>(x + e0);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    }
  }
  if (!full) {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = e0 + j < n ? x[e0 + j] : 0.f;
  }
  tb::fma_body(v, iterations);
  if constexpr (C == 4) {
    if (full) {
      *reinterpret_cast<float4*>(out + e0) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (e0 + j < n) out[e0 + j] = v[j];
}

}  // namespace

// chains: elements a thread owns, 4 or 1; threads: per CTA (the wrapper's
// plan); vec: 1 when x and out are both 16-byte aligned, 0 for the scalar
// path.
extern "C" int taskbench_compute(const float* x, float* out, long long n,
                                 int iterations, int chains, int threads,
                                 int vec, void* stream) {
  if (threads < 1 || threads > 256 || (chains != 1 && chains != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = (n + chains - 1) / chains;
  const unsigned blocks = static_cast<unsigned>((items + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chains == 4)
    fma_kernel<4><<<blocks, threads, 0, s>>>(x, out, n, iterations, vec);
  else
    fma_kernel<1><<<blocks, threads, 0, s>>>(x, out, n, iterations, vec);
  return static_cast<int>(cudaGetLastError());
}
