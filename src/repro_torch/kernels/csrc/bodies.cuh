// Task-body device functions shared by the three Task Bench kernels.
//
// Counterpart of src/repro/kernels/bodies.py: one definition of each grain
// body, included by the FMA kernel (taskbench_compute.cu), the memory sweep
// (memory_bound.cu) and the single-step megakernel (taskbench_step.cu), so
// every kernel runs the same arithmetic. The plain PyTorch twins live in
// repro_torch/kernels/bodies.py.
#pragma once

#include <cuda_runtime.h>

#include "error.cuh"

namespace tb {

// x <- A*x + B. A = 0.5 is a power of two, so A*x is exact and fmaf rounds
// exactly like the plain version's multiply-then-add.
constexpr float FMA_A = 0.5f;
constexpr float FMA_B = 0.1f;
// The memory sweep's per-pass increment.
constexpr float SWEEP_ADD = 1e-6f;

// Iterated FMA over N independent values held in registers. Each value is a
// dependent chain of `iterations` FMAs, so N chains per thread give the
// scheduler N independent instructions to hide the FMA latency with.
template <int N>
__device__ __forceinline__ void fma_body(float (&v)[N], int iterations) {
  for (int i = 0; i < iterations; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = fmaf(v[j], FMA_A, FMA_B);
  }
}

// Block-cooperative memory sweep of one row; every thread of the block must
// call it. `row` holds the true payload (global or shared memory), `out`
// receives `payload` floats. buf0/buf1 are two shared buffers of `scratch`
// floats each.
//
// Semantics (bodies.py::memory_sweep_body): tile the payload out to
// `scratch` floats; `iterations` times roll the buffer right by one and add
// SWEEP_ADD; fold back by the mean over ceil(scratch / payload) repeats, the
// zero-padded tail counted in the denominator. iterations == 0 is the
// identity. Every pass is a full read and write of the buffer through the
// other buffer (no folding of passes, no index-offset roll): the body exists
// to move bytes.
__device__ __forceinline__ void memory_sweep_row(const float* row, float* out,
                                                 int payload, int iterations,
                                                 int scratch, float* buf0,
                                                 float* buf1) {
  if (iterations == 0) {
    for (int c = threadIdx.x; c < payload; c += blockDim.x) out[c] = row[c];
    __syncthreads();
    return;
  }
  for (int j = threadIdx.x; j < scratch; j += blockDim.x)
    buf0[j] = row[j % payload];
  __syncthreads();
  float* cur = buf0;
  float* nxt = buf1;
  for (int it = 0; it < iterations; ++it) {
    for (int j = threadIdx.x; j < scratch; j += blockDim.x)
      nxt[j] = cur[j == 0 ? scratch - 1 : j - 1] + SWEEP_ADD;
    // one barrier per pass: the next pass writes the buffer this one read
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  const int reps = (scratch + payload - 1) / payload;
  for (int c = threadIdx.x; c < payload; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < reps; ++r) {
      const int j = r * payload + c;
      if (j < scratch) s += cur[j];
    }
    out[c] = s / static_cast<float>(reps);
  }
  // the caller may reuse the buffers (and a shared `row`) for its next row
  __syncthreads();
}

}  // namespace tb
