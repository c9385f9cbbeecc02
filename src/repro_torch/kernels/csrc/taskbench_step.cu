// K3: the single-step Task Bench megakernel. One launch runs one whole
// timestep for K graphs: combine each output row's dependency rows of the
// previous state, then run the grain body on the combined row.
//
// Replaces: src/repro/kernels/taskbench_step.py::taskbench_step_pallas at
// steps_per_launch = 1 (Pallas body `_step_kernel`).
//
// Operands (all contiguous, leading member axis K):
//   src (K, S, P) f32   previous-state rows to combine from
//   idx (K, W, D) i32   gather / onehot: dependency slot -> src row
//                       (window and pair read no idx)
//   wgt (K, W, D) f32   pre-normalised weights: the masked mean is one
//                       weighted sum; rows with no dependencies are
//                       self-padded host-side, so there is no branch here
//   out (K, W, P) f32
// Combine modes:
//   window  out row w sums src rows w .. w + D - 1 times wgt[w, j]
//   gather  out row w sums src rows idx[w, j] times wgt[w, j]
//   onehot  the same weighted sum with duplicate slots merged first, as the
//           reference's one-hot matrix (W, S) @ src computes it
//   pair    (src row w + src row W + w) * 0.5
//
// Bound on an H100: per step each member reads its src rows (each once, in
// the best case) and the weights, and writes W*P floats; the compute body
// adds 2*iterations f32 operations per element, the memory body a
// shared-memory sweep of `scratch` floats per pass per row. At the fine
// grains METG is read at, the bound is HBM bytes, and far below that the
// launch itself.
//
// Design: compute and empty bodies run one CTA per 1024 consecutive output
// elements of a member (grid x: element tiles, grid y: member); each thread
// combines 4 elements a CTA-width apart (coalesced loads of src, weights
// broadcast from L1 within a row) and runs the FMA body on them as 4
// independent register chains. The memory body runs one warp (a CTA) per
// output row: the combined row goes to shared memory, then
// tb::memory_sweep_warp sweeps the true payload in shared memory, as K2
// does. Gather and onehot follow
// the reference's index rule (combine.cuh: negative gather indices count
// from the end, then clamp; out-of-range onehot slots add nothing), so a
// bad table cannot read outside src.
#include "bodies.cuh"
#include "combine.cuh"

namespace {

constexpr int WINDOW = 0;
constexpr int GATHER = 1;
constexpr int ONEHOT = 2;
constexpr int PAIR = 3;

constexpr int THREADS = 256;
constexpr int CHAINS = 4;
constexpr int TILE = THREADS * CHAINS;  // output elements per compute CTA

// The combined value of output element (w, c) of one member; src, idx and
// wgt already point at the member's slices.
template <int MODE>
__device__ __forceinline__ float combine_elem(const float* __restrict__ src,
                                              const int* __restrict__ idx,
                                              const float* __restrict__ wgt,
                                              int S, int W, int P, int D,
                                              int w, int c) {
  if constexpr (MODE == PAIR) {
    return (src[static_cast<size_t>(w) * P + c] +
            src[static_cast<size_t>(W + w) * P + c]) * 0.5f;
  } else if constexpr (MODE == WINDOW) {
    const float* wr = wgt + static_cast<size_t>(w) * D;
    float acc = 0.f;
    for (int j = 0; j < D; ++j)
      acc = fmaf(src[static_cast<size_t>(w + j) * P + c], wr[j], acc);
    return acc;
  } else {
    return tb::combine_slots<MODE == ONEHOT>(
        src, idx + static_cast<size_t>(w) * D, wgt + static_cast<size_t>(w) * D,
        S, P, D, c);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    step_compute_kernel(const float* __restrict__ src,
                        const int* __restrict__ idx,
                        const float* __restrict__ wgt, float* __restrict__ out,
                        int S, int W, int P, int D, int iterations) {
  const int k = blockIdx.y;
  const float* srck = src + static_cast<size_t>(k) * S * P;
  const int* idxk = idx == nullptr ? nullptr : idx + static_cast<size_t>(k) * W * D;
  const float* wgtk = wgt + static_cast<size_t>(k) * W * D;
  float* outk = out + static_cast<size_t>(k) * W * P;
  const long long n = static_cast<long long>(W) * P;
  const long long e0 = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  float v[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    const long long e = e0 + j * THREADS;
    v[j] = e < n ? combine_elem<MODE>(srck, idxk, wgtk, S, W, P, D,
                                      static_cast<int>(e / P),
                                      static_cast<int>(e % P))
                 : 0.f;
  }
  tb::fma_body(v, iterations);
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    const long long e = e0 + j * THREADS;
    if (e < n) outk[e] = v[j];
  }
}

template <int MODE>
__global__ void __launch_bounds__(32)
    step_memory_kernel(const float* __restrict__ src,
                       const int* __restrict__ idx,
                       const float* __restrict__ wgt, float* __restrict__ out,
                       int S, int W, int P, int D, int iterations,
                       int scratch) {
  extern __shared__ float4 smem4[];
  float* row = reinterpret_cast<float*>(smem4);  // the combined row
  float* buf0 = row + tb::round4(P);             // the sweep's two buffers
  float* buf1 = buf0 + tb::round4(scratch);
  const int k = blockIdx.y;
  const int w = blockIdx.x;
  const float* srck = src + static_cast<size_t>(k) * S * P;
  const int* idxk = idx == nullptr ? nullptr : idx + static_cast<size_t>(k) * W * D;
  const float* wgtk = wgt + static_cast<size_t>(k) * W * D;
  for (int c = threadIdx.x; c < P; c += 32)
    row[c] = combine_elem<MODE>(srck, idxk, wgtk, S, W, P, D, w, c);
  __syncwarp();
  tb::memory_sweep_warp(row, out + (static_cast<size_t>(k) * W + w) * P, P,
                        iterations, scratch, buf0, buf1);
}

template <int MODE>
cudaError_t launch(const float* src, const int* idx, const float* wgt,
                   float* out, int K, int S, int W, int P, int D, int memory,
                   int iterations, int scratch, cudaStream_t stream) {
  if (!memory) {
    const long long tiles = (static_cast<long long>(W) * P + TILE - 1) / TILE;
    dim3 grid(static_cast<unsigned>(tiles), K);
    step_compute_kernel<MODE><<<grid, THREADS, 0, stream>>>(
        src, idx, wgt, out, S, W, P, D, iterations);
    return cudaGetLastError();
  }
  const size_t smem = tb::sweep_floats(P, scratch) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      step_memory_kernel<MODE>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(step_memory_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(W, K);
  step_memory_kernel<MODE><<<grid, 32, smem, stream>>>(
      src, idx, wgt, out, S, W, P, D, iterations, scratch);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 window, 1 gather, 2 onehot, 3 pair. memory: 0 runs the FMA body
// with `iterations` (0 for the empty body), 1 the memory sweep.
extern "C" int taskbench_step(const float* src, const int* idx,
                              const float* wgt, float* out, int K, int S,
                              int W, int P, int D, int mode, int memory,
                              int iterations, int scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case WINDOW:
      err = launch<WINDOW>(src, idx, wgt, out, K, S, W, P, D, memory,
                           iterations, scratch, s);
      break;
    case GATHER:
      err = launch<GATHER>(src, idx, wgt, out, K, S, W, P, D, memory,
                           iterations, scratch, s);
      break;
    case ONEHOT:
      err = launch<ONEHOT>(src, idx, wgt, out, K, S, W, P, D, memory,
                           iterations, scratch, s);
      break;
    case PAIR:
      err = launch<PAIR>(src, idx, wgt, out, K, S, W, P, D, memory,
                         iterations, scratch, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
