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
// One-device halo wrap (halo >= 0): src is the un-extended (K, W, P) state,
// read as the logical extended source of S = W + 2 * halo rows: extended
// position p is state row (p - halo) mod W, a true modulo, so a table that
// reaches more than one ring away (W <= 2 * halo) stays exact. The index
// rule applies to that extended length. The result equals the same launch
// on the state halo-extended by a row gather, bit for bit (only addresses
// change). With halo < 0, src holds its S rows as they are.
//
// Design: compute and empty bodies run one thread per (member, row, C
// columns): thread t of member k owns row w = t / Q and columns Cq .. Cq +
// C - 1 (q = t - w * Q, Q = ceil(P / C)), 32-bit indices with one division
// a thread. C = 4 (the wrapper's plan for K * W * P large enough that every
// SM sub-partition still gets a warp, as K1's): a tap is one 16-byte load
// of its source row (one 16-byte store of the result) when P % 4 == 0 and
// src and out are 16-byte aligned, and a scalar path (a template instance
// picked at launch) takes any other payload or pointer; C = 1 below that,
// where chains of one column spread over the sub-partitions run at the
// FMA's latency (K1's design note). The thread reads its row's weights (and
// indices) once and walks the slots once (the onehot merge, combine.cuh's
// for_each_slot), applying each tap to its C columns, which are its C
// independent FMA chains; each column's taps keep the order of one fmaf
// chain from 0. The wrapper sizes the CTAs from the thread count and the SM
// count (taskbench_step.py::step_plan: at most 256 threads, as few as every
// SM getting a CTA takes), so W = 132 spreads over all 132 SMs. The source
// rows are read through L1 (each is read by up to D output rows); they are
// not staged in shared memory. The memory body runs one warp (a CTA) per
// output row: the combined row goes to shared memory, then
// tb::memory_sweep_warp sweeps the true payload in shared memory, as K2
// does. Gather and onehot follow the reference's index rule (combine.cuh:
// negative gather indices count from the end, then clamp; out-of-range
// onehot slots add nothing), so a bad table cannot read outside src.
#include "bodies.cuh"
#include "combine.cuh"

namespace {

constexpr int WINDOW = 0;
constexpr int GATHER = 1;
constexpr int ONEHOT = 2;
constexpr int PAIR = 3;

// One member's source rows: row(p) points at extended position p, wrapped
// onto the W state rows when halo >= 0. Positions lie in [0, W + 2 * halo),
// so with halo <= W one add or subtract of W is the modulo; a deeper halo
// (W < halo) takes the division.
struct Source {
  const float* base;
  int P, W, halo;

  __device__ __forceinline__ const float* row(int p) const {
    int r = p;
    if (halo >= 0) {
      r = p - halo;
      if (halo <= W) {
        r += r < 0 ? W : (r >= W ? -W : 0);
      } else {
        r %= W;
        if (r < 0) r += W;
      }
    }
    return base + static_cast<size_t>(r) * P;
  }
};

// Columns c .. c + C - 1 of a row: one 16-byte access (V, C = 4), or
// scalar accesses of the columns below P.
template <int C, bool V>
__device__ __forceinline__ void load_cols(float (&x)[C], const float* p, int c, int P) {
  if constexpr (V) {
    static_assert(C == 4, "a 16-byte access holds 4 columns");
    const float4 t = *reinterpret_cast<const float4*>(p + c);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) x[j] = c + j < P ? p[c + j] : 0.f;
  }
}

template <int C, bool V>
__device__ __forceinline__ void store_cols(float* p, int c, int P, const float (&x)[C]) {
  if constexpr (V) {
    static_assert(C == 4, "a 16-byte access holds 4 columns");
    *reinterpret_cast<float4*>(p + c) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (c + j < P) p[c + j] = x[j];
  }
}

template <int MODE, int C, bool V>
__global__ void __launch_bounds__(256)
    step_compute_kernel(const float* __restrict__ src,
                        const int* __restrict__ idx,
                        const float* __restrict__ wgt, float* __restrict__ out,
                        int S, int W, int P, int D, int iterations, int halo,
                        int Q) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * Q) return;
  const int k = blockIdx.y;
  const int w = t / Q;
  const int c = (t - w * Q) * C;
  const int rows = halo >= 0 ? W : S;  // src rows held in memory
  const Source s{src + static_cast<size_t>(k) * rows * P, P, W, halo};
  const size_t slots = (static_cast<size_t>(k) * W + w) * D;
  float v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = 0.f;
  auto tap = [&](int p, float wt) {
    float x[C];
    load_cols<C, V>(x, s.row(p), c, P);
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = fmaf(x[j], wt, v[j]);
  };
  if constexpr (MODE == PAIR) {
    float a[C], b[C];
    load_cols<C, V>(a, s.row(w), c, P);
    load_cols<C, V>(b, s.row(W + w), c, P);
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = (a[j] + b[j]) * 0.5f;
  } else if constexpr (MODE == WINDOW) {
    const float* wr = wgt + slots;
    for (int j = 0; j < D; ++j) tap(w + j, wr[j]);
  } else {
    tb::for_each_slot<MODE == ONEHOT>(idx + slots, wgt + slots, S, D, tap);
  }
  tb::fma_body(v, iterations);
  store_cols<C, V>(out + (static_cast<size_t>(k) * W + w) * P, c, P, v);
}

// The combined value at column c of output row w (scalar; the memory
// body's combine), in the compute kernel's order.
template <int MODE>
__device__ __forceinline__ float combine_elem(const Source& s,
                                              const int* __restrict__ ir,
                                              const float* __restrict__ wr,
                                              int S, int W, int D, int w, int c) {
  if constexpr (MODE == PAIR) {
    return (s.row(w)[c] + s.row(W + w)[c]) * 0.5f;
  } else if constexpr (MODE == WINDOW) {
    float acc = 0.f;
    for (int j = 0; j < D; ++j) acc = fmaf(s.row(w + j)[c], wr[j], acc);
    return acc;
  } else {
    return tb::combine_slots_by<MODE == ONEHOT>(
        [&](int r) { return s.row(r)[c]; }, ir, wr, S, D);
  }
}

template <int MODE>
__global__ void __launch_bounds__(32)
    step_memory_kernel(const float* __restrict__ src,
                       const int* __restrict__ idx,
                       const float* __restrict__ wgt, float* __restrict__ out,
                       int S, int W, int P, int D, int iterations,
                       int scratch, int halo) {
  extern __shared__ float4 smem4[];
  float* row = reinterpret_cast<float*>(smem4);  // the combined row
  float* buf0 = row + tb::round4(P);             // the sweep's two buffers
  float* buf1 = buf0 + tb::round4(scratch);
  const int k = blockIdx.y;
  const int w = blockIdx.x;
  const int rows = halo >= 0 ? W : S;
  const Source s{src + static_cast<size_t>(k) * rows * P, P, W, halo};
  const size_t slots = (static_cast<size_t>(k) * W + w) * D;
  const int* ir = idx == nullptr ? nullptr : idx + slots;
  for (int c = threadIdx.x; c < P; c += 32)
    row[c] = combine_elem<MODE>(s, ir, wgt + slots, S, W, D, w, c);
  __syncwarp();
  tb::memory_sweep_warp(row, out + (static_cast<size_t>(k) * W + w) * P, P,
                        iterations, scratch, buf0, buf1);
}

template <int MODE>
cudaError_t launch(const float* src, const int* idx, const float* wgt,
                   float* out, int K, int S, int W, int P, int D, int memory,
                   int iterations, int scratch, int halo, int chains,
                   int threads, cudaStream_t stream) {
  if (!memory) {
    if (threads < 1 || threads > 256 || (chains != 1 && chains != 4))
      return cudaErrorInvalidValue;
    const int Q = (P + chains - 1) / chains;
    const long long items = static_cast<long long>(W) * Q;
    dim3 grid(static_cast<unsigned>((items + threads - 1) / threads), K);
    const bool vec = P % 4 == 0 &&
                     ((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(out)) & 15) == 0;
    if (chains == 1)
      step_compute_kernel<MODE, 1, false><<<grid, threads, 0, stream>>>(
          src, idx, wgt, out, S, W, P, D, iterations, halo, Q);
    else if (vec)
      step_compute_kernel<MODE, 4, true><<<grid, threads, 0, stream>>>(
          src, idx, wgt, out, S, W, P, D, iterations, halo, Q);
    else
      step_compute_kernel<MODE, 4, false><<<grid, threads, 0, stream>>>(
          src, idx, wgt, out, S, W, P, D, iterations, halo, Q);
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
      src, idx, wgt, out, S, W, P, D, iterations, scratch, halo);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 window, 1 gather, 2 onehot, 3 pair. memory: 0 runs the FMA body
// with `iterations` (0 for the empty body), 1 the memory sweep. S: the
// source's (logical) rows. halo: >= 0 folds the one-device wrap (src holds
// the W state rows), < 0 reads src as it is. chains (columns a thread owns,
// 4 or 1) and threads (a CTA's): the compute body's launch (the wrapper's
// plan).
extern "C" int taskbench_step(const float* src, const int* idx,
                              const float* wgt, float* out, int K, int S,
                              int W, int P, int D, int mode, int memory,
                              int iterations, int scratch, int halo,
                              int chains, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
#define TB_CASE(M)                                                          \
  case M:                                                                   \
    err = launch<M>(src, idx, wgt, out, K, S, W, P, D, memory, iterations, \
                    scratch, halo, chains, threads, s);                     \
    break;
    TB_CASE(WINDOW)
    TB_CASE(GATHER)
    TB_CASE(ONEHOT)
    TB_CASE(PAIR)
#undef TB_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
