// K4: the temporal-blocked Task Bench megakernel. One launch runs S whole
// timesteps (depths) for K graphs on an M-row working buffer: at each depth
// every row combines its dependency rows of the previous depth's buffer,
// runs the grain body, and is kept only where the member is active.
//
// Replaces: src/repro/kernels/taskbench_step.py::_blocked_call (Pallas body
// `_blocked_step_kernel`; the phase wrappers taskbench_step_interior and
// taskbench_step_boundary launch it too).
//
// Operands (all contiguous, leading member axis K):
//   src  (K, M, P) f32     the working buffer at depth 0; never written
//   idx  (K, M, D) i32     gather / onehot: slot -> row of the buffer itself
//        (K, S, M, D)      time-varying: depth d uses table d (window reads
//                          no idx)
//   wgt  (K, M, D) f32     per-row weights (or (K, S, M, D), as idx)
//   act  (K, S) f32        member k runs depth d iff act[k, d] > 0.5; an
//                          inactive depth carries the buffer through
//   out  (K, M, P) f32     the buffer after S depths
//   tmp  (K, M, P) f32     scratch: depths ping-pong between out and tmp
// Combine modes:
//   window  out row i sums buffer rows i - h .. i + h times wgt[i, j]
//           (D = 2h + 1), rows outside [0, M) read as zero
//   gather, onehot  as in K3, on the buffer (combine.cuh's index rule)
//
// Bound on an H100: per launch each member reads src, the tables and act
// once and writes M*P floats; the compute body adds 2*iterations f32
// operations per element per depth, the memory body a shared-memory sweep
// of `scratch` floats per pass per row. At the main path's shape (M = 2144,
// P = 64, S = 8, grain 64) the bound is the FMA work, ~2 us.
//
// Design: a row at depth d + 1 may read any row of depth d (time-varying
// tables address the whole buffer), so depths are separated by a grid-wide
// barrier. The launch is cooperative and persistent: the grid holds as many
// CTAs as can be resident at once (occupancy x SMs), capped by the work of
// one depth, and grid-strides over (member, tile) work items; depths
// ping-pong through global memory (L2 at these sizes) with
// cooperative_groups' grid.sync() between them. The reference keeps a
// member's whole buffer in one program, which does not fit a CTA's shared
// memory at the main path's M and would leave all SMs but K idle. Compute
// and empty bodies run as K3's: 1024 consecutive elements per work item, 4
// register chains per thread. The memory body runs one row per work item:
// the combined row to shared memory, then tb::memory_sweep_row. A row's
// arithmetic depends only on its own inputs, never on M, its tile or the
// grid, so the pipelined runtime's phases give the same bits as one launch.
#include <cooperative_groups.h>

#include "bodies.cuh"
#include "combine.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WINDOW = 0;
constexpr int GATHER = 1;
constexpr int ONEHOT = 2;

constexpr int THREADS = 256;
constexpr int CHAINS = 4;
constexpr int TILE = THREADS * CHAINS;  // elements per compute work item

struct Args {
  const float* src;
  const int* idx;
  const float* wgt;
  const float* act;
  float* out;
  float* tmp;
  int K, M, P, D, S;
  int time_varying;
  int iterations;
  int scratch;
};

// The buffer depth d writes: the last depth writes `out`, and the depths
// before it alternate, so depth d never writes the buffer it reads.
__device__ __forceinline__ float* depth_dst(const Args& a, int d) {
  return ((a.S - 1 - d) & 1) == 0 ? a.out : a.tmp;
}

__device__ __forceinline__ const float* depth_src(const Args& a, int d) {
  return d == 0 ? a.src : depth_dst(a, d - 1);
}

// Combined value of element (i, c) of member k at depth d; buf points at the
// member's slice of the buffer depth d reads.
template <int MODE>
__device__ __forceinline__ float combine_at(const Args& a,
                                            const float* __restrict__ buf,
                                            int k, int d, int i, int c) {
  const size_t row0 = a.time_varying
                          ? (static_cast<size_t>(k) * a.S + d) * a.M
                          : static_cast<size_t>(k) * a.M;
  const float* wr = a.wgt + (row0 + i) * a.D;
  if constexpr (MODE == WINDOW) {
    const int h = (a.D - 1) / 2;
    float acc = 0.f;
    for (int j = 0; j < a.D; ++j) {
      const int r = i - h + j;
      if (r >= 0 && r < a.M)
        acc = fmaf(buf[static_cast<size_t>(r) * a.P + c], wr[j], acc);
    }
    return acc;
  } else {
    return tb::combine_slots<MODE == ONEHOT>(buf, a.idx + (row0 + i) * a.D, wr,
                                             a.M, a.P, a.D, c);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) blocked_compute_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const long long n = static_cast<long long>(a.M) * a.P;
  const long long tiles = (n + TILE - 1) / TILE;
  const long long items = tiles * a.K;
  for (int d = 0; d < a.S; ++d) {
    const float* cur = depth_src(a, d);
    float* nxt = depth_dst(a, d);
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int k = static_cast<int>(it / tiles);
      const long long e0 = (it % tiles) * TILE + threadIdx.x;
      const float* curk = cur + k * n;
      float* nxtk = nxt + k * n;
      const bool on = a.act[static_cast<size_t>(k) * a.S + d] > 0.5f;
      float v[CHAINS];
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) {
        const long long e = e0 + j * THREADS;
        v[j] = e >= n ? 0.f
               : on   ? combine_at<MODE>(a, curk, k, d, static_cast<int>(e / a.P),
                                         static_cast<int>(e % a.P))
                      : curk[e];
      }
      if (on) tb::fma_body(v, a.iterations);
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) {
        const long long e = e0 + j * THREADS;
        if (e < n) nxtk[e] = v[j];
      }
    }
    if (d + 1 < a.S) grid.sync();
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) blocked_memory_kernel(Args a) {
  extern __shared__ float smem[];
  float* row = smem;            // the combined row, P floats
  float* buf0 = smem + a.P;     // the sweep's two buffers
  float* buf1 = buf0 + a.scratch;
  cg::grid_group grid = cg::this_grid();
  const long long n = static_cast<long long>(a.M) * a.P;
  const long long items = static_cast<long long>(a.K) * a.M;
  for (int d = 0; d < a.S; ++d) {
    const float* cur = depth_src(a, d);
    float* nxt = depth_dst(a, d);
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const int k = static_cast<int>(it / a.M);
      const int i = static_cast<int>(it % a.M);
      const float* curk = cur + k * n;
      float* out_row = nxt + k * n + static_cast<size_t>(i) * a.P;
      if (a.act[static_cast<size_t>(k) * a.S + d] <= 0.5f) {
        for (int c = threadIdx.x; c < a.P; c += THREADS)
          out_row[c] = curk[static_cast<size_t>(i) * a.P + c];
        continue;  // uniform across the CTA
      }
      for (int c = threadIdx.x; c < a.P; c += THREADS)
        row[c] = combine_at<MODE>(a, curk, k, d, i, c);
      __syncthreads();
      tb::memory_sweep_row(row, out_row, a.P, a.iterations, a.scratch, buf0,
                           buf1);
    }
    if (d + 1 < a.S) grid.sync();
  }
}

// Cooperative launch of `kernel` over `items` work items per depth: as many
// CTAs as the card holds at once, and no more than there are items.
cudaError_t launch_cooperative(const void* kernel, Args a, long long items,
                               size_t smem, cudaStream_t stream) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long grid = static_cast<long long>(per_sm) * sms;
  if (items < grid) grid = items < 1 ? 1 : items;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const Args& a, int memory, cudaStream_t stream) {
  if (!memory) {
    const long long n = static_cast<long long>(a.M) * a.P;
    const long long items = (n + TILE - 1) / TILE * a.K;
    return launch_cooperative(
        reinterpret_cast<const void*>(blocked_compute_kernel<MODE>), a, items,
        0, stream);
  }
  const size_t smem =
      (static_cast<size_t>(a.P) + 2 * static_cast<size_t>(a.scratch)) *
      sizeof(float);
  return launch_cooperative(
      reinterpret_cast<const void*>(blocked_memory_kernel<MODE>), a,
      static_cast<long long>(a.K) * a.M, smem, stream);
}

}  // namespace

// mode: 0 window, 1 gather, 2 onehot. time_varying: idx/wgt are (K, S, M, D).
// memory: 0 runs the FMA body with `iterations` (0 for the empty body), 1
// the memory sweep.
extern "C" int taskbench_blocked(const float* src, const int* idx,
                                 const float* wgt, const float* act, float* out,
                                 float* tmp, int K, int M, int P, int D, int S,
                                 int mode, int time_varying, int memory,
                                 int iterations, int scratch, void* stream) {
  Args a{src, idx, wgt, act, out, tmp, K, M, P, D, S, time_varying,
         iterations, scratch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case WINDOW:
      err = launch<WINDOW>(a, memory, s);
      break;
    case GATHER:
      err = launch<GATHER>(a, memory, s);
      break;
    case ONEHOT:
      err = launch<ONEHOT>(a, memory, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
