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
// P = 64, S = 8, grain 64) the bound is the FMA work, ~2.3 us; the tiled
// form adds the halo rows it recomputes (~10% there).
//
// Three forms, each with its own C entry and launch counter; the host picks
// one (taskbench_step.blocked_form) before the launch:
//
// Tiled (taskbench_blocked_tiled): tables fixed across depths whose reach,
// the farthest row a row's taps read, is at most r (the window's
// D - 1 - (D - 1) / 2, or the `reach` the caller declares for gather and
// onehot), with the compute or empty body. An ordinary launch, no grid
// barrier: each CTA of 512 threads owns output rows [t0, t1) of one member
// and a slice of the payload columns, copies rows [t0 - S*r, t1 + S*r) of
// `src` (clipped to [0, M)) with their weights and indices into shared
// memory once (cp.async, all in flight together), and runs all S depths
// there, depth d computing rows [t0 - (S-1-d)*r, t1 + (S-1-d)*r), the span
// whose taps the span before it holds; two shared buffers ping-pong, a
// __syncthreads() between depths; only [t0, t1) is written out. A warp
// runs as many register chains as hold its elements of a depth. The
// combine never mixes columns and the bodies are elementwise, so a column
// slice is free; the host (taskbench_step.plan_tiles) picks the tile rows
// and the slice width from the SM count, the shared-memory budget and the
// halo's recomputation (2144 rows, S = 8, r = 2: 16 tiles of 134 rows x 8
// slices of 8 columns, 128 CTAs). A tap outside the declared reach reads
// NaN, so a table that breaks its promise gives no silently wrong rows.
//
// Resident (taskbench_blocked_resident): any table, fixed (K, M, D) or
// time-varying (K, S, M, D), of any reach (all_to_all's D = M too), with
// the compute or empty body. One thread block cluster of C CTAs (C in 1, 2,
// 4, 8, 16) per (member, column slice) holds all M rows of its slice for
// all S depths: CTA `rank` owns rows [rank * R, (rank + 1) * R), R =
// ceil(M / C), in two shared buffers that ping-pong between depths, and
// copies them from `src` once (cp.async, 16-byte pieces where the slice
// allows), with its rows' weights and indices for every depth where they
// fit the budget (else they are read from global memory, each entry once
// per row for the slice's columns, through L1). A tap on a row another CTA
// owns reads that CTA's shared memory (distributed shared memory), so the
// buffer never goes back to L2 between depths and no row is recomputed.
// A thread's item is 4 columns of one row where the slice moves 16 bytes
// at a time (else 1), so a tap's owner and address are found once for the
// item; an item's taps (up to 8 slots) are all loaded before they are
// summed, so a remote row costs one round trip an item, not one a tap; a
// window row whose taps all lie in the CTA's own rows reads them straight
// from its buffer.
// Depths are separated by the cluster's hardware barrier
// (barrier.cluster.arrive.release after a depth's last store,
// barrier.cluster.wait.acquire before the next depth's first read;
// __syncthreads() at C = 1); one barrier a depth suffices for the
// ping-pong, and the last active depth's barrier keeps every CTA's shared
// memory alive until the cluster has read it. Only the last depth is
// written to `out`. An ordinary cluster launch (cudaLaunchKernelEx), no
// grid barrier, capturable; the host (taskbench_step.plan_resident) picks C
// and the slice width from the SMs (and co-resident clusters) it is given
// and the 227 KB budget, and refuses a buffer no cluster holds.
//
// Cooperative (taskbench_blocked): any table, and the memory body, whose
// sweep mixes a row's columns and is bound by shared memory, which a
// cluster of at most 16 SMs would starve; also any buffer no cluster
// holds. A persistent cooperative launch, as many CTAs as the card holds
// at once, grid-striding over (member, tile) work items; depths ping-pong
// through global memory (L2 at these sizes) with cooperative_groups'
// grid.sync() between them. Compute and empty bodies run as K3's: 1024
// consecutive elements per work item, 4 register chains per thread; the
// memory body runs a row per warp: the combined row to shared memory, then
// tb::memory_sweep_warp.
//
// In every form a row's arithmetic depends only on its own inputs (taps in
// the same order, fmaf, the same body), never on M, its tile, its cluster
// or the grid: the forms give the same bits, and so do the pipelined
// runtime's phases and one launch.
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
constexpr int MEM_WARPS = 4;            // rows in flight per memory CTA, at most
constexpr int TILED_THREADS = 512;      // threads of a tiled CTA
constexpr int MAX_CHAINS = 8;           // register chains per tiled thread

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
__global__ void __launch_bounds__(MEM_WARPS * 32) blocked_memory_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = reinterpret_cast<float*>(smem4) + warp * tb::sweep_floats(a.P, a.scratch);
  float* buf0 = row + tb::round4(a.P);  // the sweep's two buffers
  float* buf1 = buf0 + tb::round4(a.scratch);
  cg::grid_group grid = cg::this_grid();
  const long long n = static_cast<long long>(a.M) * a.P;
  const long long items = static_cast<long long>(a.K) * a.M;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (int d = 0; d < a.S; ++d) {
    const float* cur = depth_src(a, d);
    float* nxt = depth_dst(a, d);
    for (long long it = static_cast<long long>(warp) * gridDim.x + blockIdx.x;
         it < items; it += warps) {
      const int k = static_cast<int>(it / a.M);
      const int i = static_cast<int>(it % a.M);
      const float* curk = cur + k * n;
      float* out_row = nxt + k * n + static_cast<size_t>(i) * a.P;
      if (a.act[static_cast<size_t>(k) * a.S + d] <= 0.5f) {
        for (int c = lane; c < a.P; c += 32)
          out_row[c] = curk[static_cast<size_t>(i) * a.P + c];
        continue;  // uniform across the warp
      }
      for (int c = lane; c < a.P; c += 32)
        row[c] = combine_at<MODE>(a, curk, k, d, i, c);
      __syncwarp();
      tb::memory_sweep_warp(row, out_row, a.P, a.iterations, a.scratch, buf0,
                            buf1);
    }
    if (d + 1 < a.S) grid.sync();
  }
}

// Cooperative launch of `kernel` over `items` work items per depth: as many
// CTAs as the card holds at once, and no more than there are items.
cudaError_t launch_cooperative(const void* kernel, Args a, long long items,
                               int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err;
  if (smem > 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
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
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long grid = static_cast<long long>(per_sm) * sms;
  if (items < grid) grid = items < 1 ? 1 : items;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)),
                                    dim3(threads), args, smem, stream);
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
        THREADS, 0, stream);
  }
  // as many rows a CTA as fit its shared memory, up to MEM_WARPS
  const size_t row_bytes = tb::sweep_floats(a.P, a.scratch) * sizeof(float);
  int dev = 0, smem_max = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
    return err;
  const int per_cta = static_cast<int>(
      row_bytes * MEM_WARPS <= static_cast<size_t>(smem_max) ? MEM_WARPS
                                                             : smem_max / row_bytes);
  if (per_cta < 1) return cudaErrorInvalidValue;  // one row's sweep does not fit
  const long long rows = static_cast<long long>(a.K) * a.M;
  return launch_cooperative(
      reinterpret_cast<const void*>(blocked_memory_kernel<MODE>), a,
      (rows + per_cta - 1) / per_cta, per_cta * 32, per_cta * row_bytes, stream);
}

// ------------------------------------------------------------ tiled form

struct TiledArgs {
  const float* src;
  const int* idx;
  const float* wgt;
  const float* act;
  float* out;
  int K, M, P, D, S;
  int reach;       // the farthest row a tap reads, in rows
  int iterations;  // the FMA body's (0: the empty body)
  int tile_rows;   // output rows per CTA
  int col_shift;   // log2 of the column slice's width
  int n_slices;    // column slices per member
};

// Rows [lo, lo + L) of one member's buffer, columns [c0, c0 + cw), held in
// shared memory row by row at a stride of 1 << col_shift floats.
struct Tile {
  int t0, t1;  // the output rows
  int lo;      // the first loaded row
  int c0, cw;  // the column slice
  int sh;      // col_shift
};

// Shared-memory floats of a tile of L loaded rows: two buffers of L rows of
// 1 << col_shift floats, the rows' weights and (gather/onehot) indices.
__host__ __device__ inline size_t tiled_smem_floats(int L, int col_shift, int D,
                                                    bool uses_idx) {
  return (2 * (static_cast<size_t>(L) << col_shift) +
          static_cast<size_t>(L) * D * (uses_idx ? 2 : 1));
}

// The combined value of row i, column c (tile-local) at one depth; `cur`
// holds the previous depth's rows, ws/is the rows' weights and indices. DW
// is the window's D when it is known at compile time (0: a.D at run time);
// its taps are read together and summed in order, as the loop sums them.
template <int MODE, int DW>
__device__ __forceinline__ float tiled_combine(const TiledArgs& a,
                                               const Tile& t,
                                               const float* __restrict__ cur,
                                               const float* __restrict__ ws,
                                               const int* __restrict__ is,
                                               int i, int c) {
  const float* wr = ws + (i - t.lo) * a.D;
  if constexpr (MODE == WINDOW) {
    float acc = 0.f;
    if constexpr (DW > 0) {
      constexpr int h = (DW - 1) / 2;
      float x[DW];
      if (i >= h && i - h + DW <= a.M) {  // every tap inside the buffer
        const float* p = cur + ((i - h - t.lo) << t.sh) + c;
        const int stride = 1 << t.sh;
#pragma unroll
        for (int j = 0; j < DW; ++j) x[j] = p[j * stride];
#pragma unroll
        for (int j = 0; j < DW; ++j) acc = fmaf(x[j], wr[j], acc);
        return acc;
      }
#pragma unroll
      for (int j = 0; j < DW; ++j) {
        const int r = i - h + j;
        x[j] = (r >= 0 && r < a.M) ? cur[((r - t.lo) << t.sh) + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < DW; ++j) {
        const int r = i - h + j;
        if (r >= 0 && r < a.M) acc = fmaf(x[j], wr[j], acc);
      }
    } else {
      const int h = (a.D - 1) / 2;
      for (int j = 0; j < a.D; ++j) {
        const int r = i - h + j;
        if (r >= 0 && r < a.M)
          acc = fmaf(cur[((r - t.lo) << t.sh) + c], wr[j], acc);
      }
    }
    return acc;
  } else {
    const int reach = a.reach;
    return tb::combine_slots_by<MODE == ONEHOT>(
        [=](int r) {
          return (r < i - reach || r > i + reach)
                     ? __int_as_float(0x7fffffff)  // outside the promise: NaN
                     : cur[((r - t.lo) << t.sh) + c];
        },
        is + (i - t.lo) * a.D, wr, a.M, a.D);
  }
}

// The NC chains of one warp in a group of a depth's span: chain j takes
// element e = e0 + j * TILED_THREADS + threadIdx.x, row r0 + (e >> sh),
// column e & (width - 1) of the slice.
template <int MODE, int DW, int NC>
__device__ __forceinline__ void tiled_chains(const TiledArgs& a, const Tile& t,
                                             const float* __restrict__ cur,
                                             float* __restrict__ nxt,
                                             const float* __restrict__ ws,
                                             const int* __restrict__ is,
                                             int r0, int e0, int n) {
  const int mask = (1 << t.sh) - 1;
  float v[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int e = e0 + j * TILED_THREADS + threadIdx.x;
    const int c = e & mask;
    v[j] = (e < n && c < t.cw)
               ? tiled_combine<MODE, DW>(a, t, cur, ws, is, r0 + (e >> t.sh), c)
               : 0.f;
  }
  tb::fma_body(v, a.iterations);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int e = e0 + j * TILED_THREADS + threadIdx.x;
    if (e < n && (e & mask) < t.cw)
      nxt[((r0 - t.lo) << t.sh) + e] = v[j];
  }
}

template <int MODE, int DW>
__global__ void __launch_bounds__(TILED_THREADS)
    blocked_tiled_kernel(TiledArgs a) {
  extern __shared__ float4 smem4[];
  const int k = blockIdx.y;
  const int tile = blockIdx.x / a.n_slices;
  const int slice = blockIdx.x - tile * a.n_slices;
  Tile t;
  t.sh = a.col_shift;
  t.t0 = tile * a.tile_rows;
  t.t1 = min(a.M, t.t0 + a.tile_rows);
  t.c0 = slice << t.sh;
  t.cw = min(1 << t.sh, a.P - t.c0);
  const int halo = a.S * a.reach;
  t.lo = max(0, t.t0 - halo);
  const int L = min(a.M, t.t1 + halo) - t.lo;
  const int width = 1 << t.sh;
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + (L << t.sh);
  float* ws = buf1 + (L << t.sh);
  int* is = reinterpret_cast<int*>(ws + L * a.D);
  const size_t row0 = static_cast<size_t>(k) * a.M + t.lo;
  // the loaded span: src rows with their columns of the slice, weights and
  // (gather/onehot) indices, once, all copies in flight together
  for (int e = threadIdx.x; e < (L << t.sh); e += TILED_THREADS) {
    const int c = e & (width - 1);
    if (c < t.cw)
      tb::copy_async4(buf0 + e, a.src + (row0 + (e >> t.sh)) * a.P + t.c0 + c);
    else
      buf0[e] = 0.f;
  }
  for (int e = threadIdx.x; e < L * a.D; e += TILED_THREADS) {
    tb::copy_async4(ws + e, a.wgt + row0 * a.D + e);
    if constexpr (MODE != WINDOW)
      tb::copy_async4(reinterpret_cast<float*>(is + e),
                      reinterpret_cast<const float*>(a.idx + row0 * a.D + e));
  }
  tb::commit_async();
  tb::wait_async<0>();
  __syncthreads();
  float* cur = buf0;
  float* nxt = buf1;
  const int warp0 = threadIdx.x & ~31;  // this warp's first thread
  const float* act = a.act + static_cast<size_t>(k) * a.S;
  float on = act[0];
  for (int d = 0; d < a.S; ++d) {
    const float on_d = on;
    if (d + 1 < a.S) on = act[d + 1];  // the next depth's, read ahead
    // an inactive depth carries the buffer through: keep `cur`
    if (on_d <= 0.5f) continue;
    const int ext = (a.S - 1 - d) * a.reach;
    const int r0 = max(0, t.t0 - ext);
    const int n = (min(a.M, t.t1 + ext) - r0) << t.sh;
    for (int e0 = 0; e0 < n; e0 += TILED_THREADS * MAX_CHAINS) {
      // a warp runs as many chains as hold an element of its
      const int left = n - e0 - warp0;
      const int nc =
          left <= 0 ? 0 : min(MAX_CHAINS, (left + TILED_THREADS - 1) / TILED_THREADS);
      switch (nc) {
        case 0: break;
        case 1: tiled_chains<MODE, DW, 1>(a, t, cur, nxt, ws, is, r0, e0, n); break;
        case 2: tiled_chains<MODE, DW, 2>(a, t, cur, nxt, ws, is, r0, e0, n); break;
        case 3: tiled_chains<MODE, DW, 3>(a, t, cur, nxt, ws, is, r0, e0, n); break;
        case 4: tiled_chains<MODE, DW, 4>(a, t, cur, nxt, ws, is, r0, e0, n); break;
        case 5: tiled_chains<MODE, DW, 5>(a, t, cur, nxt, ws, is, r0, e0, n); break;
        case 6: tiled_chains<MODE, DW, 6>(a, t, cur, nxt, ws, is, r0, e0, n); break;
        case 7: tiled_chains<MODE, DW, 7>(a, t, cur, nxt, ws, is, r0, e0, n); break;
        default: tiled_chains<MODE, DW, 8>(a, t, cur, nxt, ws, is, r0, e0, n); break;
      }
    }
    // the next depth reads what this one wrote, and writes what it read
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < ((t.t1 - t.t0) << t.sh); e += TILED_THREADS) {
    const int c = e & (width - 1);
    if (c < t.cw)
      a.out[(static_cast<size_t>(k) * a.M + t.t0 + (e >> t.sh)) * a.P + t.c0 + c] =
          cur[((t.t0 - t.lo) << t.sh) + e];
  }
}

template <int MODE, int DW>
cudaError_t launch_tiled(const TiledArgs& a, cudaStream_t stream) {
  const int n_tiles = (a.M + a.tile_rows - 1) / a.tile_rows;
  const int L = min(a.M, a.tile_rows + 2 * a.S * a.reach);
  const size_t smem =
      tiled_smem_floats(L, a.col_shift, a.D, MODE != WINDOW) * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(blocked_tiled_kernel<MODE, DW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(static_cast<unsigned>(n_tiles) * a.n_slices, a.K);
  blocked_tiled_kernel<MODE, DW><<<grid, TILED_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------- resident form

constexpr int RES_THREADS = 512;  // threads of a resident CTA
constexpr int MAX_CLUSTER = 16;   // the largest (non-portable) cluster

struct ResidentArgs {
  const float* src;
  const int* idx;
  const float* wgt;
  const float* act;
  float* out;
  int K, M, P, D, S;
  int time_varying;
  int iterations;   // the FMA body's (0: the empty body)
  int rows;         // rows a CTA owns, R = ceil(M / cluster)
  int col_shift;    // log2 of the column slice's width
  int n_slices;     // column slices per member
  int cluster;      // CTAs per cluster, C
  int tables_smem;  // 1: the CTA's rows' tables (every depth's) in shared memory
  int vec;          // 1: src rows copied and out rows stored 16 bytes at a time
};

// Shared-memory floats of a resident CTA: two buffers of R rows of
// 1 << col_shift floats and, with `tables`, the rows' weights and
// (gather/onehot) indices of T tables (S time-varying ones, or the one).
__host__ __device__ inline size_t resident_smem_floats(int R, int col_shift, int D,
                                                       int T, bool uses_idx,
                                                       bool tables) {
  return 2 * (static_cast<size_t>(R) << col_shift) +
         (tables ? static_cast<size_t>(T) * R * D * (uses_idx ? 2 : 1) : 0);
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src));
}

// The cluster's barrier: every thread of every CTA arrives (its stores
// before it released) and waits (the others' stores acquired after it).
__device__ __forceinline__ void cluster_barrier(int C) {
  if (C == 1) {
    __syncthreads();
    return;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// What a resident CTA knows of its place: member k, its rank in the
// cluster, its rows [r0, r0 + R) and its column slice [c0, c0 + cw).
struct Place {
  int k, rank, r0, R, c0, cw, sh;
  int nr;      // the rows this CTA owns (a trailing rank may own none)
  float invR;  // 1 / R, for the owner of a row without an integer division
};

// The CTA of the cluster that owns row r: r / R, from a float product
// corrected by one step (exact for the rows a launch can hold).
__device__ __forceinline__ int owner_of(const Place& p, int r) {
  int o = __float2int_rz(__int2float_rn(r) * p.invR);
  if (o * p.R > r) --o;
  else if ((o + 1) * p.R <= r) ++o;
  return o;
}

// The weights (and indices) of owned row i at table t.
struct RowTables {
  const float* w;
  const int* ix;
};

__device__ __forceinline__ RowTables row_tables(const ResidentArgs& a, const Place& p,
                                                const float* ws, const int* is, int t,
                                                int i) {
  if (a.tables_smem) {
    const size_t o = (static_cast<size_t>(t) * p.R + (i - p.r0)) * a.D;
    return {ws + o, is + o};
  }
  const int T = a.time_varying ? a.S : 1;
  const size_t o = ((static_cast<size_t>(p.k) * T + t) * a.M + i) * a.D;
  return {a.wgt + o, a.idx == nullptr ? nullptr : a.idx + o};
}

// V consecutive floats of a resident buffer (V = 4: one 16-byte access;
// the row stride and the column are multiples of 4 floats there).
template <int V>
__device__ __forceinline__ void load_v(float (&x)[V], const float* q) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(q);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = q[v];
  }
}

// The combined values of owned row i, columns c .. c + V - 1 of the slice,
// at one depth, into acc: the taps read the previous depth's buffer `cur`
// of the CTA that owns each row (its own, or another's through distributed
// shared memory), each tap's owner and address found once for the V
// columns. Each column sums its taps in slot order with fmaf, as the other
// forms do. DW is the window's D when known at compile time (0: a.D).
template <int MODE, int DW, int V>
__device__ __forceinline__ void resident_combine(const ResidentArgs& a, const Place& p,
                                                 const float* __restrict__ cur,
                                                 const RowTables& tb_row, int i, int c,
                                                 float (&acc)[V]) {
  cg::cluster_group cluster = cg::this_cluster();
  // a row this CTA owns is read from its own buffer, any other from the
  // owner's, mapped into the cluster's shared window
  auto read = [&](float (&x)[V], int r) {
    const bool own = static_cast<unsigned>(r - p.r0) < static_cast<unsigned>(p.nr);
    const int o = own ? p.rank : owner_of(p, r);
    const float* q = cur + ((r - o * p.R) << p.sh) + c;
    load_v<V>(x, own ? q : cluster.map_shared_rank(q, o));
  };
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  const float* wr = tb_row.w;
  if constexpr (MODE == WINDOW) {
    const int D = DW > 0 ? DW : a.D;
    const int h = (D - 1) / 2;
    if (i - h >= p.r0 && i - h + D <= p.r0 + p.nr) {
      // every tap on an owned row (all but the rows at the CTA's edges):
      // the taps read together from this CTA's buffer, summed in order
      const float* base = cur + ((i - h - p.r0) << p.sh) + c;
      if constexpr (DW > 0) {
        float x[DW][V];
#pragma unroll
        for (int j = 0; j < DW; ++j) load_v<V>(x[j], base + (j << p.sh));
#pragma unroll
        for (int j = 0; j < DW; ++j) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(x[j][v], wr[j], acc[v]);
        }
      } else {
        for (int j = 0; j < D; ++j) {
          float x[V];
          load_v<V>(x, base + (j << p.sh));
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(x[v], wr[j], acc[v]);
        }
      }
      return;
    }
    if constexpr (DW > 0) {
      // a row at the CTA's edge: every tap's load in flight together (a
      // tap outside the buffer loads row i and adds nothing), then the sum
      // in order
      float x[DW][V];
#pragma unroll
      for (int j = 0; j < DW; ++j) {
        const int r = i - h + j;
        read(x[j], r >= 0 && r < a.M ? r : i);
      }
#pragma unroll
      for (int j = 0; j < DW; ++j) {
        const int r = i - h + j;
        if (r >= 0 && r < a.M) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(x[j][v], wr[j], acc[v]);
        }
      }
    } else {
      for (int j = 0; j < D; ++j) {
        const int r = i - h + j;
        if (r >= 0 && r < a.M) {
          float x[V];
          read(x, r);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(x[v], wr[j], acc[v]);
        }
      }
    }
  } else if (a.D <= tb::MERGE_REGS) {
    // up to MERGE_REGS slots: every slot's load in flight together (another
    // CTA's row costs a distributed-shared-memory round trip), then the
    // combine of tb::for_each_slot, in its order, on the loaded values
    constexpr int NS = tb::MERGE_REGS;
    int r[NS];
    float w[NS];
    float x[NS][V];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      // padding slots name row -1, which no in-range slot matches
      r[j] = j < a.D ? (MODE == ONEHOT ? tb_row.ix[j] : tb::gather_row(tb_row.ix[j], a.M))
                     : -1;
      w[j] = j < a.D ? wr[j] : 0.f;
      if (j < a.D) read(x[j], r[j] >= 0 && r[j] < a.M ? r[j] : i);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (r[j] < 0 || r[j] >= a.M) continue;
      float ws = w[j];
      if constexpr (MODE == ONEHOT) {
        bool seen = false;
#pragma unroll
        for (int q = 0; q < j; ++q) seen |= r[q] == r[j];
        if (seen) continue;
        ws = 0.f;
#pragma unroll
        for (int q = j; q < NS; ++q)
          if (r[q] == r[j]) ws += w[q];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(x[j][v], ws, acc[v]);
    }
  } else {
    tb::for_each_slot<MODE == ONEHOT>(tb_row.ix, wr, a.M, a.D, [&](int r, float w) {
      float x[V];
      read(x, r);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(x[v], w, acc[v]);
    });
  }
}

// The NC items of one warp in a group of a depth's owned items, an item V
// consecutive columns of one row (V = 4 where the slice moves 16 bytes at a
// time, else 1): item j is e = e0 + j * RES_THREADS + threadIdx.x, owned
// row e >> (sh - log2 V), columns from (e mod (width / V)) * V; the NC * V
// values are the thread's register chains.
template <int MODE, int DW, int V, int NC>
__device__ __forceinline__ void resident_chains(const ResidentArgs& a, const Place& p,
                                                const float* __restrict__ cur,
                                                float* __restrict__ nxt,
                                                const float* ws, const int* is, int t,
                                                int e0, int n) {
  constexpr int VS = V == 4 ? 2 : 0;
  const int ish = p.sh - VS;  // log2 of the items a row
  float v[NC * V];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int e = e0 + j * RES_THREADS + threadIdx.x;
    const int c = (e & ((1 << ish) - 1)) << VS;
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    if (e < n && c < p.cw) {
      const int i = p.r0 + (e >> ish);
      resident_combine<MODE, DW, V>(a, p, cur, row_tables(a, p, ws, is, t, i), i, c, acc);
    }
#pragma unroll
    for (int u = 0; u < V; ++u) v[j * V + u] = acc[u];
  }
  tb::fma_body(v, a.iterations);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int e = e0 + j * RES_THREADS + threadIdx.x;
    const int c = (e & ((1 << ish) - 1)) << VS;
    if (e < n && c < p.cw) {
      float* q = nxt + ((e >> ish) << p.sh) + c;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(q) =
            make_float4(v[j * V], v[j * V + 1], v[j * V + 2], v[j * V + 3]);
      } else {
        *q = v[j * V];
      }
    }
  }
}

// One depth's owned items of this CTA, in groups of RES_THREADS * MC items:
// a warp runs as many items (chains of V values) as hold one of its own.
template <int MODE, int DW, int V>
__device__ __forceinline__ void resident_depth(const ResidentArgs& a, const Place& p,
                                               const float* __restrict__ cur,
                                               float* __restrict__ nxt, const float* ws,
                                               const int* is, int t, int n) {
  constexpr int MC = MAX_CHAINS / V;  // items a thread, at most
  const int warp0 = threadIdx.x & ~31;  // this warp's first thread
  for (int e0 = 0; e0 < n; e0 += RES_THREADS * MC) {
    const int left = n - e0 - warp0;
    const int nc = left <= 0 ? 0 : min(MC, (left + RES_THREADS - 1) / RES_THREADS);
    if constexpr (V == 4) {
      if (nc == 1) resident_chains<MODE, DW, V, 1>(a, p, cur, nxt, ws, is, t, e0, n);
      else if (nc == 2) resident_chains<MODE, DW, V, 2>(a, p, cur, nxt, ws, is, t, e0, n);
    } else {
      switch (nc) {
        case 0: break;
        case 1: resident_chains<MODE, DW, V, 1>(a, p, cur, nxt, ws, is, t, e0, n); break;
        case 2: resident_chains<MODE, DW, V, 2>(a, p, cur, nxt, ws, is, t, e0, n); break;
        case 3: resident_chains<MODE, DW, V, 3>(a, p, cur, nxt, ws, is, t, e0, n); break;
        case 4: resident_chains<MODE, DW, V, 4>(a, p, cur, nxt, ws, is, t, e0, n); break;
        case 5: resident_chains<MODE, DW, V, 5>(a, p, cur, nxt, ws, is, t, e0, n); break;
        case 6: resident_chains<MODE, DW, V, 6>(a, p, cur, nxt, ws, is, t, e0, n); break;
        case 7: resident_chains<MODE, DW, V, 7>(a, p, cur, nxt, ws, is, t, e0, n); break;
        default: resident_chains<MODE, DW, V, 8>(a, p, cur, nxt, ws, is, t, e0, n); break;
      }
    }
  }
}

template <int MODE, int DW>
__global__ void __launch_bounds__(RES_THREADS)
    blocked_resident_kernel(ResidentArgs a) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  Place p;
  p.k = blockIdx.y;
  p.rank = static_cast<int>(cluster.block_rank());
  p.sh = a.col_shift;
  p.R = a.rows;
  p.r0 = p.rank * p.R;
  p.c0 = (blockIdx.x / a.cluster) << p.sh;
  p.cw = min(1 << p.sh, a.P - p.c0);
  p.invR = 1.f / static_cast<float>(p.R);
  const int width = 1 << p.sh;
  const int nr = max(0, min(a.M, p.r0 + p.R) - p.r0);  // rows this CTA owns
  p.nr = nr;
  const int n = nr << p.sh;                              // its elements
  const int T = a.time_varying ? a.S : 1;
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + (p.R << p.sh);
  float* ws = buf1 + (p.R << p.sh);
  int* is = reinterpret_cast<int*>(ws + static_cast<size_t>(T) * p.R * a.D);
  const size_t row0 = static_cast<size_t>(p.k) * a.M + p.r0;
  // the owned rows of the slice, once, all copies in flight together
  if (a.vec) {
    const int qs = p.sh - 2;  // log2 of the 16-byte pieces a row
    for (int e = threadIdx.x; e < (nr << qs); e += RES_THREADS) {
      const int c = (e & ((1 << qs) - 1)) << 2;
      float* dst = buf0 + ((e >> qs) << p.sh) + c;
      if (c < p.cw)
        copy_async16(dst, a.src + (row0 + (e >> qs)) * a.P + p.c0 + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += RES_THREADS) {
      const int c = e & (width - 1);
      if (c < p.cw)
        tb::copy_async4(buf0 + e, a.src + (row0 + (e >> p.sh)) * a.P + p.c0 + c);
      else
        buf0[e] = 0.f;
    }
  }
  if (a.tables_smem) {  // the owned rows' tables, every depth's
    for (int t = 0; t < T; ++t) {
      const size_t g0 = ((static_cast<size_t>(p.k) * T + t) * a.M + p.r0) * a.D;
      const size_t s0 = static_cast<size_t>(t) * p.R * a.D;
      for (int e = threadIdx.x; e < nr * a.D; e += RES_THREADS) {
        tb::copy_async4(ws + s0 + e, a.wgt + g0 + e);
        if constexpr (MODE != WINDOW)
          tb::copy_async4(reinterpret_cast<float*>(is + s0 + e),
                          reinterpret_cast<const float*>(a.idx + g0 + e));
      }
    }
  }
  tb::commit_async();
  tb::wait_async<0>();
  // every CTA's depth-0 rows in place before any CTA reads them
  cluster_barrier(a.cluster);
  float* cur = buf0;
  float* nxt = buf1;
  const float* act = a.act + static_cast<size_t>(p.k) * a.S;
  float on = act[0];
  for (int d = 0; d < a.S; ++d) {
    const float on_d = on;
    if (d + 1 < a.S) on = act[d + 1];  // the next depth's, read ahead
    // an inactive depth carries the buffer through: keep `cur` (the mask is
    // the member's, the same in every CTA of the cluster)
    if (on_d <= 0.5f) continue;
    const int t = a.time_varying ? d : 0;
    if (a.vec)
      resident_depth<MODE, DW, 4>(a, p, cur, nxt, ws, is, t, nr << (p.sh - 2));
    else
      resident_depth<MODE, DW, 1>(a, p, cur, nxt, ws, is, t, n);
    // the next depth reads what this one wrote, in every CTA of the
    // cluster, and writes what this one read; after the last active depth
    // this barrier also keeps each CTA's buffers alive until the others
    // have read them
    cluster_barrier(a.cluster);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  float* out = a.out + row0 * a.P + p.c0;
  if (a.vec) {
    const int qs = p.sh - 2;
    for (int e = threadIdx.x; e < (nr << qs); e += RES_THREADS) {
      const int c = (e & ((1 << qs) - 1)) << 2;
      if (c < p.cw)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(e >> qs) * a.P + c) =
            *reinterpret_cast<const float4*>(cur + ((e >> qs) << p.sh) + c);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += RES_THREADS) {
      const int c = e & (width - 1);
      if (c < p.cw) out[static_cast<size_t>(e >> p.sh) * a.P + c] = cur[e];
    }
  }
}

// The kernel's attributes, set once per device: the opt-in shared memory,
// and clusters of 16 (beyond the portable 8).
template <int MODE, int DW>
cudaError_t resident_attributes() {
  static unsigned long long done = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  int smem_max = 0;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
    return err;
  const void* kernel = reinterpret_cast<const void*>(blocked_resident_kernel<MODE, DW>);
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_max)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                  1)) != cudaSuccess)
    return err;
  if (dev < 64) done |= 1ull << dev;
  return cudaSuccess;
}

template <int MODE, int DW>
cudaError_t launch_resident(const ResidentArgs& a, cudaStream_t stream) {
  cudaError_t err = resident_attributes<MODE, DW>();
  if (err != cudaSuccess) return err;
  const size_t smem =
      resident_smem_floats(a.rows, a.col_shift, a.D, a.time_varying ? a.S : 1,
                           MODE != WINDOW, a.tables_smem != 0) *
      sizeof(float);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.n_slices) * a.cluster, a.K);
  cfg.blockDim = dim3(RES_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, blocked_resident_kernel<MODE, DW>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

// The tiled form (see the header): fixed (K, M, D) tables whose taps reach
// at most `reach` rows, the FMA body with `iterations` (0 for the empty
// body). tile_rows output rows and 1 << col_shift columns per CTA.
extern "C" int taskbench_blocked_tiled(const float* src, const int* idx,
                                       const float* wgt, const float* act,
                                       float* out, int K, int M, int P, int D,
                                       int S, int mode, int reach,
                                       int iterations, int tile_rows,
                                       int col_shift, void* stream) {
  if (tile_rows < 1 || col_shift < 0 || col_shift > 30 || reach < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  TiledArgs a{src, idx, wgt, act, out, K, M, P, D, S, reach, iterations,
              tile_rows, col_shift,
              (P + (1 << col_shift) - 1) >> col_shift};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case WINDOW:  // the halo patterns' windows at radius 1 and 2 unrolled
      err = D == 3   ? launch_tiled<WINDOW, 3>(a, s)
            : D == 5 ? launch_tiled<WINDOW, 5>(a, s)
                     : launch_tiled<WINDOW, 0>(a, s);
      break;
    case GATHER:
      err = launch_tiled<GATHER, 0>(a, s);
      break;
    case ONEHOT:
      err = launch_tiled<ONEHOT, 0>(a, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The resident form (see the header): any table, the FMA body with
// `iterations` (0 for the empty body). Clusters of `cluster` CTAs, each
// owning `rows` rows of a 1 << col_shift column slice; `tables_smem` 1
// keeps each CTA's rows' tables in shared memory; `vec` 1 moves src and
// out 16 bytes at a time (the caller checks the alignment).
extern "C" int taskbench_blocked_resident(const float* src, const int* idx,
                                          const float* wgt, const float* act,
                                          float* out, int K, int M, int P, int D,
                                          int S, int mode, int time_varying,
                                          int iterations, int rows, int col_shift,
                                          int cluster, int tables_smem, int vec,
                                          void* stream) {
  if (rows < 1 || col_shift < 0 || col_shift > 30 || cluster < 1 ||
      cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0 ||
      static_cast<long long>(rows) * cluster < M || (vec && col_shift < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  ResidentArgs a{src, idx, wgt, act, out, K, M, P, D, S, time_varying, iterations,
                 rows, col_shift, (P + (1 << col_shift) - 1) >> col_shift, cluster,
                 tables_smem, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case WINDOW:
      err = time_varying ? cudaErrorInvalidValue
            : D == 3     ? launch_resident<WINDOW, 3>(a, s)
            : D == 5     ? launch_resident<WINDOW, 5>(a, s)
                         : launch_resident<WINDOW, 0>(a, s);
      break;
    case GATHER:
      err = launch_resident<GATHER, 0>(a, s);
      break;
    case ONEHOT:
      err = launch_resident<ONEHOT, 0>(a, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The resident form's co-resident clusters of `cluster` CTAs on the current
// device, one CTA an SM (the opt-in shared memory a CTA): the capacity
// taskbench_step.plan_resident fills. A negative value is -cudaError_t.
extern "C" int taskbench_blocked_resident_clusters(int cluster) {
  if (cluster < 1 || cluster > MAX_CLUSTER) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = resident_attributes<GATHER, 0>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, smem_max = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
    return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(RES_THREADS);
  cfg.dynamicSmemBytes = smem_max;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(blocked_resident_kernel<GATHER, 0>), &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
