// K2: the memory-bound Task Bench body (scratch sweep), one row per warp.
//
// Replaces: src/repro/kernels/bodies.py::memory_bound_pallas (Pallas body
// `_memory_kernel`).
//
// Bound on an H100: HBM traffic is only the row in and the row out, so at
// any grain above zero the kernel is bound by shared-memory bandwidth: the
// tile-out writes `scratch` floats of the row's working set, each pass
// reads and writes them, the fold reads them back (132 SMs x 128 B a
// clock).
//
// Design: a persistent CTA per SM, each warp a row at a time, rows dealt
// round-robin over the SMs first so every SM gets the same count; a CTA
// has as many warps as let its rows run in the fewest even rounds within
// its shared memory (~16.5 KB a row at scratch 2048, 13 at most: 2112 rows
// run as 2 rounds of 8 an SM). A warp runs tb::memory_sweep_warp, shared with the megakernels:
// two buffers of `scratch` floats in shared memory, ping-ponged, each pass
// 16 bytes a lane and access with the roll's carry passed between lanes by
// a shuffle, ended by a warp barrier, not a block-wide one. While it sweeps
// one row, cp.async brings its next row from global memory into a second
// staging row, so no warp waits on global memory between rows.
#include "bodies.cuh"

namespace {

constexpr int MAX_WARPS = 16;

// The floats of shared memory one warp takes: two staging rows and the
// sweep's two buffers (bodies.cuh's layout after the first row).
__host__ __device__ inline size_t warp_floats(int payload, int scratch) {
  return static_cast<size_t>(tb::round4(payload)) + tb::sweep_floats(payload, scratch);
}

// Asynchronous copy of `payload` floats from global to shared memory by the
// lanes of one warp (cp.async, 4 bytes a lane).
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int payload) {
  for (int c = threadIdx.x & 31; c < payload; c += 32)
    tb::copy_async4(dst + c, src + c);
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
    memory_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long rows, int payload, int iterations, int scratch) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const long long n_warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  long long r = static_cast<long long>(warp) * gridDim.x + blockIdx.x;
  if (iterations == 0) {
    for (; r < rows; r += n_warps)
      for (int c = threadIdx.x & 31; c < payload; c += 32)
        out[r * payload + c] = x[r * payload + c];
    return;
  }
  float* base = reinterpret_cast<float*>(smem4) + warp * warp_floats(payload, scratch);
  float* cur = base;  // the staged row this round sweeps
  float* nxt = base + tb::round4(payload);
  float* buf0 = base + 2 * tb::round4(payload);
  float* buf1 = buf0 + tb::round4(scratch);
  if (r < rows) stage_row(cur, x + r * payload, payload);
  tb::commit_async();
  for (; r < rows; r += n_warps) {
    // the next row into the other staging row, which the last sweep read
    if (r + n_warps < rows) stage_row(nxt, x + (r + n_warps) * payload, payload);
    tb::commit_async();
    tb::wait_async<1>();  // this row's copy, not the next one's
    __syncwarp();
    tb::memory_sweep_warp(cur, out + r * payload, payload, iterations, scratch,
                          buf0, buf1);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace

extern "C" int memory_bound(const float* x, float* out, int rows, int payload,
                            int iterations, int scratch, void* stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (rows < 1) return static_cast<int>(cudaSuccess);
  const size_t per_warp =
      iterations == 0 ? 0 : warp_floats(payload, scratch) * sizeof(float);
  // rows over the SMs first; then each CTA's rows in as few rounds as the
  // warps its shared memory holds allow, with as many warps as make the
  // rounds even (16 rows an SM: 2 rounds of 8, not 13 and then 3)
  const int ctas = rows < sms ? rows : sms;
  const int per_cta = (rows + ctas - 1) / ctas;
  int fit = per_warp == 0 ? MAX_WARPS : static_cast<int>(smem_max / per_warp);
  if (fit > MAX_WARPS) fit = MAX_WARPS;
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);  // a row too big
  const int rounds = (per_cta + fit - 1) / fit;
  const int warps = (per_cta + rounds - 1) / rounds;
  const size_t smem = warps * per_warp;
  err = cudaFuncSetAttribute(memory_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(memory_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  memory_kernel<<<ctas, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, payload, iterations, scratch);
  return static_cast<int>(cudaGetLastError());
}
