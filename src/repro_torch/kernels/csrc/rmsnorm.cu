// K8: RMSNorm over the rows of a (rows, d) matrix.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm_pallas (Pallas body
// `_rmsnorm_kernel`).
//
// Semantics (as the TPU kernel's): out = x * rsqrt(sum(x^2) / d + eps) * w
// per row, the sum over the row's true length d in f32, the product in f32
// and the result stored in x's dtype. x and w are each f32 or bf16.
//
// Bound on an H100: each element of x is read once and written once, so at
// mamba2-130m's norm shapes, (8192, 768) and (8192, 1536) in bf16, the
// 25 MB and 50 MB take 7.5 us and 15 us at 3.35 TB/s; the 3 operations per
// element are far below the f32 peak: bound by bytes.
//
// Design: one warp per row, 8 rows per CTA of 256 threads. Each lane sums
// the squares of columns lane, lane + 32, ... in f32; a butterfly of
// shuffles gives every lane the row's sum; the lanes then read the row again
// (from L1/L2) and write the output. Loads are one element per lane (no
// 16-byte vector loads yet), which is the first thing to make it faster.
#include <cuda_bf16.h>

#include "error.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_CTA = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                   int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* orow = out + static_cast<size_t>(row) * d;
  float ss = 0.f;
#pragma unroll 4
  for (int j = lane; j < d; j += 32) {
    const float v = to_f32(xr[j]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float scale = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll 4
  for (int j = lane; j < d; j += 32) orow[j] = from_f32<T>(to_f32(xr[j]) * scale * to_f32(w[j]));
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  const int grid = (rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  rmsnorm_kernel<T, W><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), rows, d,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_w(int w_dtype, const void* x, const void* w, void* out, int rows, int d,
               float eps, cudaStream_t s) {
  if (w_dtype == 0) return launch<T, float>(x, w, out, rows, d, eps, s);
  if (w_dtype == 1) return launch<T, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_dtype (x and out) and w_dtype: 0 float32, 1 bfloat16. The wrapper
// checks shapes and contiguity.
extern "C" int rmsnorm(const void* x, const void* w, void* out, int rows, int d,
                       float eps, int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_w<float>(w_dtype, x, w, out, rows, d, eps, s);
  if (x_dtype == 1) return dispatch_w<__nv_bfloat16>(w_dtype, x, w, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
