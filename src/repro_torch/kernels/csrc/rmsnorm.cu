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
// 25 MB and 50 MB take 7.5 us and 15 us at 3.35 TB/s; the 4 operations per
// element are far below the f32 peak: bound by bytes, so the kernel has to
// keep enough 16-byte loads in flight and touch each byte of x once.
//
// Design: one warp per row, 8 rows per CTA of 256 threads. Vector path
// (d a multiple of the vector width, x, w and out 16-byte aligned): each
// lane loads its 16-byte vectors of the row (8 bf16 or 4 f32; vector k of
// the lane is vector lane + 32 k of the row) into registers, all loads
// issued before any is used; it sums their squares in f32, a butterfly of
// shuffles gives every lane the row's sum, and the lane scales the vectors
// it still holds and writes them back as 16-byte stores. The row is read
// from device memory once. w is loaded the same way, in its own dtype (16
// bytes of x's width: two f32 vectors for a bf16 x), from L1 after the sum.
// The vectors a lane holds, NV, is a compile-time 1, 2, 3, 4, 6, 8, 12 or
// 16 (the smallest that covers the row: d = 768 bf16 takes 3, d = 1536
// takes 6); a wider row loops over its vectors and reads them twice.
// Scalar path (any other d or alignment, e.g. d = 33, or a view at an odd
// offset): one element per lane, the row read twice, in the same launch.
// The wrapper chooses the path (``rmsnorm.vector_width``); this entry
// refuses a vector width the pointers or d do not allow.
#include <cuda_bf16.h>

#include <cstdint>

#include "error.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int ROWS_PER_CTA = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// elements of T in one 16-byte vector
template <typename T> constexpr int VEC = 16 / static_cast<int>(sizeof(T));

// the VEC<T> elements of one 16-byte vector, in f32
__device__ __forceinline__ void unpack(uint4 q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ float2 bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ void unpack(uint4 q, float (&v)[8]) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = bf2(u[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t bf2u(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(bf2u(v[0], v[1]), bf2u(v[2], v[3]), bf2u(v[4], v[5]), bf2u(v[6], v[7]));
}

// n elements of w (16-byte aligned at p) in f32: 16-byte loads, or one
// 8-byte load for 4 bf16
template <int N>
__device__ __forceinline__ void load_w(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    float t[4];
    unpack(*reinterpret_cast<const uint4*>(p + i), t);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[i + e] = t[e];
  }
}
template <int N>
__device__ __forceinline__ void load_w(const bf16* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = bf2(q.x), b = bf2(q.y);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      float t[8];
      unpack(*reinterpret_cast<const uint4*>(p + i), t);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i + e] = t[e];
    }
  }
}

// sum over the warp, in every lane
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// x * scale * w for one vector q of x's dtype T, stored at o
template <typename T, typename W>
__device__ __forceinline__ void scale_store(uint4 q, const W* w, uint4* o, float scale) {
  constexpr int V = VEC<T>;
  float v[V], wv[V];
  unpack(q, v);
  load_w(w, wv);
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = v[e] * scale * wv[e];
  *o = pack(v);
}

// NV > 0: each lane holds NV vectors of its row; NV == -1: the vector loop
// (rows wider than 16 vectors a lane), reading the row twice; NV == 0: the
// scalar path
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                   int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* orow = out + static_cast<size_t>(row) * d;
  float ss = 0.f;
  if constexpr (NV == 0) {
#pragma unroll 4
    for (int j = lane; j < d; j += 32) {
      const float v = to_f32(xr[j]);
      ss = fmaf(v, v, ss);
    }
    const float scale = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll 4
    for (int j = lane; j < d; j += 32)
      orow[j] = from_f32<T>(to_f32(xr[j]) * scale * to_f32(w[j]));
  } else {
    constexpr int V = VEC<T>;
    const int nvec = d / V;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    if constexpr (NV > 0) {
      uint4 buf[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (lane + 32 * k < nvec) buf[k] = xv[lane + 32 * k];
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (lane + 32 * k < nvec) {
          float v[V];
          unpack(buf[k], v);
#pragma unroll
          for (int e = 0; e < V; ++e) ss = fmaf(v[e], v[e], ss);
        }
      const float scale = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = lane + 32 * k;
        if (j < nvec) scale_store<T>(buf[k], w + j * V, ov + j, scale);
      }
    } else {
#pragma unroll 4
      for (int j = lane; j < nvec; j += 32) {
        float v[V];
        unpack(xv[j], v);
#pragma unroll
        for (int e = 0; e < V; ++e) ss = fmaf(v[e], v[e], ss);
      }
      const float scale = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll 4
      for (int j = lane; j < nvec; j += 32)
        scale_store<T>(xv[j], w + j * V, ov + j, scale);
    }
  }
}

template <typename T, typename W, int NV>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  const int grid = (rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  rmsnorm_kernel<T, W, NV><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), rows, d,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int dispatch_nv(int vec, const void* x, const void* w, void* out, int rows, int d,
                float eps, cudaStream_t s) {
  if (vec == 1) return launch<T, W, 0>(x, w, out, rows, d, eps, s);
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (vec != VEC<T> || d % vec || misaligned(x) || misaligned(w) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_lane = (d / vec + 31) / 32;  // vectors a lane holds
  if (per_lane <= 1) return launch<T, W, 1>(x, w, out, rows, d, eps, s);
  if (per_lane <= 2) return launch<T, W, 2>(x, w, out, rows, d, eps, s);
  if (per_lane <= 3) return launch<T, W, 3>(x, w, out, rows, d, eps, s);
  if (per_lane <= 4) return launch<T, W, 4>(x, w, out, rows, d, eps, s);
  if (per_lane <= 6) return launch<T, W, 6>(x, w, out, rows, d, eps, s);
  if (per_lane <= 8) return launch<T, W, 8>(x, w, out, rows, d, eps, s);
  if (per_lane <= 12) return launch<T, W, 12>(x, w, out, rows, d, eps, s);
  if (per_lane <= 16) return launch<T, W, 16>(x, w, out, rows, d, eps, s);
  return launch<T, W, -1>(x, w, out, rows, d, eps, s);
}

template <typename T>
int dispatch_w(int w_dtype, int vec, const void* x, const void* w, void* out, int rows,
               int d, float eps, cudaStream_t s) {
  if (w_dtype == 0) return dispatch_nv<T, float>(vec, x, w, out, rows, d, eps, s);
  if (w_dtype == 1) return dispatch_nv<T, bf16>(vec, x, w, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_dtype (x and out) and w_dtype: 0 float32, 1 bfloat16. vec: 1 for the
// scalar path, else the elements of x in 16 bytes (8 bf16, 4 f32), which
// needs d % vec == 0 and x, w and out 16-byte aligned. The wrapper checks
// shapes and contiguity.
extern "C" int rmsnorm(const void* x, const void* w, void* out, int rows, int d,
                       float eps, int x_dtype, int w_dtype, int vec, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_w<float>(w_dtype, vec, x, w, out, rows, d, eps, s);
  if (x_dtype == 1) return dispatch_w<bf16>(w_dtype, vec, x, w, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
