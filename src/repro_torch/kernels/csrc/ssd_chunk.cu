// K7: the Mamba-2 SSD intra-chunk terms (state-space duality,
// arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_chunk_pallas (Pallas body
// `_ssd_chunk_kernel`).
//
// Semantics (as the TPU kernel's): per (batch * chunk i, head h), with the
// chunk's T tokens, state size N and head dim P, B and C taken from group
// g = h / (H / G), everything in f32:
//
//   a      = cumsum(dtA)                      (T)    in token order
//   L_ij   = exp(a_i - a_j) for j <= i, else 0
//   scores = (C B^T) * L                      (T, T)
//   Y      = scores (X * dt)                  (T, P) stored in x's dtype
//   state  = (B * exp(a_T - a) * dt)^T X      (N, P) stored in f32
//
// exp(a_i - a_j) is evaluated only for j <= i: above the diagonal the
// exponent is positive (dtA <= 0) and may overflow, so an exp-then-mask
// would meet inf * 0. The state's product is taken as (B * exp(a_T - a))^T
// (X * dt), the same terms with dt applied to the other factor.
//
// Bound on an H100: at the mamba2-130m serving prefill (BC 64, H 24, G 1,
// T = N = 128, P 64, f32 operands) the work that must be done is C B^T once
// per (chunk, group) and the two head products, ~5.0 GFLOP, 75 us at the
// 67 TFLOP/s f32 peak, against ~160 MB of x, y, B, C, dtA, dt and state,
// 48 us at 3.35 TB/s: bound by operations (chip_smoke.py computes it from
// the run's shapes).
//
// Design: one CTA of 256 threads per (i, h). The CTA stages B and C (T x N,
// rows padded to N + 1 floats so that a warp's column reads fall in
// distinct banks) and X * dt (T x P) in shared memory as f32; one thread
// takes the cumsum in token order. The products are plain f32 FMAs from
// shared memory: each pass computes a 64 x 64 output tile, thread (ty, tx)
// of a 16 x 16 grid owning rows ty + 16 r and columns tx + 16 c (4 x 4).
// Query rows go in tiles of 64: the tile's (64, T) scores are formed and
// masked into shared memory, then multiplied by X * dt, so the (T, T)
// score matrix is never held whole. No tensor cores (mma.sync / wgmma),
// and C B^T is recomputed by each of a group's heads: those are the first
// things to make it fast. Shared memory is (2 T + 2 T (N + 1) + T P +
// min(T, 64) (T + 1)) floats, 199 KB at T = N = 128, P = 64 (one CTA per
// SM), so the launch raises the dynamic shared memory limit above 48 KB.
#include <cuda_bf16.h>

#include "error.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // output tile edge: 16 x 16 threads, 4 x 4 each
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc[r][c] = sum_{k < K} A(r0 + ty + 16 r, k) * Bm(k, c0 + tx + 16 c), with
// A(row, k) = A[row * sar + k * sak] and Bm(k, col) = Bm[k * sbk + col * sbc].
// Rows from M on and columns from ncol on read row M - 1 / column ncol - 1;
// the caller drops them.
__device__ __forceinline__ void mm_tile(const float* A, int sar, int sak, int M, int r0,
                                        const float* Bm, int sbk, int sbc, int ncol,
                                        int c0, int K, float acc[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  int ao[4], bo[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) ao[r] = min(r0 + ty + 16 * r, M - 1) * sar;
#pragma unroll
  for (int c = 0; c < 4; ++c) bo[c] = min(c0 + tx + 16 * c, ncol - 1) * sbc;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[ao[r] + k * sak];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = Bm[k * sbk + bo[c]];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

size_t smem_bytes(int T, int N, int P) {
  const size_t t = T, n = N, p = P, rows = T < TILE ? T : TILE;
  return sizeof(float) * (2 * t + 2 * t * (n + 1) + t * p + rows * (t + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ b,
                     const T* __restrict__ c, const float* __restrict__ dta,
                     const float* __restrict__ dt, T* __restrict__ y,
                     float* __restrict__ state, int H, int G, int Tn, int N, int P) {
  extern __shared__ float smem[];
  const int NP = N + 1;   // padded row stride of the B and C tiles
  const int SP = Tn + 1;  // padded row stride of the score tile
  float* sa = smem;             // (T) a = cumsum(dtA)
  float* sdec = sa + Tn;        // (T) exp(a_T - a)
  float* sb = sdec + Tn;        // (T, NP) B, later B * exp(a_T - a)
  float* sc = sb + Tn * NP;     // (T, NP) C
  float* sx = sc + Tn * NP;     // (T, P) X * dt
  float* ss = sx + Tn * P;      // (min(T, 64), SP) one query tile's scores

  const int bh = blockIdx.x;  // i * H + h
  const int i = bh / H, h = bh % H;
  const int g = h / (H / G);
  const size_t bc_off = (static_cast<size_t>(i) * G + g) * Tn * N;
  const T* xb = x + static_cast<size_t>(bh) * Tn * P;
  const float* dtab = dta + static_cast<size_t>(bh) * Tn;
  const float* dtb = dt + static_cast<size_t>(bh) * Tn;
  T* yb = y + static_cast<size_t>(bh) * Tn * P;
  float* stb = state + static_cast<size_t>(bh) * N * P;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int e = tid; e < Tn * N; e += THREADS) {
    const int t = e / N, n = e % N;
    sb[t * NP + n] = to_f32(b[bc_off + e]);
    sc[t * NP + n] = to_f32(c[bc_off + e]);
  }
  for (int e = tid; e < Tn * P; e += THREADS) sx[e] = to_f32(xb[e]) * dtb[e / P];
  if (tid == 0) {
    float s = 0.f;
    for (int t = 0; t < Tn; ++t) {
      s += dtab[t];
      sa[t] = s;
    }
  }
  __syncthreads();
  for (int t = tid; t < Tn; t += THREADS) sdec[t] = expf(sa[Tn - 1] - sa[t]);

  // Y, one tile of query rows at a time
  for (int q0 = 0; q0 < Tn; q0 += TILE) {
    const int rows = min(TILE, Tn - q0);
    const int kmax = q0 + rows;  // keys any row of the tile sees: j < kmax
    __syncthreads();  // the last tile's reads of ss are done
    for (int c0 = 0; c0 < kmax; c0 += TILE) {
      float acc[4][4];
      // scores(r, j) = C[q0 + r] . B[j]
      mm_tile(sc + q0 * NP, NP, 1, rows, 0, sb, 1, NP, kmax, c0, N, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty + 16 * r, qi = q0 + row;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int j = c0 + tx + 16 * cc;
          if (row < rows && j < kmax)
            ss[row * SP + j] = j <= qi ? acc[r][cc] * expf(sa[qi] - sa[j]) : 0.f;
        }
      }
    }
    __syncthreads();
    for (int p0 = 0; p0 < P; p0 += TILE) {
      float acc[4][4];
      // Y(r, p) = sum_{j < kmax} scores(r, j) * (X * dt)(j, p)
      mm_tile(ss, SP, 1, rows, 0, sx, P, 1, P, p0, kmax, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty + 16 * r;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int p = p0 + tx + 16 * cc;
          if (row < rows && p < P)
            yb[static_cast<size_t>(q0 + row) * P + p] = from_f32<T>(acc[r][cc]);
        }
      }
    }
  }

  // state(n, p) = sum_t B[t][n] exp(a_T - a_t) * (X * dt)(t, p)
  __syncthreads();  // the score products' reads of sb are done
  for (int e = tid; e < Tn * N; e += THREADS) {
    const int t = e / N, n = e % N;
    sb[t * NP + n] *= sdec[t];
  }
  __syncthreads();
  for (int n0 = 0; n0 < N; n0 += TILE)
    for (int p0 = 0; p0 < P; p0 += TILE) {
      float acc[4][4];
      mm_tile(sb, 1, NP, N, n0, sx, P, 1, P, p0, Tn, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = n0 + ty + 16 * r;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int p = p0 + tx + 16 * cc;
          if (n < N && p < P) stb[static_cast<size_t>(n) * P + p] = acc[r][cc];
        }
      }
    }
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const void* dta, const void* dt,
           void* y, void* state, int BC, int H, int G, int Tn, int N, int P,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Tn, N, P);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd_chunk_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<BC * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(dta), static_cast<const float*>(dt), static_cast<T*>(y),
      static_cast<float*>(state), H, G, Tn, N, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, b, c and y alike; dta, dt and state are
// float32). The wrapper checks shapes, H % G == 0 and contiguity; a shape
// whose tiles exceed the shared memory of one SM returns
// cudaErrorInvalidValue.
extern "C" int ssd_chunk(const void* x, const void* b, const void* c, const void* dta,
                         const void* dt, void* y, void* state, int BC, int H, int G,
                         int T, int N, int P, int dtype, void* stream) {
  if (G <= 0 || H % G != 0 || T <= 0 || N <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, b, c, dta, dt, y, state, BC, H, G, T, N, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, b, c, dta, dt, y, state, BC, H, G, T, N, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
