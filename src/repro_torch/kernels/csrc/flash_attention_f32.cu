// K5, f32 form: forward attention with a blockwise online softmax
// (FlashAttention), causal, sliding-window and key-length masks,
// grouped-query heads, for float32 q, k and v. The bf16 form, on the tensor
// cores, is flash_attention.cu; the wrapper dispatches by dtype and counts
// the two forms apart (`flash_attention`, `flash_attention_f32`). The
// tensor cores cannot hold f32's mantissa without a three-way split, so the
// f32 form keeps f32 FMAs.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (Pallas body `_flash_kernel`), for f32 inputs.
//
// Semantics (as the TPU kernel's): q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D),
// query head h reads key head h / (Hq / Hkv). Row i sees key j when j < Sk,
// and j <= i if causal (row and key indices both start at 0, so Sq != Sk
// carries no offset), and i - j < window if window > 0. Scores are
// (q . k) * sm_scale in f32; a masked score is -1e30 and its probability is
// zeroed; a row that sees no key gives 0. The sums are f32.
//
// Bound on an H100: at the serving prefill's shape (B 8, Hq 16, Sq = Sk =
// 1024, D 128, causal) the work is ~4 * B * Hq * Sq^2 * D / 2 = 34.4 GFLOP,
// 0.51 ms at the 67 TFLOP/s f32 peak outside the tensor cores, against
// ~200 MB of q, k, v and o, 60 us at 3.35 TB/s: bound by operations.
//
// Design: one CTA of 256 threads per (q tile of 64 rows, q head, batch). The
// CTA stages its q tile in shared memory and loops over the 64-key tiles
// from the first one the window lets row q0 see up to the causal limit;
// tiles that no row of the tile sees are never loaded (the TPU kernel's
// block skip). The loop inside the CTA takes the place of the TPU grid's
// sequential k axis, and the running (m, l, acc) state lives in registers:
// thread (tr, tc) owns rows 4 tr .. 4 tr + 3 of the tile, the score columns
// tc + 16 j and the output columns tc + 16 c. Both products (q k^T and p v)
// are f32 FMAs from shared memory, with float4 reads along D from tiles
// whose rows are padded by 4 floats (no bank conflicts); the row max and
// sum are shuffles across the 16 lanes of a row. Shared memory is
// (2 * 64 * (D + 4) + 64 * D + 64 * 68) floats, 115 KB at D = 128 (one CTA
// per SM), so the launch raises the dynamic shared memory limit above 48 KB.
#include "error.cuh"

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 64;   // keys per tile
constexpr int THREADS = 256;
constexpr int PP = BK + 4;  // padded row stride of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// max and sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 4) + BK * D + BQ * PP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int Sq, int Sk, int causal, int window, float sm_scale) {
  constexpr int DP = D + 4;  // padded row stride of the q and k tiles
  constexpr int DT = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + BQ * DP;
  float* sv = sk + BK * DP;
  float* sp = sv + BK * D;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  T* ob = o + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    sq[r * DP + d] = q0 + r < Sq ? to_f32(qb[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }
  // keys any row of this tile may see: [k_begin, k_end)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's reads are done (and sq is written)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bool in = k0 + r < Sk;
      const size_t off = static_cast<size_t>(k0 + r) * D + d;
      sk[r * DP + d] = in ? to_f32(kb[off]) : 0.f;
      sv[r * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sq + (tr * 4 + i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(sk + (tc + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, ka[j].x, t);
          t = fmaf(qa[i].y, ka[j].y, t);
          t = fmaf(qa[i].z, ka[j].z, t);
          t = fmaf(qa[i].w, ka[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, scale and the online softmax update of each owned row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc + 16 * j;
        ok[j] = kj < Sk && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
        s[i][j] = ok[j] ? s[i][j] * sm_scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sp[(tr * 4 + i) * PP + tc + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sp + (tr * 4 + i) * PP + kk);
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        const int d = tc + 16 * c;
        const float v0 = sv[kk * D + d], v1 = sv[(kk + 1) * D + d];
        const float v2 = sv[(kk + 2) * D + d], v3 = sv[(kk + 3) * D + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = acc[i][c];
          t = fmaf(pa[i].x, v0, t);
          t = fmaf(pa[i].y, v1, t);
          t = fmaf(pa[i].z, v2, t);
          t = fmaf(pa[i].w, v3, t);
          acc[i][c] = t;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= Sq) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DT; ++c)
      ob[static_cast<size_t>(qi) * D + tc + 16 * c] = from_f32<T>(acc[i][c] / lsafe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Sq, int Sk, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Sk, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int D, const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Sk, int causal, int window,
             float sm_scale, cudaStream_t s) {
  using T = float;
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 80: return launch<T, 80>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// float32 q, k, v and o. The wrapper checks shapes, D (16, 32, 64, 80, 128
// or 256), Hq % Hkv == 0 and contiguity.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                   int causal, int window, float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(D, q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale,
                  static_cast<cudaStream_t>(stream));
}
