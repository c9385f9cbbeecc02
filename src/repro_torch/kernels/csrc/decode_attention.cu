// K6: single-token decode attention over a KV cache (flash decoding), with
// the softmax statistics (m, l) of every query row.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (Pallas body `_decode_kernel`). The two launches below, the split pass
// and the combine pass, are together the port of that one TPU kernel.
//
// Semantics (as the TPU kernel's): q (B, Hq, D), caches (B, Hkv, S, D),
// lengths (B,) int32. Cache position p of sequence b is visible when
// p < lengths[b] and, if window > 0, p >= lengths[b] - window. The query is
// pre-scaled by sm_scale (in f32 here), so m = max over visible p of
// (q * sm_scale) . k_p, the TPU kernel's m, l = sum of exp(s_p - m), and
// o = sum exp(s_p - m) v_p / l, or 0 where l == 0 (m is then -1e30). m and
// l are f32 and feed a later log-sum-exp combine across cache shards; o is
// in q's dtype.
//
// Bound on an H100: every visible K and V element is read once and used for
// 2 * G FLOPs (G = Hq / Hkv query rows per KV head), far below the ~295
// FLOPs per byte at which the tensor cores would bind: the kernel is bound
// by the HBM bytes of the visible cache, at the serving shape (B 8, Hkv 8,
// ~1056 visible of 1088 positions, D 128, bf16) ~35 MB, ~10 us at 3.35 TB/s.
//
// Design: the G query rows of one KV head are handled by one CTA, so each
// cache row is read once per group, not once per query head. At batch 8 x 8
// KV heads there are only 64 (b, kv head) pairs for 132 SMs, so the cache
// length is split into chunks across CTAs (grid: chunk x kv head x batch),
// each CTA reads lengths[b] itself and skips the part of its chunk that is
// not visible. In a CTA each of 4 warps takes 4 positions at a time: lane
// holds E = ceil(D / 32) consecutive elements of a row (one 8- or 16-byte
// load per row when D = 32 E), the G dot products are warp shuffles, and
// the warp's (m, l, acc) update once per 4 positions. The 4 warps merge
// through shared memory into one partial (m, l, acc) per (row, chunk) in
// global scratch; the combine kernel merges the chunks of a row with the
// same rescaling and writes o, m and l. No tensor cores: 2 G FLOPs per
// element do not need them.
#include <cuda_bf16.h>

#include <type_traits>

#include "error.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;     // cache positions per warp step
constexpr int GMAX = 8;       // query rows per KV head
constexpr int DMAX = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Elements lane * E .. lane * E + E - 1 of a D-long row, as f32 (0 past D).
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int lane, int D,
                                         float (&out)[E]) {
  const int d0 = lane * E;
  if constexpr (sizeof(T) * E == 8 || sizeof(T) * E == 16) {
    if (D == 32 * E) {  // the whole row in one vector load per lane
      using V = typename std::conditional<sizeof(T) * E == 8, uint2, uint4>::type;
      union { V vec; T el[E]; } u;
      u.vec = *reinterpret_cast<const V*>(row + d0);
#pragma unroll
      for (int j = 0; j < E; ++j) out[j] = to_f32(u.el[j]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) out[j] = d0 + j < D ? to_f32(row[d0 + j]) : 0.f;
}

template <typename T, int E>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ lengths,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int Hq, int Hkv, int S, int D,
                        int window, float sm_scale, int chunk) {
  __shared__ float sm_m[WARPS][GMAX];
  __shared__ float sm_l[WARPS][GMAX];
  __shared__ float sm_acc[WARPS][GMAX][DMAX];

  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int len = lengths[b];
  const int hi = min(max(len, 0), S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s_lo = max(lo, split * chunk);
  const int s_hi = min(hi, (split + 1) * chunk);

  const size_t row0 = static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G;
  float qr[GMAX][E], m[GMAX], l[GMAX], acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) acc[g][j] = qr[g][j] = 0.f;
    if (g < G) {
      load_row<T, E>(q + (row0 + g) * D, lane, D, qr[g]);
#pragma unroll
      for (int j = 0; j < E; ++j) qr[g][j] *= sm_scale;
    }
  }

  const T* kb = kc + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* vb = vc + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  for (int p0 = s_lo + warp * UNROLL; p0 < s_hi; p0 += WARPS * UNROLL) {
    float kr[UNROLL][E], vr[UNROLL][E];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = min(p0 + u, s_hi - 1);  // a position past the chunk is masked below
      load_row<T, E>(kb + static_cast<size_t>(p) * D, lane, D, kr[u]);
      load_row<T, E>(vb + static_cast<size_t>(p) * D, lane, D, vr[u]);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float s[UNROLL], mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < E; ++j) t = fmaf(qr[g][j], kr[u][j], t);
        t = warp_sum(t);
        s[u] = p0 + u < s_hi ? t : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) acc[g][j] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = p0 + u < s_hi ? expf(s[u] - m_new) : 0.f;
        ps += p;
#pragma unroll
        for (int j = 0; j < E; ++j) acc[g][j] = fmaf(p, vr[u][j], acc[g][j]);
      }
      l[g] = alpha * l[g] + ps;
      m[g] = m_new;
    }
  }

  // merge the 4 warps' states into this chunk's partial
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (lane * E + j < D) sm_acc[warp][g][lane * E + j] = acc[g][j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sm_acc[w][g][d] * expf(sm_m[w][g] - mx);
    const size_t part = (row0 + g) * n_split + split;
    part_acc[part * D + d] = a;
    if (d == 0) {
      float ls = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) ls += sm_l[w][g] * expf(sm_m[w][g] - mx);
      part_m[part] = mx;
      part_l[part] = ls;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_combine_kernel(const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const float* __restrict__ part_acc, T* __restrict__ o,
                          float* __restrict__ m_out, float* __restrict__ l_out, int D,
                          int n_split) {
  const size_t row = blockIdx.x;
  const float* pm = part_m + row * n_split;
  const float* pl = part_l + row * n_split;
  float mx = NEG_INF;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  float ls = 0.f;
  for (int s = 0; s < n_split; ++s) ls += pl[s] * expf(pm[s] - mx);
  const float lsafe = ls == 0.f ? 1.f : ls;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += part_acc[(row * n_split + s) * D + d] * expf(pm[s] - mx);
    o[row * D + d] = from_f32<T>(a / lsafe);
  }
  if (threadIdx.x == 0) {
    m_out[row] = mx;
    l_out[row] = ls;
  }
}

template <typename T, int E>
int launch_split(const void* q, const void* kc, const void* vc, const int* lengths,
                 float* pm, float* pl, float* pa, int B, int Hq, int Hkv, int S,
                 int D, int window, float sm_scale, int chunk, int n_split,
                 cudaStream_t stream) {
  const dim3 grid(n_split, Hkv, B);
  decode_split_kernel<T, E><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      lengths, pm, pl, pa, Hq, Hkv, S, D, window, sm_scale, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_split(const void* q, const void* kc, const void* vc, const int* lengths,
                   float* pm, float* pl, float* pa, int B, int Hq, int Hkv, int S,
                   int D, int window, float sm_scale, int chunk, int n_split,
                   cudaStream_t s) {
#define K6_CASE(e)                                                                  \
  case e:                                                                           \
    return launch_split<T, e>(q, kc, vc, lengths, pm, pl, pa, B, Hq, Hkv, S, D, \
                              window, sm_scale, chunk, n_split, s);
  switch ((D + 31) / 32) {
    K6_CASE(1) K6_CASE(2) K6_CASE(3) K6_CASE(4)
    K6_CASE(5) K6_CASE(6) K6_CASE(7) K6_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K6_CASE
}

}  // namespace

// The split pass: one partial (m, l, acc) per (b, query head, chunk) into
// part_m, part_l (B * Hq * n_split) and part_acc (B * Hq * n_split * D) f32.
// chunk * n_split >= S. dtype: 0 float32, 1 bfloat16. The wrapper checks
// shapes, D <= 256, 1 <= Hq / Hkv <= 8 and contiguity.
extern "C" int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                const void* lengths, void* part_m, void* part_l,
                                void* part_acc, int B, int Hq, int Hkv, int S, int D,
                                int window, float sm_scale, int chunk, int n_split,
                                int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX || D > DMAX || D <= 0 || chunk <= 0 ||
      static_cast<long long>(chunk) * n_split < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return dispatch_split<float>(q, k_cache, v_cache, len, pm, pl, pa, B, Hq, Hkv, S, D,
                                 window, sm_scale, chunk, n_split, s);
  if (dtype == 1)
    return dispatch_split<__nv_bfloat16>(q, k_cache, v_cache, len, pm, pl, pa, B, Hq,
                                         Hkv, S, D, window, sm_scale, chunk, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The combine pass: merges the n_split partials of each of the B * Hq rows
// into o (B, Hq, D) in q's dtype and m, l (B, Hq) f32.
extern "C" int decode_attention_combine(const void* part_m, const void* part_l,
                                        const void* part_acc, void* o, void* m, void* l,
                                        int rows, int D, int n_split, int dtype,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  const float* pa = static_cast<const float*>(part_acc);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (dtype == 0)
    decode_combine_kernel<float><<<rows, THREADS, 0, s>>>(pm, pl, pa, static_cast<float*>(o),
                                                          mo, lo, D, n_split);
  else if (dtype == 1)
    decode_combine_kernel<__nv_bfloat16><<<rows, THREADS, 0, s>>>(
        pm, pl, pa, static_cast<__nv_bfloat16*>(o), mo, lo, D, n_split);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
