// K6: single-token decode attention over a KV cache (flash decoding), with
// the softmax statistics (m, l) of every query row, in one launch.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_pallas
// (Pallas body `_decode_kernel`).
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
// by the HBM bytes of the visible cache, at internlm2-1.8b's serving decode
// (B 8, Hkv 8, ~1060 visible of 1088 positions, D 128, bf16) ~35 MB, ~10 us
// at 3.35 TB/s. A real decode step streams every layer's cache through the
// 50 MB L2, so the cache arrives cold.
//
// Design: the G query rows of one KV head are handled together, so each
// cache row is read once per group, not once per query head. At batch 8 x 8
// KV heads there are only 64 (b, KV head) pairs for 132 SMs, so the cache
// length is split into n_split <= 8 chunks, one CTA each, and the n_split
// CTAs of a pair form one thread-block cluster (grid: split x KV head x
// batch, cluster n_split x 1 x 1). Each CTA reads lengths[b] itself and
// skips the part of its chunk that is not visible. It streams its chunk
// through a ring of NS = 2 tiles of TP positions in shared memory (K and
// V, 16-byte cp.async, 8 KB a tile: the next tile is in flight while it
// reduces the current one, ~32 KB in flight per SM at 4 CTAs an SM). A
// lane group of L lanes takes a position: each lane holds one 16-byte
// vector of the row (8 bf16; 4 f32, two vectors at D = 256), so half a
// warp covers a D = 128 bf16 row. A group reads its NP positions of a tile
// before it reduces any, the G dot products are shuffles within the group,
// and each group keeps its own running (m, l, acc) per query row, rescaled
// once per tile. The groups merge by shuffles, the 4 warps through shared
// memory (the ring, reused), into the CTA's partial (m, l, acc[G][D]) in
// its own shared memory. After cluster.sync(), each CTA of the cluster
// reads every rank's partial through distributed shared memory for its
// 1 / n_split share of the G x D outputs, merges them with the usual
// rescaling and writes that share of o (and of m and l); a second
// cluster.sync() keeps each CTA's shared memory alive until all have read
// it. No partials reach global memory and there
// is no second launch. No tensor cores: 2 G FLOPs per element do not need
// them.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "error.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int NS = 2;             // ring stages
constexpr int STAGE_BYTES = 8192; // K and V of one tile
constexpr int MAX_SPLIT = 8;      // a portable cluster
constexpr int DMAX = 256;
constexpr float NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory as VEC floats
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  union {
    uint4 u;
    T el[VEC];
  } x;
  x.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < VEC; ++e) out[e] = to_f32(x.el[e]);
}

// (m, l, acc) of one query row, merged with another's by the usual rescaling
template <int E>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&acc)[E], float m2,
                                            float l2, const float (&acc2)[E]) {
  const float mn = fmaxf(m, m2);
  const float a1 = expf(m - mn), a2 = expf(m2 - mn);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] * a1 + acc2[e] * a2;
  l = l * a1 + l2 * a2;
  m = mn;
}

// L lanes per cache position, NV 16-byte vectors per lane, up to GMAX query
// rows per KV head
template <typename T, int L, int NV, int GMAX>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const int* __restrict__ lengths,
                  T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                  int Hq, int Hkv, int S, int D, int window, float sm_scale, int chunk) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int E = NV * VEC;             // elements per lane
  constexpr int ROW = L * E;              // shared row stride, elements
  constexpr int PW = 32 / L;              // positions a warp takes at once
  constexpr int TP = STAGE_BYTES / (2 * ROW * sizeof(T));  // positions per tile
  constexpr int NP = TP / (WARPS * PW);   // positions per lane group and tile
  static_assert(NP * WARPS * PW == TP && ROW <= DMAX, "tile shapes");
  // the ring, reused after the loop for the warps' partials
  constexpr int MERGE_BYTES = WARPS * GMAX * ROW * sizeof(float);
  __shared__ __align__(16) unsigned char
      ring[NS * STAGE_BYTES > MERGE_BYTES ? NS * STAGE_BYTES : MERGE_BYTES];
  __shared__ float cta_acc[GMAX][ROW];
  __shared__ float cta_m[GMAX], cta_l[GMAX];
  __shared__ float warp_m[WARPS][GMAX], warp_l[WARPS][GMAX];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int li = lane % L, grp = lane / L;
  const int len = lengths[b];
  const int hi = min(max(len, 0), S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s_lo = max(lo, split * chunk);
  const int s_hi = min(hi, (split + 1) * chunk);
  const int n_tiles = s_hi > s_lo ? (s_hi - s_lo + TP - 1) / TP : 0;
  const int n_vec = (D + VEC - 1) / VEC;  // 16-byte vectors per row
  const bool vec_rows = D % VEC == 0;     // rows start 16-byte aligned

  const size_t row0 = static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G;
  const T* kb = kc + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* vb = vc + (static_cast<size_t>(b) * Hkv + hk) * S * D;

  // tile i's positions [s_lo + i TP, + TP) into stage i % NS, zeros past
  // s_hi (a row that is not 16-byte aligned is copied element by element)
  auto stage_tile = [&](int i) {
    T* sk = reinterpret_cast<T*>(ring + (i % NS) * STAGE_BYTES);
    T* sv = sk + TP * ROW;
    const int base = s_lo + i * TP;
    if (vec_rows) {
      for (int c = tid; c < TP * n_vec; c += THREADS) {
        const int r = c / n_vec, x = c % n_vec;
        const bool in = base + r < s_hi;
        const size_t off = static_cast<size_t>(in ? base + r : 0) * D + x * VEC;
        cp_async16(sk + r * ROW + x * VEC, kb + off, in);
        cp_async16(sv + r * ROW + x * VEC, vb + off, in);
      }
    } else {
      for (int c = tid; c < TP * n_vec * VEC; c += THREADS) {
        const int r = c / (n_vec * VEC), d = c % (n_vec * VEC);
        const bool in = base + r < s_hi && d < D;
        const size_t off = static_cast<size_t>(base + r) * D + d;
        sk[r * ROW + d] = in ? kb[off] : from_f32<T>(0.f);
        sv[r * ROW + d] = in ? vb[off] : from_f32<T>(0.f);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) stage_tile(i);
    cp_async_commit();
  }

  // this lane's elements of the G query rows, pre-scaled; 0 past D
  float qr[GMAX][E], m[GMAX], l[GMAX], acc[GMAX][E];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int d = (v * L + li) * VEC + e;
        qr[g][v * VEC + e] =
            g < G && d < D ? to_f32(q[(row0 + g) * D + d]) * sm_scale : 0.f;
        acc[g][v * VEC + e] = 0.f;
      }
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NS - 2>();  // tile t landed (this thread's copies)
    __syncthreads();          // everyone's copies, and tile t - 1 is consumed
    if (t + NS - 1 < n_tiles) stage_tile(t + NS - 1);
    cp_async_commit();
    const T* sk = reinterpret_cast<const T*>(ring + (t % NS) * STAGE_BYTES);
    const T* sv = sk + TP * ROW;
    // this lane group's NP positions of the tile, all loaded before any is
    // reduced, so that their shuffles and exponentials interleave
    float kr[NP][E], vr[NP][E];
    bool valid[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int r = (i * WARPS + warp) * PW + grp;
      valid[i] = s_lo + t * TP + r < s_hi;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float kx[VEC], vx[VEC];
        if ((v * L + li) < n_vec) {
          load_vec<T, VEC>(sk + r * ROW + (v * L + li) * VEC, kx);
          load_vec<T, VEC>(sv + r * ROW + (v * L + li) * VEC, vx);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kx[e] = vx[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kr[i][v * VEC + e] = kx[e];
          vr[i][v * VEC + e] = vx[e];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float s[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        s[i] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s[i] = fmaf(qr[g][e], kr[i][e], s[i]);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < NP; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      float m_new = m[g];
#pragma unroll
      for (int i = 0; i < NP; ++i) m_new = valid[i] ? fmaxf(m_new, s[i]) : m_new;
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float p = valid[i] ? expf(s[i] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vr[i][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the merge

  // merge the lane groups of a warp, then the warps, into the CTA's partial
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
      float acc2[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      merge_state<E>(m[g], l[g], acc[g], m2, l2, acc2);
    }
  }
  float* warp_acc = reinterpret_cast<float*>(ring);  // [WARPS][GMAX][ROW]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          warp_acc[(warp * GMAX + g) * ROW + (v * L + li) * VEC + e] = acc[g][v * VEC + e];
      if (li == 0) {
        warp_m[warp][g] = m[g];
        warp_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int x = tid; x < G * D; x += THREADS) {
    const int g = x / D, d = x % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, warp_m[w][g]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(warp_m[w][g] - mx);
      a += warp_acc[(w * GMAX + g) * ROW + d] * f;
      ls += warp_l[w][g] * f;
    }
    cta_acc[g][d] = a;
    if (d == 0) {
      cta_m[g] = mx;
      cta_l[g] = ls;
    }
  }

  // the cluster merges its partials through distributed shared memory: each
  // CTA reads every rank's (m, l, acc) for its share of the G x D outputs
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int x = rank * THREADS + tid; x < G * D; x += n_split * THREADS) {
    const int g = x / D, d = x % D;
    float pm[MAX_SPLIT], pl[MAX_SPLIT], pa[MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r >= n_split) break;
      pm[r] = cluster.map_shared_rank(cta_m, r)[g];
      pl[r] = cluster.map_shared_rank(cta_l, r)[g];
      pa[r] = cluster.map_shared_rank(&cta_acc[0][0], r)[g * ROW + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < n_split) mx = fmaxf(mx, pm[r]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r >= n_split) break;
      const float f = expf(pm[r] - mx);
      a += pa[r] * f;
      ls += pl[r] * f;
    }
    o[(row0 + g) * D + d] = from_f32<T>(a / (ls == 0.f ? 1.f : ls));
    if (d == 0) {
      m_out[row0 + g] = mx;
      l_out[row0 + g] = ls;
    }
  }
  cluster.sync();  // every CTA's shared memory stays until the others have read it
}

template <typename T, int L, int NV, int GMAX>
int launch(const T* q, const T* kc, const T* vc, const int* lengths, T* o, float* m,
           float* l, int B, int Hq, int Hkv, int S, int D, int window, float sm_scale,
           int chunk, int n_split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_kernel<T, L, NV, GMAX>, q, kc, vc,
                                             lengths, o, m, l, Hq, Hkv, S, D, window,
                                             sm_scale, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// lanes per position: the fewest powers of two whose 16-byte vectors cover
// D (at most a warp; f32 rows of 129..256 take two vectors a lane). Two
// vectors a lane for every row would halve the lanes and the shuffles per
// position, but its registers (~130 at G <= 2) leave 3 CTAs an SM, too few
// for the serving decode's 512 in one wave
template <typename T, int GMAX>
int dispatch_width(const void* q, const void* kc, const void* vc, const int* lengths,
                   void* o, float* m, float* l, int B, int Hq, int Hkv, int S, int D,
                   int window, float sm_scale, int chunk, int n_split, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int n_vec = (D + VEC - 1) / VEC;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(kc);
  const T* vp = static_cast<const T*>(vc);
  T* op = static_cast<T*>(o);
#define K6_CASE(lanes, nv)                                                              \
  return launch<T, lanes, nv, GMAX>(qp, kp, vp, lengths, op, m, l, B, Hq, Hkv, S, D, \
                                    window, sm_scale, chunk, n_split, s)
  if (n_vec <= 1) K6_CASE(1, 1);
  if (n_vec <= 2) K6_CASE(2, 1);
  if (n_vec <= 4) K6_CASE(4, 1);
  if (n_vec <= 8) K6_CASE(8, 1);
  if (n_vec <= 16) K6_CASE(16, 1);
  if (n_vec <= 32) K6_CASE(32, 1);
  if constexpr (VEC == 4) {
    if (n_vec <= 64) K6_CASE(32, 2);
  }
#undef K6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const int* lengths, void* o,
             float* m, float* l, int B, int Hq, int Hkv, int S, int D, int window,
             float sm_scale, int chunk, int n_split, cudaStream_t s) {
  if (Hq / Hkv <= 2)
    return dispatch_width<T, 2>(q, kc, vc, lengths, o, m, l, B, Hq, Hkv, S, D, window,
                                sm_scale, chunk, n_split, s);
  return dispatch_width<T, 8>(q, kc, vc, lengths, o, m, l, B, Hq, Hkv, S, D, window,
                              sm_scale, chunk, n_split, s);
}

}  // namespace

// One launch: o (B, Hq, D) in q's dtype, m and l (B, Hq) f32. The cache
// length S is cut into n_split <= 8 chunks of `chunk` positions (chunk *
// n_split >= S), one CTA each, one cluster per (b, KV head). dtype: 0
// float32, 1 bfloat16. The wrapper checks shapes, D <= 256, 1 <= Hq / Hkv
// <= 8, contiguity and 16-byte aligned bases.
extern "C" int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                const void* lengths, void* o, void* m, void* l, int B,
                                int Hq, int Hkv, int S, int D, int window, float sm_scale,
                                int chunk, int n_split, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 8 || D > DMAX || D <= 0 || chunk <= 0 ||
      n_split < 1 || n_split > MAX_SPLIT || static_cast<long long>(chunk) * n_split < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (dtype == 0)
    return dispatch<float>(q, k_cache, v_cache, len, o, mo, lo, B, Hq, Hkv, S, D, window,
                           sm_scale, chunk, n_split, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_cache, v_cache, len, o, mo, lo, B, Hq, Hkv, S, D,
                                   window, sm_scale, chunk, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
