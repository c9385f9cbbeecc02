// Task-body device functions shared by the four Task Bench kernels.
//
// Counterpart of src/repro/kernels/bodies.py: one definition of each grain
// body, included by the FMA kernel (taskbench_compute.cu), the memory sweep
// (memory_bound.cu) and the two megakernels (taskbench_step.cu,
// taskbench_blocked.cu), so every kernel runs the same arithmetic. The
// plain PyTorch twins live in repro_torch/kernels/bodies.py.
#pragma once

#include <cuda_runtime.h>

#include "error.cuh"

namespace tb {

// x <- A*x + B. A = 0.5 is a power of two, so A*x is exact and fmaf rounds
// exactly like the plain version's multiply-then-add.
constexpr float FMA_A = 0.5f;
constexpr float FMA_B = 0.1f;
// The memory sweep's per-pass increment.
constexpr float SWEEP_ADD = 1e-6f;

// Iterated FMA over N independent values held in registers. Each value is a
// dependent chain of `iterations` FMAs, so N chains per thread give the
// scheduler N independent instructions to hide the FMA latency with.
template <int N>
__device__ __forceinline__ void fma_body(float (&v)[N], int iterations) {
  for (int i = 0; i < iterations; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = fmaf(v[j], FMA_A, FMA_B);
  }
}

// cp.async: a 4-byte copy from global to shared memory that the thread does
// not wait for; copies are grouped by commit_async and awaited by
// wait_async<N> (all but the N newest groups complete).
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory layout of one warp's memory sweep: the true payload row,
// then the two scratch buffers, each rounded up to 16 bytes so that every
// part starts 16-byte aligned when the base does.
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr size_t sweep_floats(int payload, int scratch) {
  return static_cast<size_t>(round4(payload)) + 2 * static_cast<size_t>(round4(scratch));
}

namespace sweep {

constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 8;  // words a lane keeps in flight per pass step

// A word is V consecutive floats: V = 4 moves 16 bytes per lane and access
// (ld.shared.v4 / st.shared.v4), V = 1 one float.
template <int V>
__device__ __forceinline__ void load(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// acc = the sum of words i0, i0 + step, i0 + 2 step, ... below n of buf,
// taken as four interleaved partial sums so that four loads are in flight.
template <int V>
__device__ __forceinline__ void sum_words(float (&acc)[V], const float* buf,
                                          int i0, int step, int n) {
  float part[4][V] = {};
  int i = i0;
  for (; i + 3 * step < n; i += 4 * step) {
    float x[4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u) load<V>(x[u], buf + V * (i + u * step));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) part[u][v] += x[u][v];
    }
  }
  for (; i < n; i += step) {
    float x[V];
    load<V>(x, buf + V * i);
#pragma unroll
    for (int v = 0; v < V; ++v) part[0][v] += x[v];
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    acc[v] = (part[0][v] + part[1][v]) + (part[2][v] + part[3][v]);
}

// The sweep in words of V floats (scratch and payload multiples of V; row,
// buf0 and buf1 16-byte aligned for V = 4).
template <int V>
__device__ __forceinline__ void sweep_words(const float* row, float* out,
                                            int payload, int iterations,
                                            int scratch, float* buf0,
                                            float* buf1) {
  const int lane = threadIdx.x & 31;
  const int n = scratch / V;   // words in the buffer
  const int pw = payload / V;  // words in the payload
  // tile-out: word i holds row[(V * i) mod payload ...]; m follows that
  // offset as i steps by 32, so the loop needs no modulo
  {
    const int step = (32 * V) % payload;
    int m = (lane * V) % payload;
    int i = lane;
    for (; i + 3 * 32 < n; i += 4 * 32) {  // four words in flight
      int mm[4];
      mm[0] = m;
#pragma unroll
      for (int u = 1; u < 4; ++u) {
        mm[u] = mm[u - 1] + step;
        if (mm[u] >= payload) mm[u] -= payload;
      }
      float x[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) load<V>(x[u], row + mm[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) store<V>(buf0 + V * (i + 32 * u), x[u]);
      m = mm[3] + step;
      if (m >= payload) m -= payload;
    }
    for (; i < n; i += 32) {
      float x[V];
      load<V>(x, row + m);
      store<V>(buf0 + V * i, x);
      m += step;
      if (m >= payload) m -= payload;
    }
  }
  __syncwarp();
  // passes: roll right by one float and add. Lane l keeps words
  // i = 32 q + l; the float rolled into its word's first slot is the last
  // float of word i - 1, the neighbouring lane's, taken by a shuffle (lane
  // 0 takes the last float of the step before, and at i = 0 the buffer's
  // last float). Every word is read from `cur` and written to `nxt`.
  float* cur = buf0;
  float* nxt = buf1;
  for (int it = 0; it < iterations; ++it) {
    float carry = cur[scratch - 1];
    for (int i0 = 0; i0 < n; i0 += 32 * UNROLL) {
      float x[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + 32 * u + lane;
        if (i < n) {
          load<V>(x[u], cur + V * i);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) x[u][v] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + 32 * u + lane;
        const float rot = __shfl_sync(FULL, x[u][V - 1], (lane + 31) & 31);
        float y[V];
        y[0] = (lane == 0 ? carry : rot) + SWEEP_ADD;
#pragma unroll
        for (int v = 1; v < V; ++v) y[v] = x[u][v - 1] + SWEEP_ADD;
        carry = rot;  // lane 0 now holds word (i0 + 32 u + 31)'s last float
        if (i < n) store<V>(nxt + V * i, y);
      }
    }
    // one warp barrier per pass: every lane reads `cur`'s last float
    __syncwarp();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  // fold: the mean over reps = ceil(scratch / payload) repeats, the zero
  // tail counted. With pw <= 32 words, lpg lanes share a payload word g,
  // each summing every lpg-th repeat, and a shuffle tree adds their sums.
  const int reps = (scratch + payload - 1) / payload;
  const float denom = static_cast<float>(reps);
  if (pw <= 32) {
    const int lpg = 32 / pw;
    const int s = lane / pw;
    const int g = lane - s * pw;
    float acc[V] = {};
    if (s < lpg) sum_words<V>(acc, cur, s * pw + g, lpg * pw, n);
    for (int t = 1; t < lpg; t <<= 1) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = __shfl_down_sync(FULL, acc[v], t * pw);
      if ((s & (2 * t - 1)) == 0 && s + t < lpg) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += o[v];
      }
    }
    if (s == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) out[V * g + v] = acc[v] / denom;
    }
  } else {
    for (int g = lane; g < pw; g += 32) {
      float acc[V];
      sum_words<V>(acc, cur, g, pw, n);
#pragma unroll
      for (int v = 0; v < V; ++v) out[V * g + v] = acc[v] / denom;
    }
  }
}

}  // namespace sweep

// Warp-cooperative memory sweep of one row; all 32 lanes of the calling
// warp call it, and nothing else touches its buffers meanwhile. `row`
// holds the true payload in shared memory; `out` (global or shared)
// receives `payload` floats. row, buf0 and buf1 are laid out as
// sweep_floats says, from a 16-byte aligned base.
//
// Semantics (bodies.py::memory_sweep_body): tile the payload out to
// `scratch` floats; `iterations` times roll the buffer right by one and add
// SWEEP_ADD; fold back by the mean over ceil(scratch / payload) repeats, the
// zero-padded tail counted in the denominator. iterations == 0 is the
// identity. Every pass is a full read and write of the buffer through the
// other buffer, in shared memory (no folding of passes, no index-offset
// roll): the body exists to move bytes. With scratch and payload multiples
// of 4 each lane moves 16 bytes an access; otherwise 4 (the scalar path).
// A pass ends at a warp barrier.
__device__ __forceinline__ void memory_sweep_warp(const float* row, float* out,
                                                  int payload, int iterations,
                                                  int scratch, float* buf0,
                                                  float* buf1) {
  if (iterations == 0) {
    for (int c = threadIdx.x & 31; c < payload; c += 32) out[c] = row[c];
  } else if ((scratch & 3) == 0 && (payload & 3) == 0) {
    sweep::sweep_words<4>(row, out, payload, iterations, scratch, buf0, buf1);
  } else {
    sweep::sweep_words<1>(row, out, payload, iterations, scratch, buf0, buf1);
  }
  // the caller may reuse the buffers (and the row) for its next row
  __syncwarp();
}

}  // namespace tb
