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
// exponent is positive (dtA <= 0) and may overflow, so the kernel takes
// exp(-inf) = 0 there rather than exp-then-mask, which would meet inf * 0.
// For an f32 x the products are taken as scores (X * dt) and
// (B * exp(a_T - a))^T (X * dt), X * dt rounded once; for a bf16 x as
// (scores * dt) X and (B * exp(a_T - a) * dt)^T X, keeping X exact.
//
// Bound on an H100: at the mamba2-130m serving prefill (BC 64, H 24, G 1,
// T = N = 128, P 64, f32 operands) the work is C B^T once per (chunk,
// group) and the two head products, ~5.0 GFLOP, against ~161 MB of x, y,
// B, C, dtA, dt and state, 48 us at 3.35 TB/s. On the units the kernel
// uses (C B^T at the 67 TFLOP/s f32 FMA peak, 2.0 us; the head products
// on the 495 TFLOP/s TF32 tensor cores as six (Y) and three (state) TF32
// products each, 39.7 us) it is bound by bytes (75 us with everything at
// the f32 FMA peak; chip_smoke.py computes all three from the run's
// shapes).
//
// Design: one CTA of 8 warps per (chunk i, group g, block of the group's
// heads). It forms the causal C B^T once and applies it to every head of
// its block, so each (chunk, group) forms it once per head block; the host
// picks the number of blocks from the card's SMs and the CTAs an SM holds
// (`ssd_chunk_plan`): 2 blocks of 12 heads at mamba2's shape, 4 of 12-13 at
// hymba's, 128 CTAs, one wave.
// - C B^T: warp pair p = warp / 2 owns query row blocks p and 7 - p, so
//   that every pair does the same causal work: their 18 (16 x 8) tiles on
//   and below the diagonal, 9 per warp, kept in registers (36 a thread)
//   for every head. They are summed on the CUDA cores in f32 FMAs over n
//   in ascending order, as a plain f32 product sums them: the served
//   model's logits follow the plain version's rounding of C B^T, and with
//   C B^T summed exactly or on the tensor cores mamba2's teacher-forced
//   logits read 1.6% (rms) from the plain path's, past chip_smoke.py's
//   limit of 1.5%, against 1.0% with C B^T alone rounded as the plain
//   version rounds it (`launch/ssd_rounding.py`, PERF.md §6).
// - Y = ((C B^T) * L) (X * dt) and state = (B * exp(a_T - a))^T (X * dt)
//   (for a bf16 x, which is exact in TF32, dt goes with the scores and
//   exp(a_T - a) instead) run on the tensor cores as mma.sync.m16n8k8
//   TF32 with f32 accumulators. One TF32 rounding (10 mantissa bits) puts
//   ~5e-4 relative error on a product, beyond the 2e-5 the outputs are
//   held to, so each f32 operand is split into TF32 parts (rna(x), then
//   rna of the rest; rna by integer ops: cvt.rna.tf32.f32 made the kernel
//   ~30% slower). The state's take two, hi + lo, and a product three
//   terms (hi hi + hi lo + lo hi); Y's, whose rounding the served logits
//   see next after C B^T's, three, hi + mid + lo, and a product six terms
//   (to ~2^-33). A bf16 x is exact in TF32, so its products take one term
//   per part of the other operand. The tensor cores round their sums
//   toward zero: a chain of products into one accumulator drifts, so each
//   chain is one k-step and the k-steps' sums are added on the CUDA cores.
// - Y: each warp runs its 9 tiles over all of P. The scores are formed in
//   registers from the held tiles, exp(a_i - a_j) only on and below the
//   diagonal, split, and fed as the A operand: the accumulator layout of a
//   (16 x 8) tile is the A layout of an 8-deep k-step once the k index is
//   permuted (logical k t and t + 4 are keys 2t and 2t + 1), so X's rows
//   are read in that order. A row block that two warps share is summed
//   through shared memory.
// - state: items of (2 slices of 16 rows of N) x (4 column tiles of P),
//   one a warp at mamba2's shape; B read from shared memory, scaled by
//   exp(a_T - a) (times dt for a bf16 x) and split per k-step.
// X tiles sit in a 2-stage ring filled by 16-byte cp.async (zero-filled
// past T), so that the next head's X arrives while this head's products
// run; an f32 X * dt is split once per head (hi in place, lo beside it). The
// cumsum of dtA stays in token order (one lane per head, 128 dependent
// adds, run while B, C and the first X tiles load): a tree scan would
// round a_i - a_j differently, and at a ~ -640 one f32 ulp is 6e-5, which
// exp passes straight on. Shared memory is B, C (then the rest of X * dt
// and the shared Y sums), the X ring and 3 T floats a head for a, dt and w:
// 218 KB at mamba2's shape, one CTA an SM. Diagnostic builds on the card
// (`launch/kernel_variants.py`, PERF.md §6) put the time in the
// instructions around the products (fragment loads and splits, the
// scores) at 8 warps an SM, not in the tensor cores or the bytes; wgmma,
// with its operands read from shared memory, is the next step. Limits:
// T <= 128 (8 row blocks), P <= 64 (8 column tiles), and the tiles must
// fit in shared memory; other shapes are refused.
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "error.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TMAX = 128;  // 8 row blocks of 16: 4 warp pairs (p, 7 - p)
constexpr int PMAX = 64;   // 2 halves of 4 column tiles of 8
constexpr int GTILES = 18;  // C B^T tiles a warp pair holds
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory
// The products with a residual part of either operand (false: one TF32
// rounding of each operand in Y and the state, a control that the check
// must fail).
constexpr bool kLoTerms = true;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

constexpr int RED = 8 * 8 * 4 * 32;  // floats of the 4 pairs' partial and parked Y tiles

// Shared-memory layout (byte offsets): B; C, whose space then holds the
// rest of X * dt past its TF32 hi (f32 x) and the pairs' partial Y; the X
// ring; the per-head vectors a, dt and w.
struct Layout {
  int tp;  // rows of the B, C and X tiles: T rounded up to 16
  int sb;  // row stride of B and C, in floats: N rounded up to 16, + 4
  int sx;  // row stride of an X stage, in elements: P rounded up to 8, + 16 bytes
  size_t b, r1, xlo, red, x, vec, bytes;
  __host__ __device__ Layout(int T, int N, int P, int heads, int item) {
    tp = round_up(T, 16);
    sb = round_up(N, 16) + 4;
    sx = round_up(P, 8) + 16 / item;
    const size_t cbytes = size_t(4) * tp * sb;
    const size_t lobytes = item == 4 ? size_t(4) * tp * sx : 0;
    const size_t r1bytes = cbytes > lobytes + 4 * RED ? cbytes : lobytes + 4 * RED;
    b = 0;
    r1 = size_t(4) * tp * sb;
    xlo = r1;
    red = r1 + lobytes;
    x = r1 + r1bytes;
    vec = x + size_t(2) * tp * sx * item;
    bytes = vec + size_t(4) * 3 * heads * TMAX;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
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

// TF32 of x, rounded to nearest (ties away from zero), as the 32-bit
// pattern: half a TF32 ulp added to the magnitude bits, the 13 low bits
// cleared (cvt.rna.tf32.f32's result for finite x, in two integer ops)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo, both TF32 (lo the rounded residual)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// x = hi + mid + lo, three TF32 parts (to ~2^-33 of x)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = tf32(x);
  const float r = x - __uint_as_float(hi);
  mid = tf32(r);
  lo = tf32(r - __uint_as_float(mid));
}

// d (16 x 8) += a (16 x 8, row) b (8 x 8, col), TF32 in, f32 accumulate
// (the sum rounded toward zero).
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); d0 (g, 2t), d1 (g,
// 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// o[0] = a and, if `two`, o[1] = b: one 8-byte (f32) or 4-byte (bf16)
// store where `pair` says o is aligned for it
__device__ __forceinline__ void store2(float* o, float a, float b, bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  } else {
    o[0] = a;
    if (two) o[1] = b;
  }
}
__device__ __forceinline__ void store2(bf16* o, float a, float b, bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  } else {
    o[0] = __float2bfloat16(a);
    if (two) o[1] = __float2bfloat16(b);
  }
}

// The B fragment pair of X at offsets o and o + ld (rows j0, j0 + 1) in
// TF32 parts: a bf16 x converted exactly (no other parts); an f32 x from
// the split tile, its hi in xs and the exact rest x - hi in xr, as hi + lo
// (`xfrag`) or hi + mid + lo (`xfrag3`)
__device__ __forceinline__ void xfrag(const float* xs, const float* xr, int o, int ld,
                                      uint32_t (&h)[2], uint32_t (&l)[2]) {
  h[0] = __float_as_uint(xs[o]);
  h[1] = __float_as_uint(xs[o + ld]);
  l[0] = tf32(xr[o]);
  l[1] = tf32(xr[o + ld]);
}
__device__ __forceinline__ void xfrag(const bf16* xs, const float*, int o, int ld,
                                      uint32_t (&h)[2], uint32_t (&l)[2]) {
  h[0] = __float_as_uint(__bfloat162float(xs[o]));
  h[1] = __float_as_uint(__bfloat162float(xs[o + ld]));
  l[0] = l[1] = 0u;
}
__device__ __forceinline__ void xfrag3(const float* xs, const float* xr, int o, int ld,
                                       uint32_t (&h)[2], uint32_t (&m)[2], uint32_t (&l)[2]) {
  h[0] = __float_as_uint(xs[o]);
  h[1] = __float_as_uint(xs[o + ld]);
  const float r[2] = {xr[o], xr[o + ld]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = tf32(r[i]);
    l[i] = tf32(r[i] - __uint_as_float(m[i]));
  }
}
__device__ __forceinline__ void xfrag3(const bf16* xs, const float* xr, int o, int ld,
                                       uint32_t (&h)[2], uint32_t (&m)[2], uint32_t (&l)[2]) {
  xfrag(xs, xr, o, ld, h, l);
  m[0] = m[1] = 0u;
}

// Rows row, row + 8 of a (T, P) output yh from a (16 x 64) tile in the
// accumulator layout (8 column tiles), rows past T and columns past P left
template <typename T>
__device__ __forceinline__ void store_y(T* yh, int P, int Tn, int row, int tq,
                                       const float (&v)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r < Tn && col < P)
        store2(yh + size_t(r) * P + col, v[n][2 * half], v[n][2 * half + 1], col + 1 < P,
               P % 2 == 0);
    }
  }
}

// rows x cols of a global (rows_valid, cols_valid) tile with row stride
// src_ld into shared memory (row stride dst_ld), zero past the valid part,
// element by element (converting): the path for a shape or pointer that
// 16-byte copies do not fit, kept out of the kernel's hot code
template <typename S, typename D>
__device__ __noinline__ void stage_elems(D* dst, int dst_ld, const S* src, int src_ld,
                                         int rows_valid, int cols_valid, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
    const int r = e / cols, c = e % cols;
    dst[r * dst_ld + c] = (r < rows_valid && c < cols_valid)
                              ? D(to_f32(src[size_t(r) * src_ld + c]))
                              : D(0.f);
  }
}

// The same with 16-byte cp.async when `vec` (same dtype, cols_valid a
// multiple of 16 bytes, src 16-byte aligned), else `stage_elems`.
template <typename S, typename D>
__device__ __forceinline__ void stage(D* dst, int dst_ld, const S* src, int src_ld,
                                      int rows_valid, int cols_valid, int rows, int cols,
                                      bool vec) {
  if constexpr (std::is_same_v<S, D>) {
    if (vec) {
      constexpr int E = 16 / sizeof(S);
      const int cpr = cols / E;
      for (int e = threadIdx.x; e < rows * cpr; e += THREADS) {
        const int r = e / cpr, c = (e % cpr) * E;
        const bool valid = r < rows_valid && c < cols_valid;
        cp_async16(dst + r * dst_ld + c, valid ? src + size_t(r) * src_ld + c : src, valid);
      }
      return;
    }
  }
  stage_elems(dst, dst_ld, src, src_ld, rows_valid, cols_valid, rows, cols);
}

template <typename T, int NTW>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ b,
                     const T* __restrict__ c, const float* __restrict__ dta,
                     const float* __restrict__ dt, T* __restrict__ y,
                     float* __restrict__ state, int H, int G, int Tn, int N, int P, int nblk,
                     int hbmax, int vec_x, int vec_bc) {
  constexpr bool XEXACT = std::is_same_v<T, bf16>;  // x, B and C exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(Tn, N, P, hbmax, sizeof(T));
  float* sb = reinterpret_cast<float*>(smem + L.b);     // (tp, sb) B
  float* sc = reinterpret_cast<float*>(smem + L.r1);    // (tp, sb) C, until C B^T
  float* sxl = reinterpret_cast<float*>(smem + L.xlo);  // (tp, sx) X * dt - hi
  float* red = reinterpret_cast<float*>(smem + L.red);  // 4 partial Y tiles
  T* sx = reinterpret_cast<T*>(smem + L.x);             // 2 x (tp, sx) X
  float* sa = reinterpret_cast<float*>(smem + L.vec);  // (hbmax, TMAX) a
  float* sdt = sa + hbmax * TMAX;                       // dt
  float* sw = sdt + hbmax * TMAX;                       // dtA, then w (below)

  const int Hg = H / G;
  const int blk = blockIdx.x % nblk;
  const int ig = blockIdx.x / nblk;  // i * G + g
  const int i = ig / G, g = ig % G;
  const int h0 = g * Hg + blk * Hg / nblk;            // first head of the block
  const int nh = g * Hg + (blk + 1) * Hg / nblk - h0;  // heads in the block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;  // fragment row group, thread in group
  const int tp = L.tp, NP8 = round_up(N, 8), NP16 = round_up(N, 16), PP = round_up(P, 8);
  const size_t bc_off = size_t(ig) * Tn * N;
  const size_t head_x = size_t(Tn) * P;  // x / y elements per (i, h)

  auto load_x = [&](int hl, int s) {
    const size_t bh = size_t(i) * H + h0 + hl;
    stage(sx + s * tp * L.sx, L.sx, x + bh * head_x, P, Tn, P, tp, PP, vec_x);
  };
  // B, C and the first two heads' X; dtA and dt of every head of the block
  stage(sb, L.sb, b + bc_off, N, Tn, N, tp, NP16, vec_bc);
  stage(sc, L.sb, c + bc_off, N, Tn, N, tp, NP16, vec_bc);
  load_x(0, 0);
  cp_async_commit();
  if (nh > 1) load_x(1, 1);
  cp_async_commit();
  for (int e = tid; e < nh * TMAX; e += THREADS) {
    const int hl = e / TMAX, t = e % TMAX;
    const size_t o = (size_t(i) * H + h0 + hl) * Tn + t;
    sw[e] = t < Tn ? dta[o] : 0.f;
    sdt[e] = t < Tn ? dt[o] : 0.f;
  }
  __syncthreads();
  // a = cumsum(dtA) in token order, one lane per head, while B, C and X
  // load; past T it holds a_T (finite, never used unmasked)
  if (lane == 0)
    for (int hl = warp; hl < nh; hl += WARPS) {
      const float* d = sw + hl * TMAX;  // 0 past T: adding it leaves s as it is
      float* o = sa + hl * TMAX;
      float s = 0.f;
      for (int t0 = 0; t0 < TMAX; t0 += 8) {  // 8 loads issued, then 8 adds in order
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = d[t0 + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          s += v[u];
          v[u] = s;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) o[t0 + u] = v[u];
      }
    }
  cp_async_wait<1>();
  __syncthreads();

  // ---- C B^T, once for the block. Warp pair p = warp / 2 owns query row
  // blocks r0 = p and r1 = 7 - p: their 18 (16 x 8) tiles on and below the
  // diagonal, listed as k = 0 .. 2p + 1 for (r0, key tile k) and then
  // k = 2p + 2 .. 17 for (r1, key tile 17 - k). Warp q = warp % 2 of the
  // pair forms tiles 9q .. 9q + 8 and keeps them in registers for Y.
  const int p = warp / 2, q = warp % 2;
  const int r0 = p, r1 = 7 - p;
  // row block and key tile of this warp's tile kk
  auto tile_row = [&](int kk) { return 9 * q + kk <= 2 * p + 1 ? r0 : r1; };
  auto tile_key = [&](int kk) {
    const int k = 9 * q + kk;
    return k <= 2 * p + 1 ? k : GTILES - 1 - k;
  };
  auto tile_in = [&](int kk) { return 16 * tile_row(kk) < Tn && 8 * tile_key(kk) < Tn; };
  // On the CUDA cores, in f32 FMAs over n in ascending order, as a plain
  // f32 product sums it: the served model's logits follow the rounding of
  // C B^T (PERF.md §6), so K7 keeps it, while Y and the state, which
  // they do not follow, run on the tensor cores.
  float cbt[9][4];  // C B^T tiles, in the accumulator layout
#pragma unroll
  for (int kk = 0; kk < 9; ++kk) {
    float g00 = 0.f, g01 = 0.f, g10 = 0.f, g11 = 0.f;
    if (tile_in(kk)) {
      const float* c0 = sc + (16 * tile_row(kk) + gr) * L.sb;  // rows i0, i0 + 8
      const float* c1 = c0 + 8 * L.sb;
      const float* b0 = sb + (8 * tile_key(kk) + 2 * tq) * L.sb;  // keys j0, j0 + 1
      const float* b1 = b0 + L.sb;
      for (int n = 0; n < NP8; n += 4) {  // past N: zeros, which add nothing
        const float4 u0 = *reinterpret_cast<const float4*>(c0 + n);
        const float4 u1 = *reinterpret_cast<const float4*>(c1 + n);
        const float4 v0 = *reinterpret_cast<const float4*>(b0 + n);
        const float4 v1 = *reinterpret_cast<const float4*>(b1 + n);
        const float cu[2][4] = {{u0.x, u0.y, u0.z, u0.w}, {u1.x, u1.y, u1.z, u1.w}};
        const float bv[2][4] = {{v0.x, v0.y, v0.z, v0.w}, {v1.x, v1.y, v1.z, v1.w}};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          g00 = fmaf(cu[0][e], bv[0][e], g00);
          g01 = fmaf(cu[0][e], bv[1][e], g01);
          g10 = fmaf(cu[1][e], bv[0][e], g10);
          g11 = fmaf(cu[1][e], bv[1][e], g11);
        }
      }
    }
    cbt[kk][0] = g00;
    cbt[kk][1] = g01;
    cbt[kk][2] = g10;
    cbt[kk][3] = g11;
  }
  // w = exp(a_T - a) dt, 0 past T; for an f32 x, whose rows take dt in
  // the split below, exp(a_T - a)
  for (int e = tid; e < nh * TMAX; e += THREADS) {
    const int hl = e / TMAX, t = e % TMAX;
    const float decay = expf(sa[hl * TMAX + Tn - 1] - sa[e]);
    sw[e] = t < Tn ? (XEXACT ? decay * sdt[e] : decay) : 0.f;
  }
  __syncthreads();  // C is read: its space takes X's residuals and partial Y

  // state tiles: 16-row slices of N, column tiles of 8 of P; a work item
  // takes MS slices (below) by NTW tiles
  const int mt = NP16 / 16, nt = PP / 8, nchunks = (nt + NTW - 1) / NTW;
  const int mchunks = NTW == 1 ? mt : (mt + 1) / 2;

  for (int hl = 0; hl < nh; ++hl) {
    const int s = hl & 1;
    T* xs = sx + s * tp * L.sx;
    cp_async_wait<1>();
    __syncthreads();  // this head's X tile is in
    if constexpr (!XEXACT) {
      // X * dt in TF32 parts once for the head, 4 floats at a time: hi in
      // place, the exact rest beside it (x * dt rounded as the plain version
      // rounds it, whose Y the served logits follow; 0 past T)
      const int c4 = PP / 4;
      for (int e = tid; e < tp * c4; e += THREADS) {
        const int r = e / c4, o = r * L.sx + 4 * (e - r * c4);
        const float d = sdt[hl * TMAX + r];
        float4 v = *reinterpret_cast<float4*>(xs + o), lo;
        float* vh = &v.x;
        float* vl = &lo.x;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float xv = vh[u] * d;
          const uint32_t h = tf32(xv);
          vh[u] = __uint_as_float(h);
          vl[u] = xv - __uint_as_float(h);
        }
        *reinterpret_cast<float4*>(xs + o) = v;
        *reinterpret_cast<float4*>(sxl + o) = lo;
      }
      __syncthreads();
    }
    const float* a = sa + hl * TMAX;
    const float* dth = sdt + hl * TMAX;
    const float* wh = sw + hl * TMAX;
    const size_t bh = size_t(i) * H + h0 + hl;
    // ---- Y = ((C B^T) * L * dt) X over this warp's 9 tiles, all 8 column
    // tiles of P (those past P read row 0's columns and are not stored).
    // Warp q = 1 has only block r1's tiles; warp q = 0 has all of r0's,
    // which it stores when they are done, then some of r1's, whose partial
    // sum it hands to q = 1 through shared memory.
    {
      float acc[8][4] = {};
#pragma unroll
      for (int kk = 0; kk < 9; ++kk) {
        if (q == 0 && kk == 2 * p + 2) {  // r0 is done: park it in red (slot 4 + p)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              red[((4 + p) * 32 + n * 4 + e) * 32 + lane] = acc[n][e];
              acc[n][e] = 0.f;
            }
        }
        const bool in = tile_in(kk);
        const int i0 = 16 * tile_row(kk) + gr;
        const int j0 = (in ? 8 * tile_key(kk) : 0) + 2 * tq;  // keys of logical k = tq, tq + 4
        const float ai0 = a[i0], ai1 = a[i0 + 8];
        const float aj0 = a[j0], aj1 = a[j0 + 1], dj0 = dth[j0], dj1 = dth[j0 + 1];
        // scores at (i0, j0), (i0, j0 + 1), (i0 + 8, j0), (i0 + 8, j0 + 1),
        // times dt where x does not carry it (bf16)
        float s00 = cbt[kk][0] * __expf(j0 <= i0 ? ai0 - aj0 : -INFINITY);
        float s01 = cbt[kk][1] * __expf(j0 + 1 <= i0 ? ai0 - aj1 : -INFINITY);
        float s10 = cbt[kk][2] * __expf(j0 <= i0 + 8 ? ai1 - aj0 : -INFINITY);
        float s11 = cbt[kk][3] * __expf(j0 + 1 <= i0 + 8 ? ai1 - aj1 : -INFINITY);
        if constexpr (XEXACT) s00 *= dj0, s01 *= dj1, s10 *= dj0, s11 *= dj1;
        // the scores in three TF32 parts, X * dt in three (f32) or one
        // (bf16): Y's rounding is what the served logits see after C B^T's
        uint32_t ah[4], am[4], al[4];
        split3(s00, ah[0], am[0], al[0]);
        split3(s10, ah[1], am[1], al[1]);
        split3(s01, ah[2], am[2], al[2]);
        split3(s11, ah[3], am[3], al[3]);
        float part[8][4] = {};  // this tile's products alone (see the header)
#pragma unroll
        for (int n0 = 0; n0 < 8; n0 += 4) {  // 4 column tiles at a time
          uint32_t xh[4][2], xm[4][2], xl[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n)
            xfrag3(xs, sxl, j0 * L.sx + 8 * (n0 + n) + gr, L.sx, xh[n], xm[n], xl[n]);
          // term by term, the smallest first: lo hi, hi lo, mid mid, mid
          // hi, hi mid, hi hi (a bf16 x has no mid or lo)
          if constexpr (kLoTerms) {
#pragma unroll
            for (int n = 0; n < 4; ++n) mma(part[n0 + n], al, xh[n]);
            if constexpr (!XEXACT) {
#pragma unroll
              for (int n = 0; n < 4; ++n) mma(part[n0 + n], ah, xl[n]);
#pragma unroll
              for (int n = 0; n < 4; ++n) mma(part[n0 + n], am, xm[n]);
            }
#pragma unroll
            for (int n = 0; n < 4; ++n) mma(part[n0 + n], am, xh[n]);
            if constexpr (!XEXACT) {
#pragma unroll
              for (int n = 0; n < 4; ++n) mma(part[n0 + n], ah, xm[n]);
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) mma(part[n0 + n], ah, xh[n]);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
      }
      // q = 0 hands its partial r1 sums to q = 1, which adds them; then
      // q = 0 stores r0 (parked in red) and q = 1 stores r1
      if (q == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            red[(p * 32 + n * 4 + e) * 32 + lane] = acc[n][e];
            acc[n][e] = red[((4 + p) * 32 + n * 4 + e) * 32 + lane];
          }
      }
      __syncthreads();  // the partial r1 sums are in
      if (q == 1) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += red[(p * 32 + n * 4 + e) * 32 + lane];
      }
      store_y(y + bh * head_x, P, Tn, 16 * (q == 0 ? r0 : r1) + gr, tq, acc);
    }

    // ---- state = (B * w)^T X (w and X as above): work items of MS 16-row
    // slices of N from m0 by NTW column tiles of P from n0, round robin
    // over the warps (at mamba2's shape 2 x 4: each warp's X reads serve two
    // slices); slices and tiles past N and P compute on clamped rows and are
    // not stored. With one column tile an item, a loop iteration takes two
    // k-steps, so that their products overlap.
    {
      constexpr int MS = NTW == 1 ? 1 : 2;  // 16-row slices of N an item takes
      constexpr int KS = NTW == 1 ? 2 : 1;  // k-steps a loop iteration takes
      for (int it = warp; it < mchunks * nchunks; it += WARPS) {
        const int m0 = (it / nchunks) * MS, n0 = (it % nchunks) * NTW;
        float acc[MS][NTW][4] = {};
        int scol[NTW], brow[MS];
#pragma unroll
        for (int k = 0; k < NTW; ++k) scol[k] = 8 * (n0 + k < nt ? n0 + k : 0) + gr;
#pragma unroll
        for (int u = 0; u < MS; ++u) brow[u] = 16 * (m0 + u < mt ? m0 + u : 0) + gr;
        for (int t0 = 2 * tq; t0 - 2 * tq < Tn; t0 += 8 * KS) {  // keys t0, t0 + 1 of a k-step
#pragma unroll
          for (int kp = 0; kp < KS; ++kp) {
            const int t = t0 + 8 * kp;
            if (t - 2 * tq >= Tn) break;
            const float w0 = wh[t], w1 = wh[t + 1];
            uint32_t ah[MS][4], al[MS][4];
#pragma unroll
            for (int u = 0; u < MS; ++u) {
              const float* br = sb + t * L.sb + brow[u];
              split(br[0] * w0, ah[u][0], al[u][0]);
              split(br[8] * w0, ah[u][1], al[u][1]);
              split(br[L.sb] * w1, ah[u][2], al[u][2]);
              split(br[L.sb + 8] * w1, ah[u][3], al[u][3]);
            }
            uint32_t xh[NTW][2], xl[NTW][2];
#pragma unroll
            for (int k = 0; k < NTW; ++k)
              xfrag(xs, sxl, t * L.sx + scol[k], L.sx, xh[k], xl[k]);
            float part[MS][NTW][4] = {};  // this k-step's products alone (see the header)
            if constexpr (kLoTerms) {
#pragma unroll
              for (int u = 0; u < MS; ++u)
#pragma unroll
                for (int k = 0; k < NTW; ++k) mma(part[u][k], al[u], xh[k]);
              if constexpr (!XEXACT) {
#pragma unroll
                for (int u = 0; u < MS; ++u)
#pragma unroll
                  for (int k = 0; k < NTW; ++k) mma(part[u][k], ah[u], xl[k]);
              }
            }
#pragma unroll
            for (int u = 0; u < MS; ++u)
#pragma unroll
              for (int k = 0; k < NTW; ++k) {
                mma(part[u][k], ah[u], xh[k]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[u][k][e] += part[u][k][e];
              }
          }
        }
#pragma unroll
        for (int u = 0; u < MS; ++u)
#pragma unroll
          for (int k = 0; k < NTW; ++k) {
            const int col = 8 * (n0 + k) + 2 * tq;
            if (m0 + u >= mt || col >= P) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = 16 * (m0 + u) + gr + 8 * half;
              if (row >= N) continue;
              store2(state + (bh * N + row) * size_t(P) + col, acc[u][k][2 * half],
                     acc[u][k][2 * half + 1], col + 1 < P, P % 2 == 0);
            }
          }
      }
    }

    __syncthreads();  // every warp is done with stage s and the residuals
    if (hl + 2 < nh) load_x(hl + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// Cost of one CTA, in TF32 mma work units: C B^T once, then per head Y's
// causal half and the state (the prologue's loads hide behind them).
double cta_cost(int T, int N, int P, int heads) {
  const double t = T, cbt = t * t * N / 2, head = t * t * P / 2 + t * N * P;
  return cbt + heads * head;
}

template <typename T, int NTW>
int plan(int BC, int H, int G, int Tn, int N, int P, int* nblk_out, int* hbmax_out,
         size_t* smem_out) {
  // the last shape's plan (the serving path repeats one shape per layer)
  static int last[6] = {0, 0, 0, 0, 0, 0}, last_nblk = 0;
  const int key[6] = {BC, H, G, Tn, N, P};
  bool same = last_nblk > 0;
  for (int k = 0; k < 6; ++k) same = same && key[k] == last[k];
  const int Hg = H / G;
  if (!same) {
    // once per process: let the kernel take up to a block's shared memory
    static const cudaError_t allowed = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_LIMIT));
    int dev = 0, sms = 0;
    cudaError_t err = allowed;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    double best = 0;
    int best_n = 0;
    for (int nblk = 1; nblk <= Hg; ++nblk) {
      const int hbmax = (Hg + nblk - 1) / nblk;
      const Layout L(Tn, N, P, hbmax, sizeof(T));
      if (L.bytes > SMEM_LIMIT) continue;
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssd_chunk_kernel<T, NTW>,
                                                          THREADS, L.bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm == 0) continue;
      const long ctas = long(BC) * G * nblk, slots = long(per_sm) * sms;
      const double cost = double((ctas + slots - 1) / slots) * cta_cost(Tn, N, P, hbmax);
      if (best_n == 0 || cost < best) best = cost, best_n = nblk;
    }
    if (best_n == 0) return static_cast<int>(cudaErrorInvalidValue);  // beyond shared memory
    for (int k = 0; k < 6; ++k) last[k] = key[k];
    last_nblk = best_n;
  }
  *nblk_out = last_nblk;
  *hbmax_out = (Hg + last_nblk - 1) / last_nblk;
  *smem_out = Layout(Tn, N, P, *hbmax_out, sizeof(T)).bytes;
  return 0;
}

// Column tiles of the state a work item takes: 4 (with 2 slices of N)
// where N has a 16-row slice for each warp, so that the 8 warps take 8
// items of 2 x 4 tiles; else 1 (items of one slice and one tile).
int ntw_for(int N) { return round_up(N, 16) / 16 >= WARPS ? 4 : 1; }

template <typename T, int NTW>
int launch_ntw(const void* x, const void* b, const void* c, const void* dta, const void* dt,
               void* y, void* state, int BC, int H, int G, int Tn, int N, int P,
               cudaStream_t stream) {
  int nblk = 0, hbmax = 0;
  size_t smem = 0;
  const int err = plan<T, NTW>(BC, H, G, Tn, N, P, &nblk, &hbmax, &smem);
  if (err != 0) return err;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec_x = aligned(x) && (P * sizeof(T)) % 16 == 0;
  const int vec_bc = std::is_same_v<T, float> && aligned(b) && aligned(c) && N % 4 == 0;
  ssd_chunk_kernel<T, NTW><<<BC * G * nblk, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(dta), static_cast<const float*>(dt), static_cast<T*>(y),
      static_cast<float*>(state), H, G, Tn, N, P, nblk, hbmax, vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

bool takes(int H, int G, int Tn, int N, int P) {
  return G > 0 && H % G == 0 && Tn > 0 && N > 0 && P > 0 && Tn <= TMAX && P <= PMAX;
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const void* dta, const void* dt,
           void* y, void* state, int BC, int H, int G, int Tn, int N, int P,
           cudaStream_t stream) {
  if (!takes(H, G, Tn, N, P)) return static_cast<int>(cudaErrorInvalidValue);
  return ntw_for(N) == 4
             ? launch_ntw<T, 4>(x, b, c, dta, dt, y, state, BC, H, G, Tn, N, P, stream)
             : launch_ntw<T, 1>(x, b, c, dta, dt, y, state, BC, H, G, Tn, N, P, stream);
}

template <typename T>
int plan_blocks(int BC, int H, int G, int Tn, int N, int P) {
  int nblk = 0, hbmax = 0;
  size_t smem = 0;
  if (!takes(H, G, Tn, N, P)) return -static_cast<int>(cudaErrorInvalidValue);
  const int err = ntw_for(N) == 4 ? plan<T, 4>(BC, H, G, Tn, N, P, &nblk, &hbmax, &smem)
                                  : plan<T, 1>(BC, H, G, Tn, N, P, &nblk, &hbmax, &smem);
  return err != 0 ? -err : nblk;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, b, c and y alike; dta, dt and state are
// float32). The wrapper checks shapes, H % G == 0 and contiguity; a shape
// the kernel does not take (T > 128, P > 64, or tiles beyond one SM's
// shared memory) returns cudaErrorInvalidValue.
extern "C" int ssd_chunk(const void* x, const void* b, const void* c, const void* dta,
                         const void* dt, void* y, void* state, int BC, int H, int G,
                         int T, int N, int P, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, b, c, dta, dt, y, state, BC, H, G, T, N, P, s);
  if (dtype == 1)
    return launch<bf16>(x, b, c, dta, dt, y, state, BC, H, G, T, N, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The head blocks per (chunk, group) a launch at this shape uses: how many
// times it forms each (chunk, group)'s C B^T. Negative: the CUDA error code
// of a shape the kernel refuses.
extern "C" int ssd_chunk_plan(int BC, int H, int G, int T, int N, int P, int dtype) {
  if (dtype == 0) return plan_blocks<float>(BC, H, G, T, N, P);
  if (dtype == 1) return plan_blocks<bf16>(BC, H, G, T, N, P);
  return -static_cast<int>(cudaErrorInvalidValue);
}
