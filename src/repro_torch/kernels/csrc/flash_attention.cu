// K5, bf16 form: forward attention with a blockwise online softmax
// (FlashAttention) on the tensor cores, causal, sliding-window and
// key-length masks, grouped-query heads. The f32 form is
// flash_attention_f32.cu (f32 FMAs); the wrapper dispatches by dtype and
// counts the two forms apart (`flash_attention`, `flash_attention_f32`).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (Pallas body `_flash_kernel`), for bf16 inputs.
//
// Semantics (as the TPU kernel's): q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D)
// in bf16, query head h reads key head h / (Hq / Hkv). Row i sees key j
// when j < Sk, and j <= i if causal (row and key indices both start at 0,
// so Sq != Sk carries no offset), and i - j < window if window > 0. Scores
// are (q . k) * sm_scale in f32; a masked score gets probability 0 (the
// TPU kernel's -1e30); a row that sees no key gives 0. The output is bf16.
//
// Bound on an H100: at internlm2-1.8b's serving prefill (B 8, Hq 16, Sq =
// Sk = 1024, D 128, causal) the work is 4 * B * Hq * Sq^2 * D / 2 = 34.4
// GFLOP, 34.7 us at the 989 TFLOP/s bf16 tensor-core peak, against ~100 MB
// of q, k, v and o, 30 us at 3.35 TB/s: bound by operations, so both
// products must run on the tensor cores, and at their full rate only
// wgmma reaches.
//
// Design: one CTA = one warpgroup (4 warps) per (q head, batch, q tile of
// 64 rows). Both products are wgmma.mma_async with bf16 operands and f32
// accumulators in registers: s (64 x 64 keys) = q k^T with q and k read
// from shared memory (K-major), and o (64 x D) += p v with p from
// registers (the accumulator layout of s is the A-operand register layout,
// as in FlashAttention-3) and v from shared memory (MN-major). q is staged
// once; k and v tiles of 64 keys sit in a 2-stage ring, filled by 16-byte
// cp.async so that the next tile's load overlaps this tile's products and
// softmax. Every operand is stored in the 128-byte-swizzled layout the
// wgmma descriptors name (rows of 64 bf16, 16-byte chunks XOR-ed by row % 8,
// 1024-byte atoms; D zero-padded to whole 64-column blocks: zero columns
// add nothing to q k^T, and p v's padded columns are never stored). The
// online softmax (row max and sum in the log2 domain, the rescale of o)
// stays in registers; a row's max is a shuffle across the 4 lanes that
// hold it. P's precision: the TPU kernel keeps p in f32, and one bf16
// rounding of p (2^-9 relative per weight) would put ~1e-4 of absolute
// error on outputs near 0, beyond the check's one bf16 ulp; so P = P_hi +
// P_lo, both bf16 with P_lo = bf16(p - P_hi), and both go through the same
// accumulator (the second p v product is overhead, not counted in the
// bound). Tiles that no row of the q tile sees are never loaded (the TPU
// kernel's causal and window block skip), and the element mask is applied
// only on tiles that straddle a boundary. The grid's slowest axis walks the
// q tiles from the last (the heaviest under the causal mask) to the first,
// so the last wave is not all diagonal-heavy. Shared memory is
// (64 + 4 x 64) rows x 128 bytes per 64-column block: 80 KB at D = 128,
// two CTAs per SM. Tried on the card and slower at these shapes: two
// warpgroups a CTA, 32- or 128-key tiles, a 3- or 4-stage ring, and
// issuing the next tile's q k^T before this tile's softmax. Not yet used:
// TMA and mbarriers (a warp-specialised producer).
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "error.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // one warpgroup: 64 query rows, 16 per warp
constexpr int THREADS = 128;
constexpr int BK = 64;  // keys per tile
constexpr int NSTAGE = 2;
constexpr int SUB = 64 * 128;  // bytes of one [64 rows][64 columns] bf16 block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// descriptor of a 128-byte-swizzled operand in shared memory: 8-row groups
// 1024 bytes apart (SBO), `lbo` bytes between 64-column blocks (MN-major)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled sub-tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  union {
    __nv_bfloat162 v;
    uint32_t u;
  } h, l;
  h.v = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(h.v);
  l.v = __floats2bfloat162_rn(x - back.x, y - back.y);
  hi = h.u;
  lo = l.u;
}

// wgmma.mma_async wrappers: s (64 x 64) += q k^T, both from shared memory
// (K-major); o (64 x N) += p v, p from registers, v from shared memory
// (MN-major, imm-trans-b = 1)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n256(o, a, db);
}

template <int D>
constexpr int padded() {
  return (D + 63) / 64 * 64;
}
template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(padded<D>() / 64) * SUB * (1 + 2 * NSTAGE) + 1024;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int Hq, int Hkv,
                       int Sq, int Sk, int causal, int window, float scale_log2) {
  constexpr int DP = (D + 63) / 64 * 64;  // zero-padded to whole 64-column blocks
  constexpr int KB = DP / 64;
  constexpr int CH = DP / 8;       // 16-byte chunks of a padded row
  constexpr int NT = BK / 8;
  constexpr int DT = DP / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t sq = base;                         // [KB][BQ rows][64]
  const uint32_t sk = sq + KB * SUB;               // [NSTAGE][KB][BK][64]
  const uint32_t sv = sk + NSTAGE * KB * SUB;      // [NSTAGE][KB][BK][64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (Hq / Hkv);
  const bf16* qb = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  bf16* ob = o + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad_col = (lane & 3) * 2;

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    const bool in = q0 + r < Sq && cc * 8 < D;
    cp_async16(sq + (cc / 8) * SUB + sw128(r, cc % 8),
               qb + (in ? static_cast<size_t>(q0 + r) * D + cc * 8 : 0), in);
  }
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_begin / BK;
  const int n_tiles = k_end > t0 * BK ? (k_end - t0 * BK + BK - 1) / BK : 0;

  auto load_tile = [&](int t) {
    const int k0 = (t0 + t) * BK;
    const uint32_t dk = sk + (t % NSTAGE) * KB * SUB;
    const uint32_t dv = sv + (t % NSTAGE) * KB * SUB;
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH;
      const bool in = k0 + r < Sk && cc * 8 < D;
      const size_t off = in ? static_cast<size_t>(k0 + r) * D + cc * 8 : 0;
      const uint32_t at = (cc / 8) * SUB + sw128(r, cc % 8);
      cp_async16(dk + at, kb + off, in);
      cp_async16(dv + at, vb + off, in);
    }
  };
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row, row + 8

  for (int t = 0; t < n_tiles; ++t) {
    if (t + NSTAGE - 1 < n_tiles) load_tile(t + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    fence_proxy_async();  // the copies are visible to the tensor cores' reads
    __syncthreads();
    const uint32_t tk = sk + (t % NSTAGE) * KB * SUB;
    const uint32_t tv = sv + (t % NSTAGE) * KB * SUB;
    const int k0 = (t0 + t) * BK;

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t koff = (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(sq + (kk / 4) * SUB + koff, 16),
                   sw128_desc(tk + (kk / 4) * SUB + koff, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    const bool full = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= q0) &&
                      (window <= 0 || q0 + BQ - 1 - k0 < window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (!full) {
          const int i = row + (e >> 1) * 8;
          const int kj = k0 + j * 8 + quad_col + (e & 1);
          const bool ok = kj < Sk && (!causal || kj <= i) && (window <= 0 || i - kj < window);
          x = ok ? x : -INFINITY;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - m[e >> 1]);
        s[4 * j + e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];

    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      split_bf16x2(s[8 * kk + 0], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
      split_bf16x2(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
      split_bf16x2(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
      split_bf16x2(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = sw128_desc(tv + kk * 16 * 128, BK * 128);
      wgmma_pv<DP>(acc, ph[kk], dv);
      wgmma_pv<DP>(acc, pl[kk], dv);  // P_lo
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = row + r * 8;
    if (i >= Sq) continue;
    const float lsafe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      if (j * 8 >= D) break;
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(i) * D + j * 8 + quad_col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / lsafe, acc[4 * j + 2 * r + 1] / lsafe);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
           int Sq, int Sk, int causal, int window, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Hq, Hkv, Sq, Sk, causal, window, sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int Hq, int Hkv, int Sq, int Sk, int D, int causal, int window,
                               float sm_scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 32: return launch<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 64: return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 80: return launch<80>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 128: return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    case 256: return launch<256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
