"""Diagnostic builds of K7, K4, K2, K1 and K3 on the card: where their time goes.

    PYTHONPATH=src python -m repro_torch.launch.kernel_variants [--kernel k7|k4|k4r|k2|k1|k3] [--only base,noY] [--clock]

Each variant is the kernel's source (with the headers of ``csrc/``) with
one edit, built with nvcc (the port's flags) into
``build/kernel_variants/<kernel>-<name>/`` beside the checkout's other
builds, and called through ctypes on the same inputs. The variants are
timed in turns, in order and again in reverse. The time a part takes is
the base's less that of the variant without it (the parts overlap, so the
differences need not add up). A variant that leaves a part out computes
wrong outputs by design; the error columns say by how much (nan where a
part is skipped). Prints one line per case, variant and turn. Needs a CUDA
card and nvcc.

K7 (``csrc/ssd_chunk.cu``) at the serving prefills' chunks
(``kernel_times.SSD_SHAPES``) in f32 and bf16:

  base     the kernel as it is
  cvt      TF32 rounding by ``cvt.rna.tf32.f32`` instead of integer ops
  nolo     one TF32 rounding of each operand, no residual products (the
           control that chip_smoke.py's check must fail)
  noexp    the decay mask's exponential left out
  noY      Y's products left out
  nostate  the state's products left out
  nosplit  the per-head split of an f32 X into TF32 parts left out
  noheads  the per-head loop left out: loads, cumsum and C B^T only

K4's tiled form (``csrc/taskbench_blocked.cu``, entry
``taskbench_blocked_tiled``) at the blocked main path's shape (2144 rows,
payload 64, window D = 5, S = 8, grain 64, `plan_tiles`' cut):

  base      the kernel as it is
  nobody    the FMA body left out (loads, combines, barriers, stores)
  nocombine each element takes its own row's value instead of the D taps
  nodepth   the depth loop left out: the loads and the store only
  nosync    no barrier between depths
  onepersm  120 KB of shared memory asked for each CTA, so no two share an SM
  noact     every depth takes depth 0's act flag (no act load per depth)
  t256      256 threads a CTA (512 in the base); t1024: 1024

K4's resident form (``--kernel k4r``, entry ``taskbench_blocked_resident``)
at the main shape without a radius (window D = 5, grain 64 and 0) and on
a blocked fft launch's time-varying (1, 8, W, 2) tables at W = 512 and
2048 (grain 64), each at `plan_resident`'s cut (C CTAs a cluster, slices
of 2^sh columns) and at other cuts:

  base      the kernel as it is
  nocombine each item takes its own row's values instead of the taps
  nosync    no cluster barrier between depths (one before the store)

With ``--clock`` a K4 variant (one that keeps the depth barrier) is built
with clock64() marks (CTA 0's warps
write theirs to a device array) and run at grain 0 and 64: per depth, the
cycles warps 0 and 15 spend from the depth's start to its end of work
("work") and to the next depth's start ("depth"), and for depth 2 the
cycles before its first element, in that element's combine and in its
body ("element"). ``--kernel k4r --clock``: the resident kernel's marks at
the main shape (grain 0 and 64) at clusters of 8 (8-column slices), 4
(4-column slices) and 1: per depth the cycles of warps 0 and 15 in their
work, at the cluster barrier and from it to the next depth, and in the
last pass's combine and body.

K2 (``csrc/memory_bound.cu``) at (2112, 64), scratch 2048, iterations 4:

  base      the kernel as it is
  nopass    the passes left out: the staging, tile-out and fold only
  noshfl    the roll's carry from the lane itself, not its neighbour
  u4        4 words a lane in flight per pass step (8 in the base)
  notile    the tile-out left out
  nofold    the fold left out (nothing written)

K1 (``csrc/taskbench_compute.cu``) at 132, 528, 1056, 1584 and 2112 rows
x payload 64 (128 to 1024 elements an SM between the second and the last:
where `launch_plan.FILL` switches to 4 elements a thread), and K3
(``csrc/taskbench_step.cu``, window D = 3 on the halo-extended source) at
the same widths, payload 64, each at grain 64 and 16384, each with 4
elements (columns) a thread and with 1, whichever the wrappers' plans
take (CTAs cut as they cut them); K3 also in onehot D = 5 with duplicate
slots (nearest's tables, kernel_times' case) at grain 64 on the plans'
launch; with the FMA body's iteration loop (``bodies.cuh``) unrolled as
the compiler chooses or by a given count:

  base      the kernel as it is
  u1        the iteration loop not unrolled
  u4, u8, u16  unrolled 4, 8 or 16 iterations
  onetap    K3 only: the window's first tap alone (what its other taps'
            loads and FMAs cost: the most that staging the source rows in
            shared memory could save)
  mergemem  K3 only: onehot's merge from memory at every D, not from
            registers (``combine.cuh``'s MERGE_REGS path left out)
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import shutil
import subprocess

import torch

from repro_torch.kernels import _build, ref
from repro_torch.launch.attention_times import gpu_ms
from repro_torch.launch.kernel_times import SSD_SHAPES, card, scaled_err, ssd_inputs

OUT = _build.BUILD_ROOT.parent / "kernel_variants"
TF32_INT = """__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}"""
TF32_CVT = """__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}"""
K4_BODY = "  tb::fma_body(v, a.iterations);\n#pragma unroll\n  for (int j = 0; j < NC; ++j) {"
FMA_LOOP = "  for (int i = 0; i < iterations; ++i) {\n#pragma unroll\n    for (int j = 0; j < N; ++j)"


def _unrolled(n: int):
    """The FMA body's iteration loop with ``#pragma unroll n`` (its edit)."""
    return [("bodies.cuh", FMA_LOOP, f"#pragma unroll {n}\n" + FMA_LOOP)]


_UNROLLS = {"base": [], "u1": _unrolled(1), "u4": _unrolled(4), "u8": _unrolled(8),
            "u16": _unrolled(16)}
#: kernel -> (source, C entry, {variant: [(file, text, its replacement)]})
KERNELS = {
    "k7": ("ssd_chunk.cu", "ssd_chunk", {
        "base": [],
        "cvt": [("ssd_chunk.cu", TF32_INT, TF32_CVT)],
        "nolo": [("ssd_chunk.cu", "constexpr bool kLoTerms = true;",
                  "constexpr bool kLoTerms = false;")],
        "noexp": [("ssd_chunk.cu", "__expf(j0", "(j0"), ("ssd_chunk.cu", "-INFINITY", "0.f")],
        "noY": [("ssd_chunk.cu", "    {\n      float acc[8][4] = {};",
                 "    if (false) {\n      float acc[8][4] = {};")],
        "nostate": [("ssd_chunk.cu",
                     "for (int it = warp; it < mchunks * nchunks; it += WARPS) {",
                     "for (int it = warp; it < 0; it += WARPS) {")],
        "nosplit": [("ssd_chunk.cu", "      const int c4 = PP / 4;", "      const int c4 = 0;")],
        "noheads": [("ssd_chunk.cu", "  for (int hl = 0; hl < nh; ++hl) {",
                     "  for (int hl = 0; hl < 0; ++hl) {")],
    }),
    "k4r": ("taskbench_blocked.cu", "taskbench_blocked_resident", {
        "base": [],
        "nocombine": [("taskbench_blocked.cu",
                       "#pragma unroll\n  for (int v = 0; v < V; ++v) acc[v] = 0.f;\n"
                       "  const float* wr = tb_row.w;",
                       "  load_v<V>(acc, cur + ((i - p.r0) << p.sh) + c);\n"
                       "  if (acc[0] != 12345.f) return;\n"
                       "  const float* wr = tb_row.w;")],
        "nosync": [("taskbench_blocked.cu",
                    "    // have read them\n    cluster_barrier(a.cluster);", ""),
                   # one barrier before the store, so that no CTA leaves
                   # while another reads its shared memory
                   ("taskbench_blocked.cu", "  float* out = a.out + row0 * a.P + p.c0;",
                    "  cluster_barrier(a.cluster);\n  float* out = a.out + row0 * a.P + p.c0;")],
    }),
    "k4": ("taskbench_blocked.cu", "taskbench_blocked_tiled", {
        "base": [],
        "nobody": [("taskbench_blocked.cu", K4_BODY, K4_BODY.replace("  tb::fma_body", "  // "))],
        "nocombine": [("taskbench_blocked.cu",
                       "  const float* wr = ws + (i - t.lo) * a.D;\n  if constexpr (MODE == WINDOW) {",
                       "  const float* wr = ws + (i - t.lo) * a.D;\n"
                       "  if (wr) return cur[((i - t.lo) << t.sh) + c];\n"
                       "  if constexpr (MODE == WINDOW) {")],
        "nodepth": [("taskbench_blocked.cu", "  for (int d = 0; d < a.S; ++d) {\n    const float on_d",
                     "  for (int d = 0; d < 0; ++d) {\n    const float on_d")],
        "nosync": [("taskbench_blocked.cu",
                    "    // the next depth reads what this one wrote, and writes what it read\n"
                    "    __syncthreads();", "")],
        "noact": [("taskbench_blocked.cu", "    if (d + 1 < a.S) on = act[d + 1];", "")],
        "onepersm": [("taskbench_blocked.cu",
                      "  blocked_tiled_kernel<MODE, DW><<<grid, TILED_THREADS, smem, stream>>>(a);",
                      "  cudaFuncSetAttribute(blocked_tiled_kernel<MODE, DW>,\n"
                      "                       cudaFuncAttributeMaxDynamicSharedMemorySize, 120 << 10);\n"
                      "  blocked_tiled_kernel<MODE, DW><<<grid, TILED_THREADS, 120 << 10, stream>>>(a);")],
        "t256": [("taskbench_blocked.cu", "constexpr int TILED_THREADS = 512;",
                  "constexpr int TILED_THREADS = 256;")],
        "t1024": [("taskbench_blocked.cu", "constexpr int TILED_THREADS = 512;",
                   "constexpr int TILED_THREADS = 1024;")],
    }),
    "k2": ("memory_bound.cu", "memory_bound", {
        "base": [],
        "nopass": [("bodies.cuh", "for (int it = 0; it < iterations; ++it) {\n    float carry",
                    "for (int it = 0; it < 0; ++it) {\n    float carry")],
        "noshfl": [("bodies.cuh", "__shfl_sync(FULL, x[u][V - 1], (lane + 31) & 31)",
                    "x[u][V - 1]")],
        "u4": [("bodies.cuh", "constexpr int UNROLL = 8;", "constexpr int UNROLL = 4;")],
        "notile": [("bodies.cuh", "    int i = lane;\n    for (; i + 3 * 32 < n; i += 4 * 32) {",
                    "    int i = n;\n    for (; i + 3 * 32 < n; i += 4 * 32) {")],
        "nofold": [("bodies.cuh", "  if (pw <= 32) {\n    const int lpg",
                    "  if (iterations > 0) return;\n  if (pw <= 32) {\n    const int lpg")],
    }),
    "k1": ("taskbench_compute.cu", "taskbench_compute", _UNROLLS),
    "k3": ("taskbench_step.cu", "taskbench_step", {
        **_UNROLLS,
        "onetap": [("taskbench_step.cu", "for (int j = 0; j < D; ++j) tap(w + j, wr[j]);",
                    "for (int j = 0; j < 1; ++j) tap(w + j, wr[j]);")],
        "mergemem": [("combine.cuh", "} else if (D <= MERGE_REGS) {",
                      "} else if (false) {")]}),
}


# K4's clock marks (--clock): slot 0 at the kernel's start, 1 after the
# loads, per depth d 2 + 3d at its start, 3 + 3d after its work, 4 + 3d
# after its barrier; 30-32 around depth 2's first element of a thread.
_MARK = ("if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 31) == 0) "
         "tb_clocks[(threadIdx.x >> 5) * 40 + (%s)] = clock64();")
_FIRST = "if (d == 2 && e0 + j * TILED_THREADS + threadIdx.x < TILED_THREADS) { %s }"
CLOCK_MARKS = [
    ("taskbench_blocked.cu", '#include "combine.cuh"',
     '#include "combine.cuh"\n__device__ long long tb_clocks[16 * 40];'),
    ("taskbench_blocked.cu", "  const int k = blockIdx.y;\n  const int tile = blockIdx.x / a.n_slices;",
     "  " + _MARK % "0" + "\n  const int k = blockIdx.y;\n  const int tile = blockIdx.x / a.n_slices;"),
    ("taskbench_blocked.cu", "  tb::wait_async<0>();\n  __syncthreads();",
     "  tb::wait_async<0>();\n  __syncthreads();\n  " + _MARK % "1"),
    ("taskbench_blocked.cu", "    const float on_d = on;",
     "    " + _MARK % "2 + 3 * d" + "\n    const float on_d = on;"),
    ("taskbench_blocked.cu",
     "    // the next depth reads what this one wrote, and writes what it read\n"
     "    __syncthreads();",
     "    " + _MARK % "3 + 3 * d" + "\n    __syncthreads();\n    " + _MARK % "4 + 3 * d"),
    ("taskbench_blocked.cu", "                 int r0, int e0, int n) {\n  const int mask",
     "                 int r0, int e0, int n, int d) {\n  const int mask"),
    ("taskbench_blocked.cu", "  float v[NC];\n#pragma unroll\n  for (int j = 0; j < NC; ++j) {\n"
     "    const int e = e0 + j * TILED_THREADS + threadIdx.x;\n    const int c = e & mask;",
     "  float v[NC];\n#pragma unroll\n  for (int j = 0; j < NC; ++j) {\n"
     "    const int e = e0 + j * TILED_THREADS + threadIdx.x;\n    const int c = e & mask;\n"
     "    " + _FIRST % (_MARK % "30")),
    ("taskbench_blocked.cu", "               : 0.f;\n  }\n",
     "               : 0.f;\n  }\n  {const int j = 0; "
     + _FIRST % ("if (v[0] == 12345.f) v[0] = 1.f; " + _MARK % "31") + "}\n"),
    ("taskbench_blocked.cu", "#pragma unroll\n  for (int j = 0; j < NC; ++j) {\n"
     "    const int e = e0 + j * TILED_THREADS + threadIdx.x;\n    if (e < n &&",
     "  {const int j = 0; " + _FIRST % ("if (v[0] == 12345.f) v[0] = 1.f; " + _MARK % "32")
     + "}\n#pragma unroll\n  for (int j = 0; j < NC; ++j) {\n"
     "    const int e = e0 + j * TILED_THREADS + threadIdx.x;\n    if (e < n &&"),
    ("taskbench_blocked.cu", "(a, t, cur, nxt, ws, is, r0, e0, n); break;",
     "(a, t, cur, nxt, ws, is, r0, e0, n, d); break;"),
]
# The resident kernel's clock marks (--kernel k4r --clock): 0 at the start,
# 38 before and 1 after the loads' cluster barrier, per depth d 2 + 3d at
# its start, 3 + 3d after its work and 4 + 3d after its barrier, 39 before
# the store; 30-32 around the last pass's combine and body.
RES_CLOCK_MARKS = [
    ("taskbench_blocked.cu", '#include "combine.cuh"',
     '#include "combine.cuh"\n__device__ long long tb_clocks[16 * 40];'),
    ("taskbench_blocked.cu", "  cg::cluster_group cluster = cg::this_cluster();\n  Place p;",
     "  " + _MARK % "0" + "\n  cg::cluster_group cluster = cg::this_cluster();\n  Place p;"),
    ("taskbench_blocked.cu",
     "  // every CTA's depth-0 rows in place before any CTA reads them\n"
     "  cluster_barrier(a.cluster);",
     "  " + _MARK % "38" + "\n  cluster_barrier(a.cluster);\n  " + _MARK % "1"),
    ("taskbench_blocked.cu", "    const int t = a.time_varying ? d : 0;\n    if (a.vec)",
     "    const int t = a.time_varying ? d : 0;\n    " + _MARK % "2 + 3 * d" + "\n    if (a.vec)"),
    ("taskbench_blocked.cu", "    // have read them\n    cluster_barrier(a.cluster);",
     "    // have read them\n    " + _MARK % "3 + 3 * d" + "\n    cluster_barrier(a.cluster);\n    "
     + _MARK % "4 + 3 * d"),
    ("taskbench_blocked.cu", "  float* out = a.out + row0 * a.P + p.c0;",
     "  " + _MARK % "39" + "\n  float* out = a.out + row0 * a.P + p.c0;"),
    ("taskbench_blocked.cu", "  float v[NC * V];\n#pragma unroll\n  for (int j = 0; j < NC; ++j) {",
     "  float v[NC * V];\n  " + _MARK % "30" + "\n#pragma unroll\n  for (int j = 0; j < NC; ++j) {"),
    ("taskbench_blocked.cu", "  tb::fma_body(v, a.iterations);\n#pragma unroll\n  for (int j = 0; j < NC; ++j) {\n"
     "    const int e = e0 + j * RES_THREADS + threadIdx.x;\n    const int c = (e & ((1 << ish) - 1)) << VS;",
     "  if (v[0] == 12345.f) v[0] = 1.f;\n  " + _MARK % "31" + "\n  tb::fma_body(v, a.iterations);\n"
     "  if (v[0] == 12345.f) v[0] = 1.f;\n  " + _MARK % "32" + "\n#pragma unroll\n"
     "  for (int j = 0; j < NC; ++j) {\n"
     "    const int e = e0 + j * RES_THREADS + threadIdx.x;\n    const int c = (e & ((1 << ish) - 1)) << VS;"),
]
CLOCK_READ = """
extern "C" int tb_read_clocks(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, tb_clocks, sizeof(long long) * 16 * 40);
}
"""


def build(kernel: str, names, clock: bool = False) -> dict:
    """Build each variant of ``kernel`` (nvcc processes started together),
    with K4's clock marks if ``clock``; returns {name: ctypes library}.
    Raises if an edit does not apply or nvcc fails."""
    source, entry, variants = KERNELS[kernel]
    files = {f.name: f.read_text() for f in _build.CSRC.iterdir()
             if f.name == source or f.suffix == ".cuh"}
    procs = {}
    for name in names:
        texts = dict(files)
        edits = variants[name] + (
            (RES_CLOCK_MARKS if kernel == "k4r" else CLOCK_MARKS) if clock else [])
        if clock:
            texts[source] += CLOCK_READ
        for fname, old, new in edits:
            if old not in texts[fname]:
                raise RuntimeError(f"variant {name}: {old!r} is not in {fname}")
            texts[fname] = texts[fname].replace(old, new)  # every occurrence
        d = OUT / f"{kernel}-{name}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{kernel}-{name}" / "lib.so"))
        fn = getattr(lib, entry)
        fn.argtypes = list(_build.ENTRIES[entry][1])
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def k7_cases():
    """(label, inputs-making thunk, call(lib, inputs), outputs(inputs),
    errors(outputs, inputs)) per K7 case."""
    for arch, shape in SSD_SHAPES.items():
        BC, H, G, T, N, P = shape
        for dtype in (torch.float32, torch.bfloat16):
            def make(shape=shape, dtype=dtype):
                x, b, c, dta, dt = ssd_inputs(*shape, dtype)
                want = ref.ssd_chunk_plain(x, b, c, dta, dt)
                y = torch.empty_like(x)
                st = torch.empty((BC, H, N, P), device="cuda")
                return (x, b, c, dta, dt, y, st, want)

            def call(lib, a, shape=shape, dtype=dtype):
                x, b, c, dta, dt, y, st, _ = a
                return lib.ssd_chunk(x.data_ptr(), b.data_ptr(), c.data_ptr(),
                                     dta.data_ptr(), dt.data_ptr(), y.data_ptr(),
                                     st.data_ptr(), *shape,
                                     0 if dtype == torch.float32 else 1, _stream())

            def errors(a):
                return {"scaled_err_y": scaled_err(a[5], a[7][0]),
                        "scaled_err_state": scaled_err(a[6], a[7][1])}

            yield ({"arch": arch, "shape_BC_H_G_T_N_P": list(shape),
                    "dtype": str(dtype).split(".")[-1]}, make, call,
                   lambda a: (a[5], a[6]), errors)


def k4_cases():
    from repro_torch.kernels.taskbench_step import (
        plan_tiles, taskbench_step_blocked_plain, window_reach)
    from repro_torch.launch.kernel_times import TB_GRAIN, TB_PAYLOAD, TB_RADIUS, TB_S, TB_W

    M, P, S, D = TB_W + 2 * TB_S * TB_RADIUS, TB_PAYLOAD, TB_S, 2 * TB_RADIUS + 1
    plan = plan_tiles(1, M, P, S, window_reach(D), D, False,
                      torch.cuda.get_device_properties(0).multi_processor_count)
    # the planner's cut, then other cuts: (tile rows, log2 of the slice)
    cuts = [(plan.tile_rows, plan.col_shift)] + [
        c for c in ((67, 3), (34, 3), (268, 2), (134, 4), (90, 3))
        if c != (plan.tile_rows, plan.col_shift)]

    def make():
        gen = torch.Generator(device="cuda").manual_seed(1)
        src = torch.rand((1, M, P), device="cuda", generator=gen) * 0.9 + 0.1
        wgt = torch.rand((1, M, D), device="cuda", generator=gen) / D
        act = torch.ones((1, S), device="cuda")
        want = taskbench_step_blocked_plain(src, None, wgt, act, kind="compute_bound",
                                            iterations=TB_GRAIN, combine="window")
        return src, wgt, act, torch.empty_like(src), want

    # the planner's cut also with the empty body (grain 0)
    for rows, sh, grain in [(*cuts[0], 0)] + [(*c, TB_GRAIN) for c in cuts]:
        def call(lib, a, rows=rows, sh=sh, grain=grain):
            src, wgt, act, out, _ = a
            return lib.taskbench_blocked_tiled(
                src.data_ptr(), None, wgt.data_ptr(), act.data_ptr(), out.data_ptr(),
                1, M, P, D, S, 0, window_reach(D), grain, rows, sh, _stream())

        yield ({"shape_K_M_P_D_S": [1, M, P, D, S], "grain": grain, "tile_rows": rows,
                "col_shift": sh, "ctas": -(-M // rows) * -(-P // (1 << sh)),
                "planned": (rows, sh) == cuts[0]},
               make, call, lambda a: (a[3],),
               lambda a, g=grain: {"max_abs_err": (a[3] - a[4]).abs().max().item()
                                   if g == TB_GRAIN else None})


def k2_cases():
    from repro_torch.kernels.bodies import apply_body
    from repro_torch.launch.kernel_times import K2_SCRATCH, TB_PAYLOAD, TB_W

    it = 4

    def make():
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.rand((TB_W, TB_PAYLOAD), device="cuda", generator=gen) * 0.9 + 0.1
        return x, torch.empty_like(x), apply_body(x, "memory_bound", it, K2_SCRATCH)

    def call(lib, a):
        return lib.memory_bound(a[0].data_ptr(), a[1].data_ptr(), TB_W, TB_PAYLOAD, it,
                                K2_SCRATCH, _stream())

    yield ({"shape": [TB_W, TB_PAYLOAD], "iterations": it, "scratch": K2_SCRATCH},
           make, call, lambda a: (a[1],),
           lambda a: {"max_abs_err": (a[1] - a[2]).abs().max().item()})


#: K1's and K3's widths (rows): the METG sweep's two and three between.
K13_WIDTHS = (132, 528, 1056, 1584, 2112)


def k1_cases():
    from repro_torch.kernels.bodies import apply_body
    from repro_torch.kernels.launch_plan import LaunchPlan, cut_ctas
    from repro_torch.kernels.taskbench_compute import compute_plan
    from repro_torch.launch.kernel_times import SMS, TB_PAYLOAD

    for rows, grain, chains in itertools.product(K13_WIDTHS, (64, 16384), (4, 1)):
        n = rows * TB_PAYLOAD
        plan = LaunchPlan(chains, *cut_ctas(-(-n // chains), SMS))

        def make(rows=rows, grain=grain):
            gen = torch.Generator(device="cuda").manual_seed(1)
            x = torch.rand((rows, TB_PAYLOAD), device="cuda", generator=gen) * 0.9 + 0.1
            return x, torch.empty_like(x), apply_body(x, "compute_bound", grain, 0)

        def call(lib, a, n=n, grain=grain, plan=plan):
            return lib.taskbench_compute(a[0].data_ptr(), a[1].data_ptr(), n, grain,
                                         plan.chains, plan.threads, 1, _stream())

        yield ({"shape": [rows, TB_PAYLOAD], "grain": grain, "chains": chains,
                "ctas": plan.ctas, "planned": plan == compute_plan(n, SMS)},
               make, call, lambda a: (a[1],),
               lambda a: {"max_abs_err": (a[1] - a[2]).abs().max().item()})


def k3_cases():
    from repro_torch.kernels.launch_plan import LaunchPlan, cut_ctas
    from repro_torch.kernels.taskbench_step import step_plan, taskbench_step_plain, wrap_rows
    from repro_torch.launch.kernel_times import SMS, TB_PAYLOAD, k3_operands

    P = TB_PAYLOAD
    planned = {W: step_plan(1, W, P, SMS) for W in K13_WIDTHS}
    cases = [(W, "window", 3, grain, LaunchPlan(c, *cut_ctas(W * -(-P // c), SMS)))
             for W, grain, c in itertools.product(K13_WIDTHS, (64, 16384), (4, 1))]
    cases += [(W, "onehot", 5, 64, planned[W]) for W in (132, 2112)]
    for W, combine, D, grain, plan in cases:
        def make(W=W, combine=combine, D=D, grain=grain):
            state, idx, wgt, H = k3_operands(W, combine, D)
            ext = wrap_rows(state, H)
            want = taskbench_step_plain(ext, idx, wgt, kind="compute_bound",
                                        iterations=grain, combine=combine)
            return ext, idx, wgt, torch.empty_like(state), want

        def call(lib, a, W=W, combine=combine, D=D, grain=grain, plan=plan):
            ext, idx, wgt, out, _ = a
            return lib.taskbench_step(ext.data_ptr(), idx.data_ptr(), wgt.data_ptr(),
                                      out.data_ptr(), 1, ext.shape[1], W, P, D,
                                      0 if combine == "window" else 2, 0, grain, 2048,
                                      -1, plan.chains, plan.threads, _stream())

        yield ({"W": W, "P": P, "combine": combine, "D": D, "grain": grain,
                "chains": plan.chains, "ctas": plan.ctas, "planned": plan == planned[W]},
               make, call, lambda a: (a[3],),
               lambda a: {"max_abs_err": (a[3] - a[4]).abs().max().item()})


def _resident_ops(W: int, seed: int = 1):
    """(src, idx, wgt) of a blocked fft launch at width W: its first
    launch's time-varying (1, 8, W, 2) tables, as the runtime builds them."""
    from repro_torch.core import KernelSpec, TaskGraph, get_runtime
    from repro_torch.core.runtimes import pallas_step as ps
    from repro_torch.launch.kernel_times import TB_GRAIN, TB_PAYLOAD, TB_S

    g = TaskGraph(steps=1000, width=W, pattern="fft", payload=TB_PAYLOAD,
                  kernel=KernelSpec("compute_bound", TB_GRAIN), seed=0)
    tables_at, key_of, _ = get_runtime("pallas_step")._global_table_fn(g)
    idx, wgt, _ = ps._stack_tables(tables_at, key_of, [list(range(1, TB_S + 1))], "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((1, W, TB_PAYLOAD), device="cuda", generator=gen) * 0.9 + 0.1, idx, wgt


def k4r_cases():
    from repro_torch.kernels import taskbench_step as k34
    from repro_torch.launch.kernel_times import TB_GRAIN, TB_PAYLOAD, TB_RADIUS, TB_S, TB_W

    P, S = TB_PAYLOAD, TB_S
    shapes = [("main", TB_W + 2 * TB_S * TB_RADIUS, 5, False), ("fft", 512, 2, True),
              ("fft", 2048, 2, True)]
    clusters = k34.resident_clusters(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, M, D, tv in shapes:
        plan = k34.plan_resident(1, M, P, S, D, tv, tv, sms, clusters)
        cuts = [(plan.cluster, plan.col_shift)] + [
            c for c in ((16, 3), (8, 3), (8, 2), (4, 2), (4, 3), (2, 3), (1, 3))
            if c != (plan.cluster, plan.col_shift)]

        def make(M=M, D=D, tv=tv):
            act = torch.ones((1, S), device="cuda")
            if tv:
                src, idx, wgt = _resident_ops(M)
                combine = "gather"
            else:
                gen = torch.Generator(device="cuda").manual_seed(1)
                src = torch.rand((1, M, P), device="cuda", generator=gen) * 0.9 + 0.1
                idx, wgt = None, torch.rand((1, M, D), device="cuda", generator=gen) / D
                combine = "window"
            want = k34.taskbench_step_blocked_plain(src, idx, wgt, act, kind="compute_bound",
                                                    iterations=TB_GRAIN, combine=combine)
            return src, idx, wgt, act, torch.empty_like(src), want

        grains = (TB_GRAIN, 0) if label == "main" else (TB_GRAIN,)
        for (C, sh), grain in itertools.product(cuts, grains):
            rows = -(-M // C)
            tables = k34.resident_smem_bytes(rows, sh, D, S if tv else 1, tv, True) \
                <= k34.SMEM_LIMIT
            if k34.resident_smem_bytes(rows, sh, D, S if tv else 1, tv, False) > k34.SMEM_LIMIT:
                continue

            def call(lib, a, M=M, D=D, tv=tv, C=C, sh=sh, grain=grain, rows=rows,
                     tables=tables):
                src, idx, wgt, act, out, _ = a
                return lib.taskbench_blocked_resident(
                    src.data_ptr(), None if idx is None else idx.data_ptr(), wgt.data_ptr(),
                    act.data_ptr(), out.data_ptr(), 1, M, P, D, S, int(tv), int(tv), grain,
                    rows, sh, C, int(tables), int(sh >= 2), _stream())

            yield ({"shape": label, "shape_K_M_P_D_S": [1, M, P, D, S], "grain": grain,
                    "cluster": C, "col_shift": sh, "ctas": C * -(-P // (1 << sh)),
                    "planned": (C, sh) == cuts[0]},
                   make, call, lambda a: (a[4],),
                   lambda a, g=grain: {"max_abs_err": (a[4] - a[5]).abs().max().item()
                                       if g == TB_GRAIN else None})


def k4r_clocks(name: str, lib) -> None:
    """K4's resident variant ``name`` built with clock marks: prints, at
    grain 0 and 64 and clusters of 8, 4 and 1, the marks' cycles for warps
    0 and 15 of CTA 0 (see --clock)."""
    from repro_torch.launch.kernel_times import TB_PAYLOAD, TB_RADIUS, TB_S, TB_W

    M, P, S, D = TB_W + 2 * TB_S * TB_RADIUS, TB_PAYLOAD, TB_S, 2 * TB_RADIUS + 1
    gen = torch.Generator(device="cuda").manual_seed(1)
    src = torch.rand((1, M, P), device="cuda", generator=gen)
    wgt = torch.rand((1, M, D), device="cuda", generator=gen) / D
    act, out = torch.ones((1, S), device="cuda"), torch.empty_like(src)
    lib.tb_read_clocks.argtypes = [ctypes.c_void_p]
    marks = (ctypes.c_longlong * (16 * 40))()
    for (C, sh), grain in itertools.product(((8, 3), (4, 2), (1, 3)), (0, 64)):
        for _ in range(5):  # the last run's marks are read
            err = lib.taskbench_blocked_resident(
                src.data_ptr(), None, wgt.data_ptr(), act.data_ptr(), out.data_ptr(),
                1, M, P, D, S, 0, 0, grain, -(-M // C), sh, C, 1, 1, _stream())
            if err:
                raise RuntimeError(f"variant {name}: launch failed ({err})")
        torch.cuda.synchronize()
        if lib.tb_read_clocks(ctypes.addressof(marks)):
            raise RuntimeError("reading the clock marks failed")
        for w in (0, 15):
            t = marks[w * 40:(w + 1) * 40]
            print(json.dumps({
                "variant": name, "cluster": C, "col_shift": sh, "grain": grain, "warp": w,
                "load": t[38] - t[0], "load_barrier": t[1] - t[38],
                "work": [t[3 + 3 * d] - t[2 + 3 * d] for d in range(S)],
                "barrier": [t[4 + 3 * d] - t[3 + 3 * d] for d in range(S)],
                "to_next_depth": [t[2 + 3 * (d + 1)] - t[4 + 3 * d] for d in range(S - 1)],
                "last_pass": {"combine": t[31] - t[30], "body": t[32] - t[31]}}), flush=True)


CASES = {"k7": k7_cases, "k4": k4_cases, "k4r": k4r_cases, "k2": k2_cases, "k1": k1_cases,
         "k3": k3_cases}


def k4_clocks(name: str, lib) -> None:
    """K4's variant ``name`` built with clock marks: prints, at grain 0 and
    64, the marks' cycles for warps 0 and 15 of CTA 0 (see --clock)."""
    from repro_torch.kernels.taskbench_step import plan_tiles
    from repro_torch.launch.kernel_times import TB_PAYLOAD, TB_RADIUS, TB_S, TB_W

    M, P, S, D = TB_W + 2 * TB_S * TB_RADIUS, TB_PAYLOAD, TB_S, 2 * TB_RADIUS + 1
    plan = plan_tiles(1, M, P, S, TB_RADIUS, D, False,
                      torch.cuda.get_device_properties(0).multi_processor_count)
    gen = torch.Generator(device="cuda").manual_seed(1)
    src = torch.rand((1, M, P), device="cuda", generator=gen)
    wgt = torch.rand((1, M, D), device="cuda", generator=gen) / D
    act, out = torch.ones((1, S), device="cuda"), torch.empty_like(src)
    lib.tb_read_clocks.argtypes = [ctypes.c_void_p]
    marks = (ctypes.c_longlong * (16 * 40))()
    for grain in (0, 64):
        for _ in range(5):  # the last run's marks are read
            lib.taskbench_blocked_tiled(
                src.data_ptr(), None, wgt.data_ptr(), act.data_ptr(), out.data_ptr(),
                1, M, P, D, S, 0, TB_RADIUS, grain, plan.tile_rows, plan.col_shift,
                _stream())
        torch.cuda.synchronize()
        if lib.tb_read_clocks(ctypes.addressof(marks)):
            raise RuntimeError("reading the clock marks failed")
        for w in (0, 15):
            t = marks[w * 40:(w + 1) * 40]
            print(json.dumps({
                "variant": name, "grain": grain, "warp": w, "load": t[1] - t[0],
                "work": [t[3 + 3 * d] - t[2 + 3 * d] for d in range(S)],
                "depth": [t[5 + 3 * d] - t[2 + 3 * d] for d in range(S - 1)],
                "element": [t[30] - t[8], t[31] - t[30], t[32] - t[31]]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="k7")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants (default: all of the kernel's)")
    ap.add_argument("--clock", action="store_true",
                    help="K4 only: clock marks per depth instead of times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device is available")
    if args.clock and args.kernel not in ("k4", "k4r"):
        raise SystemExit("kernel_variants: --clock marks K4's tiled and resident kernels only")
    names = (args.only or ",".join(KERNELS[args.kernel][2])).split(",")
    libs = build(args.kernel, names, clock=args.clock)
    if args.clock:
        for name in names:
            (k4r_clocks if args.kernel == "k4r" else k4_clocks)(name, libs[name])
        return 0
    smi = card()
    for case, make, call, outputs, errors in CASES[args.kernel]():
        a = make()
        for turn, name in enumerate(names + names[::-1]):
            lib = libs[name]

            def run():
                err = call(lib, a)
                if err:
                    raise RuntimeError(f"variant {name}: launch failed ({err})")

            for o in outputs(a):
                o.fill_(float("nan"))  # a part a variant skips reads as nan
            run()
            torch.cuda.synchronize()
            rec = {**case, "variant": name, "turn": turn, "ms": gpu_ms(run, 30),
                   **errors(a), "card": smi}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
