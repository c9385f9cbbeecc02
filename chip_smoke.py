#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

  1. build   nvcc builds the kernels (K1 FMA body, K2 memory sweep, K3
             single-step megakernel, K4 temporal-blocked megakernel, K5
             flash attention in two forms, bf16 on the tensor cores and
             f32, K6 decode attention, K7 SSD intra-chunk, K8 RMSNorm)
             from ``src/``, one nvcc process per source, all started
             together.
  2. parity  each kernel against its plain PyTorch version on the card:
             K1-K3 at the main path's width W = 2112 and at W = 65536, K3
             also on out-of-range indices; K4 at the blocked main path's
             buffer (M = 2144 rows) for every combine, fixed and
             time-varying tables, every body, S in {2, 8}, an act mask with
             a masked tail and a frozen member; the pipelined phases
             stitched together equal to one full K4 launch, bit for bit;
             K5 (both forms) at the serving prefill (8 x 16 heads x 1024 x
             128, causal) and a windowed ragged case, K6 (one cluster
             launch) at the serving decode (q 8 x 16
             x 128 over an 8 x 8 x 1088 x 128 cache, lengths 0 .. 1088,
             window 0 and 256), K5 and K6 at hymba-1.5b's (group 5, head
             dim 64, window 1024); K7 at mamba2-130m's and hymba-1.5b's
             prefill chunks, at T = 5 and at G = 2, with some dtA <= -30;
             K8 at mamba2's norm shapes and (37, 1000); each in bf16 and f32.
  3. main    the Task Bench main path: the 7 halo patterns through ``pallas_step``
             and ``fused(use_kernels=True)`` at W = 2112, T = 1000,
             payload 64, compute_bound grain 64, checked against each
             other and against ``fused(use_kernels=False)``; then
             ``pallas_step(steps_per_launch=8)`` serial and pipelined on
             every pattern (window; gather and onehot on two), held to the
             S = 1 run and pipelined equal to serial bit for bit; one
             memory_bound run of each; small-input checks against the CPU
             plain path. The launch counters are zeroed just before and
             read just after, and each run's launches must equal the
             runtime's ``dispatches_per_run``.
  4. metg    grains 1..16384, stencil_1d, T = 1000, 5 reps, W in {132,
             2112} (one task per SM times overdecomposition 1 and 16), on
             both backends and on ``pallas_step(steps_per_launch=8)``
             pipelined and serial.
  5. serve   the LM serving paths through ``repro_torch.launch.serve.serve``,
             each at full width and depth, f32 storage, bf16 compute,
             random weights from seed 0, greedy: [serve] internlm2-1.8b,
             batch 8, prompt 1024, 64 tokens (launches: 24 K5 in its
             tensor-core form, 24 x 63 K6); [serve-ssm] mamba2-130m, batch
             8, prompt 1024, 64 tokens (24 K7 in the prefill, nothing in
             decode); [serve-hybrid] hymba-1.5b, batch 4, prompt 1024, 16
             tokens (32 K5 in its tensor-core form + 32 K7, 32 x 15 K6).
             For each, the
             launch counters, zeroed just before, must read exactly that;
             every step's logits finite; the prefill and 4 decode steps,
             teacher-forced with the served tokens, held against the same
             model on its plain path on the card; 3 more decode steps
             under ``torch.profiler`` (device kernels, and host operators
             by self CPU time); the prefill again, warm. Then [norm]:
             ``ops.rmsnorm``, K8's one entry point (the models call its
             plain version, as the reference's do), at mamba2's norm
             shapes, 2 launches.
  6. times   each kernel and its plain version timed with CUDA events at
             the main path's shapes, beside its bound on this card (K2 also
             beside its shared-memory bound); K4 as one full launch and as
             the pipelined phases; K5 at internlm2's and hymba's prefill
             shapes, and K6 at the serving decode warm and L2-cold, beside
             ``scaled_dot_product_attention`` on the same inputs under
             PyTorch's choice of backend and each backend pinned
             (``repro_torch.launch.attention_times``), K8 beside
             ``rms_norm`` (yardsticks only: the port never calls them); K7
             at the mamba2 prefill's chunks.

The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": ...}``. With no card, or without
the rest of the repository beside it, the script exits non-zero and prints
no result. It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

HALO_PATTERNS = ("trivial", "no_comm", "stencil_1d", "stencil_1d_periodic",
                 "dom", "nearest", "random_nearest")
W_MAIN, T_MAIN, PAYLOAD, GRAIN = 2112, 1000, 64, 64
W_WIDE = 65536  # a 16 MiB state
SMS = 132
GRAINS = (1, 4, 16, 64, 256, 1024, 4096, 16384)  # configs/taskbench.py PAPER
# Tolerances, max abs error. K1: the kernel's fmaf and the plain
# multiply-then-add round alike (0.5*x is exact), so only the last bit may
# move. K2, K3 and the backends: sums taken in another order (the sweep's
# mean, the combine's weighted sum with fused multiply-adds), on values in
# [0, 1].
TOL_K1 = 1e-6
TOL = 1e-5
# The T-step memory_bound run accumulates those roundings: the sweep adds
# 1e-6 per pass and the combine averages, so nothing contracts a difference
# away as the FMA body does; allow ~2 ulp of 0.5 per step.
TOL_MEMORY_RUN = T_MAIN * 1.2e-7
S_MAIN = 8  # the blocked main path's steps per launch
TASKBENCH_KERNELS = ("taskbench_compute", "memory_bound", "taskbench_step",
                     "taskbench_blocked")
# Published H100 SXM bf16 dense tensor-core peak (NVIDIA data sheet, 700 W).
BF16_FLOPS_PER_S = 989e12
# The serving cell: internlm2-1.8b at full width, batch 8, prompt 1024,
# 64 generated tokens (63 decode steps), greedy.
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN = "internlm2-1.8b", 8, 1024, 64
# Attention tolerances (K5, K6 against their plain versions on the same
# inputs). f32: sums in another order (online softmax by tiles against one
# dense softmax; K6's query pre-scaled before the product), on outputs of
# magnitude ~1. bf16: both versions compute in f32 (the same sums in
# another order, TOL_ATTN_F32 apart) and round once to bf16, so each output
# is held to TOL_ATTN_F32 plus one bf16 ulp of its own plain value.
TOL_ATTN_F32 = 2e-5
# m and l of K6 are f32 in both versions: 1e-5 of max(|value|, 1) (l sums
# up to 1088 terms in another order; an empty row's m is -1e30 in both).
TOL_STATS_REL = 1e-5
# [serve]: the kernel path against the plain path, max |difference| over
# max |logit|, prefill and 4 teacher-forced decode steps; bf16 activations
# through 24 layers, where the two attention versions may round an
# output one bf16 ulp apart and the residual stream carries that on. On the
# H100 the sound paths read 1.42-1.63% apart, and a control whose K6
# misses each step's own token read 3.45-10.2% at every decode step.
TOL_SERVE_REL = 0.025
# The SSM serving cells, at full width and depth: mamba2-130m (24 layers,
# d_model 768, 24 SSD heads of 64, state 128), batch 8, prompt 1024, 64
# tokens; hymba-1.5b (32 layers, d_model 1600, 25 query over 5 KV heads,
# window 1024, 50 SSD heads of 64, state 16), batch 4, prompt 1024, 16
# tokens, so that decode positions pass the window.
SSM_ARCH, SSM_B, SSM_PROMPT, SSM_GEN = "mamba2-130m", 8, 1024, 64
HYB_ARCH, HYB_B, HYB_PROMPT, HYB_GEN = "hymba-1.5b", 4, 1024, 16
# [serve-ssm] and [serve-hybrid]: the kernel path against the plain path
# over the prefill and 4 teacher-forced decode steps, as [serve]: max
# |difference| / max |logit| ("max") and ||difference|| / ||logits||
# ("rms"). The SSD runs in f32 there (the conv's f32 bias promotes its
# output), so K7 and its plain version differ by f32 sums in another order;
# bf16 roundings downstream carry that on through the layers, and in hymba
# K5's and K6's bf16 outputs add theirs. On the H100 the sound paths read
# (the same in every run) mamba2 max 1.35-1.60%, rms 0.90-0.93%, hymba max
# 2.42-3.12%, rms 2.74-2.88%; a control whose K7 drops its decay mask L read
# mamba2 max 11.6-15.9%, rms 10.1-16.7%, hymba max 2.72-5.96%, rms
# 3.22-5.64% at every step. Each limit lies between the two.
TOL_SERVE_SSM = {"max": 0.025, "rms": 0.015}
TOL_SERVE_HYB = {"max": 0.035, "rms": 0.031}
# K7 and K8 against their plain versions: both compute in f32 (FMAs from
# shared memory against einsums and reductions: the same sums in another
# order), so an output is held to TOL_F32_SCALED of the output's scale,
# max(1, max |plain|); a bf16 output is rounded once from those sums, so it
# also gets one bf16 ulp of its own plain value.
TOL_F32_SCALED = 2e-5
BLOCKED_RUNS = (("pipelined", {}), ("serial", {"pipeline": False}))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_close(name: str, got, want, tol: float) -> float:
    if tuple(got.shape) != tuple(want.shape):
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    import torch

    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if not err <= tol:
        fail(f"{name}: max abs error {err} > {tol}")
    return err


def bf16_ulp(x):
    """One bf16 ulp of each |x|, 0 where x is 0: 2^(floor(log2 |x|) - 7)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.double().abs())) - 7)


def check_attn(name: str, got, want) -> float:
    """K5/K6 output against its plain version, element by element:
    TOL_ATTN_F32 in f32, TOL_ATTN_F32 + one bf16 ulp of the plain value in
    bf16. Returns the max abs error."""
    import torch

    if got.dtype != want.dtype:
        fail(f"{name}: dtype {got.dtype} != {want.dtype}")
    if want.dtype == torch.float32:
        return check_close(name, got, want, TOL_ATTN_F32)
    err = check_close(name, got.float(), want.float(), float("inf"))
    excess = (got.double() - want.double()).abs() - (TOL_ATTN_F32 + bf16_ulp(want))
    if excess.numel() and excess.max().item() > 0:
        i = int(excess.argmax())
        fail(f"{name}: |got - want| at flat index {i} ({got.flatten()[i].item()} vs "
             f"{want.flatten()[i].item()}) exceeds {TOL_ATTN_F32} + one bf16 ulp")
    return err


def check_scaled(name: str, got, want) -> float:
    """K7/K8 output against its plain version, element by element:
    TOL_F32_SCALED * max(1, max |want|), plus one bf16 ulp of each plain
    value in bf16. Returns the max abs error."""
    import torch

    if got.dtype != want.dtype:
        fail(f"{name}: dtype {got.dtype} != {want.dtype}")
    err = check_close(name, got.float(), want.float(), float("inf"))
    tol = TOL_F32_SCALED * max(1.0, want.double().abs().max().item())
    excess = (got.double() - want.double()).abs() - tol
    if want.dtype == torch.bfloat16:
        excess -= bf16_ulp(want)
    if excess.numel() and excess.max().item() > 0:
        i = int(excess.argmax())
        fail(f"{name}: |got - want| at flat index {i} ({got.flatten()[i].item()} vs "
             f"{want.flatten()[i].item()}) exceeds {tol}"
             f"{' + one bf16 ulp' if want.dtype == torch.bfloat16 else ''}")
    return err


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print("chip_smoke: repro_torch was not imported from this checkout",
              file=sys.stderr)
        return 2

    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.core import KernelSpec, TaskGraph, compute_metg, get_runtime
    from repro_torch.core.patterns import halo_radius
    from repro_torch.core.runtimes import pallas_step as ps_mod
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import ENTRY as K5_FORM  # form per dtype
    from repro_torch.launch.serve import _grow_caches, make_prompts, serve
    from repro_torch.models.model import Model
    from repro_torch.kernels.bodies import apply_body
    from repro_torch.kernels.taskbench_step import (
        taskbench_step_blocked_plain,
        taskbench_step_plain,
    )
    from repro_torch.launch import attention_times
    from repro_torch.launch.attention_times import gpu_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}; card: {smi}", flush=True)

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    logs = _build.build_all()
    libs = sorted({lib for lib, _ in _build.ENTRIES.values()})
    missing = [lib for lib in libs if not _build.library_path(lib).exists()]
    if missing:
        fail(f"[build] libraries missing after the build: {missing}")
    print(f"[build] {len(libs)} libraries ({len(logs)} built now) in "
          f"{time.perf_counter() - t0:.3f} s "
          f"-> {_build.library_path('taskbench_step').parent}", flush=True)
    for lib, log in sorted(logs.items()):
        for line in log.splitlines():
            if "warning" in line or "Used" in line or "Compiling entry" in line:
                print(f"  {lib}: {line.strip()}")

    # --------------------------------------------------------------- parity
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {entry: 0.0 for entry in _build.ENTRIES}

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=gen) * 0.9 + 0.1

    for rows, p in ((37, 13), (W_MAIN, PAYLOAD), (W_WIDE, PAYLOAD)):
        x = rand(rows, p)
        for it in (0, 1, 16, 1024):
            e1 = check_close(f"K1 rows={rows} P={p} it={it}",
                             ops.taskbench_compute(x, it),
                             apply_body(x, "compute_bound", it, 0), TOL_K1)
            e2 = check_close(f"K2 rows={rows} P={p} it={it}",
                             ops.taskbench_memory(x, it, 2048),
                             apply_body(x, "memory_bound", it, 2048), TOL)
            errs["taskbench_compute"] = max(errs["taskbench_compute"], e1)
            errs["memory_bound"] = max(errs["memory_bound"], e2)
    kinds = (("compute_bound", GRAIN), ("memory_bound", 4), ("empty", 0))
    for W in (W_MAIN, W_WIDE):
        for K in (1, 3):
            D = 3
            wgt = torch.rand((K, W, D), device=dev, generator=gen) / D
            idx = torch.randint(0, W + D - 1, (K, W, D), device=dev,
                                generator=gen, dtype=torch.int32)
            idx[:, ::2, 1] = idx[:, ::2, 0]  # duplicate slots: onehot merges them
            for combine in ("window", "gather", "onehot", "pair"):
                src = rand(K, 2 * W if combine == "pair" else W + D - 1, PAYLOAD)
                for kind, it in kinds:
                    kw = dict(kind=kind, iterations=it, scratch=2048, combine=combine)
                    e3 = check_close(f"K3 W={W} K={K} {combine} {kind}",
                                     ops.taskbench_step(src, idx, wgt, **kw),
                                     taskbench_step_plain(src, idx, wgt, **kw), TOL)
                    errs["taskbench_step"] = max(errs["taskbench_step"], e3)
    # K3 on out-of-range indices: gather wraps a negative index once and
    # clamps; an onehot slot outside the source adds nothing
    src = rand(1, 6, PAYLOAD)
    idx = torch.tensor([[[-1, 0], [6, 1], [-7, 2], [9, -2], [-2, -2]]],
                       dtype=torch.int32, device=dev)
    wgt = torch.full((1, 5, 2), 0.5, device=dev)
    for combine in ("gather", "onehot"):
        kw = dict(kind="empty", iterations=0, combine=combine)
        errs["taskbench_step"] = max(errs["taskbench_step"], check_close(
            f"K3 out-of-range {combine}", ops.taskbench_step(src, idx, wgt, **kw),
            taskbench_step_plain(src, idx, wgt, **kw), TOL))
    # K4 at the blocked main path's buffer: W + 2 * S * r rows (r = 2)
    M, K, D = W_MAIN + 2 * S_MAIN * 2, 3, 5
    for S in (2, S_MAIN):
        act = torch.ones((K, S), device=dev)
        act[:, S - 1] = 0.0  # the masked tail of a run's last launch
        act[K - 1] = 0.0     # a frozen member
        src = rand(K, M, PAYLOAD)
        for combine, tv in (("window", False), ("gather", False), ("onehot", False),
                            ("gather", True), ("onehot", True)):
            shape = (K, S, M, D) if tv else (K, M, D)
            wgt = torch.rand(shape, device=dev, generator=gen) / D
            idx = torch.randint(-2, M + 2, shape, device=dev, generator=gen,
                                dtype=torch.int32)
            idx[..., ::2, 1] = idx[..., ::2, 0]
            for kind, it in kinds:
                kw = dict(kind=kind, iterations=it, scratch=2048, combine=combine)
                got = ops.taskbench_step(src, idx, wgt, act, steps_per_launch=S, **kw)
                case = f"K4 S={S} {combine}{' time-varying' if tv else ''} {kind}"
                errs["taskbench_blocked"] = max(errs["taskbench_blocked"], check_close(
                    case, got, taskbench_step_blocked_plain(src, idx, wgt, act, **kw),
                    TOL))
                if not torch.equal(got[K - 1], src[K - 1]):
                    fail(f"{case}: the frozen member changed")
    # the pipelined phases, stitched, against one full launch (bit for bit)
    g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="random_nearest",
                  payload=PAYLOAD, kernel=KernelSpec("compute_bound", 1), radius=2)
    depth = S_MAIN * 2
    state = rand(1, W_MAIN, PAYLOAD)
    act = torch.ones((1, S_MAIN), device=dev)
    act[0, -3:] = 0.0
    rows = torch.from_numpy(ps_mod._extend_rows(W_MAIN, depth)).to(dev)
    hl, hr = ps_mod._prologue_exchange(state, depth)
    side = torch.cuda.Stream()
    for combine in ("window", "gather", "onehot"):
        for kind, it in (("compute_bound", 1), ("memory_bound", 2)):
            rt = get_runtime("pallas_step", combine=combine, steps_per_launch=S_MAIN)
            idx, wgt, _, _ = (torch.from_numpy(a)[None].to(dev)
                              for a in rt._blocked_operands(g, 2))
            kw = dict(kind=kind, iterations=it, scratch=2048, combine=combine,
                      steps_per_launch=S_MAIN)
            iext, wext = ps_mod._extend_tables(idx, wgt, depth, combine, row_axis=1)
            full = ops.taskbench_step(state.index_select(1, rows), iext, wext, act,
                                      **kw)[:, depth:depth + W_MAIN]
            ph = ps_mod._phase_tables(idx, wgt, depth, combine)
            for stream in (None, side):
                stitched, _, _ = ps_mod._pipelined_launch(
                    state, hl, hr, act, ph, depth, kw, stream)
                torch.cuda.synchronize()
                if not torch.equal(stitched, full):
                    fail(f"K4 phases ({combine} {kind}, side stream "
                         f"{stream is not None}): stitched != full launch")
    # K5 at the serving prefill and a windowed ragged case; K6 at the
    # serving decode, lengths from empty to past the capacity
    def normal(*shape, dtype):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    cfg_serve = get_config(SERVE_ARCH)
    Hq, Hkv, hd = cfg_serve.n_heads, cfg_serve.n_kv_heads, cfg_serve.head_dim_
    cap = SERVE_PROMPT + SERVE_GEN
    for dtype in (torch.bfloat16, torch.float32):
        for B, Sq, Sk, causal, window in ((SERVE_B, SERVE_PROMPT, SERVE_PROMPT, True, 0),
                                          (2, 1000, 1000, True, 300),
                                          (2, 77, 1000, False, 0)):
            q = normal(B, Hq, Sq, hd, dtype=dtype)
            k, v = normal(B, Hkv, Sk, hd, dtype=dtype), normal(B, Hkv, Sk, hd, dtype=dtype)
            kw = dict(causal=causal, window=window)
            form = K5_FORM[dtype]
            errs[form] = max(errs[form], check_attn(
                f"K5 {dtype} B={B} Sq={Sq} Sk={Sk} {kw}",
                ops.flash_attention(q, k, v, **kw), ref.attention_plain(q, k, v, **kw)))
        lengths = torch.tensor([0, 1, 513, 1024, 1050, cap - 1, cap, cap + 1],
                               dtype=torch.int32, device=dev)
        q = normal(len(lengths), Hq, hd, dtype=dtype)
        kc, vc = (normal(len(lengths), Hkv, cap, hd, dtype=dtype) for _ in range(2))
        for window in (0, 256):
            o, m, l = ops.decode_attention(q, kc, vc, lengths, window=window,
                                           return_stats=True)
            wo, wm, wl = ref.decode_attention_plain(q, kc, vc, lengths, window=window,
                                                    return_stats=True)
            case = f"K6 {dtype} window={window}"
            errs["decode_attention"] = max(errs["decode_attention"],
                                           check_attn(case, o, wo))
            for stat, got, want in (("m", m, wm), ("l", l, wl)):
                rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
                if not rel <= TOL_STATS_REL:
                    fail(f"{case} {stat}: relative error {rel} > {TOL_STATS_REL}")
            if l[0].abs().max().item() != 0.0 or o[0].abs().max().item() != 0.0:
                fail(f"{case}: an empty cache gave l or o != 0")
    # K5 and K6 at hymba's shape: GQA group 5, head dim 64, window 1024
    cfg_hyb = get_config(HYB_ARCH)
    hq, hkv, hhd, win = (cfg_hyb.n_heads, cfg_hyb.n_kv_heads, cfg_hyb.head_dim_,
                         cfg_hyb.window)
    hcap = HYB_PROMPT + HYB_GEN
    for dtype in (torch.bfloat16, torch.float32):
        q = normal(HYB_B, hq, HYB_PROMPT, hhd, dtype=dtype)
        k, v = (normal(HYB_B, hkv, HYB_PROMPT, hhd, dtype=dtype) for _ in range(2))
        form = K5_FORM[dtype]
        errs[form] = max(errs[form], check_attn(
            f"K5 hymba {dtype}", ops.flash_attention(q, k, v, causal=True, window=win),
            ref.attention_plain(q, k, v, causal=True, window=win)))
        lengths = torch.tensor([0, 1, win - 1, win, win + 1, hcap], dtype=torch.int32,
                               device=dev)
        q = normal(len(lengths), hq, hhd, dtype=dtype)
        kc, vc = (normal(len(lengths), hkv, hcap, hhd, dtype=dtype) for _ in range(2))
        errs["decode_attention"] = max(errs["decode_attention"], check_attn(
            f"K6 hymba {dtype}", ops.decode_attention(q, kc, vc, lengths, window=win),
            ref.decode_attention_plain(q, kc, vc, lengths, window=win)))
    # K7 at the serving prefills' chunks (mamba2: BC = 8 x 8 chunks, 24
    # heads, N 128; hymba: 50 heads, N 16), at a 5-token prompt, with two
    # groups; some dtA <= -30, whose decays underflow and must stay finite
    def ssd_inputs(BC, H, G, T, N, P, dtype):
        x = normal(BC, H, T, P, dtype=dtype)
        b, c = normal(BC, G, T, N, dtype=dtype), normal(BC, G, T, N, dtype=dtype)
        dt = torch.rand((BC, H, T), device=dev, generator=gen) * 0.1 + 0.001
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        dta = dt * A[None, :, None]
        dta[:, :, ::7] = -35.0
        return x, b, c, dta, dt

    cfg_ssm = get_config(SSM_ARCH)
    ssd_cases = (
        ("mamba2", SSM_B * SSM_PROMPT // cfg_ssm.ssm_chunk, cfg_ssm.ssm_heads,
         cfg_ssm.ssm_groups, cfg_ssm.ssm_chunk, cfg_ssm.ssm_state, cfg_ssm.ssm_head_dim),
        ("hymba", HYB_B * HYB_PROMPT // cfg_hyb.ssm_chunk, cfg_hyb.ssm_heads,
         cfg_hyb.ssm_groups, cfg_hyb.ssm_chunk, cfg_hyb.ssm_state, cfg_hyb.ssm_head_dim),
        ("T=5", 8, 24, 1, 5, 128, 64),
        ("G=2", 16, 8, 2, 128, 16, 64))
    for dtype in (torch.float32, torch.bfloat16):
        for label, *shape in ssd_cases:
            args = ssd_inputs(*shape, dtype=dtype)
            (y, st), (wy, wst) = ops.ssd_chunk(*args), ref.ssd_chunk_plain(*args)
            case = f"K7 {label} {dtype} (BC, H, G, T, N, P) = {tuple(shape)}"
            errs["ssd_chunk"] = max(errs["ssd_chunk"], check_scaled(f"{case} y", y, wy),
                                    check_scaled(f"{case} state", st, wst))
    # K8 at mamba2's norm shapes (d_model, and the gated norm over ssm_inner)
    # and a ragged one, weights in f32 (the model's) and in x's dtype
    for rows, d in ((SSM_B * SSM_PROMPT, cfg_ssm.d_model),
                    (SSM_B * SSM_PROMPT, cfg_ssm.ssm_inner), (37, 1000)):
        for dtype in (torch.bfloat16, torch.float32):
            x = normal(rows, d, dtype=dtype) * 3.0
            for wdt in (torch.float32, dtype):
                w = normal(d, dtype=wdt)
                errs["rmsnorm"] = max(errs["rmsnorm"], check_scaled(
                    f"K8 ({rows}, {d}) {dtype} w {wdt}", ops.rmsnorm(x, w, 1e-5),
                    ref.rmsnorm_plain(x, w, 1e-5)))
    torch.cuda.synchronize()
    print(f"[parity] K1-K8 (K5 in both forms) agree with their plain versions, K4's phases "
          f"stitched equal one launch, in {time.perf_counter() - t0:.3f} s; "
          f"max abs errors {errs}", flush=True)

    # ------------------------------------------------------------ main path
    t0 = time.perf_counter()
    ops.reset_launch_counts()

    def counted(fn):
        before = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        return out, {k: after[k] - before[k] for k in after}

    def run_all(g: TaskGraph, init):
        ps, d_ps = counted(lambda: get_runtime("pallas_step").execute(g, init))
        fk, d_fk = counted(lambda: get_runtime("fused", use_kernels=True).execute(g, init))
        fp, d_fp = counted(lambda: get_runtime("fused").execute(g, init))
        body = "taskbench_compute" if g.kernel.kind == "compute_bound" else "memory_bound"
        want_ps = dict.fromkeys(_build.ENTRIES, 0)
        want_ps["taskbench_step"] = g.steps
        want_fk = dict.fromkeys(_build.ENTRIES, 0)
        want_fk[body] = g.steps
        if d_ps != want_ps or d_fk != want_fk or any(d_fp.values()):
            fail(f"{g.describe()}: launches pallas_step {d_ps}, fused "
                 f"kernels {d_fk}, fused plain {d_fp}")
        if get_runtime("pallas_step").dispatches_per_run(g) != d_ps["taskbench_step"]:
            fail("pallas_step.dispatches_per_run disagrees with its launches")
        return [torch.from_numpy(a) for a in (ps, fk, fp)]

    blocked_launches = {}

    def run_blocked(g: TaskGraph, init, want, tol: float, combine: str = "window"):
        """pallas_step(steps_per_launch=S_MAIN), pipelined and serial: each
        held to the S = 1 run ``want``, its launches to 1 K3 plus one (serial)
        or two (pipelined) K4 per blocked launch and to dispatches_per_run,
        and pipelined equal to serial bit for bit."""
        outs = {}
        for label, opts in BLOCKED_RUNS:
            rt = get_runtime("pallas_step", combine=combine,
                             steps_per_launch=S_MAIN, **opts)
            out, d = counted(lambda: rt.execute(g, init))
            split = rt._pipeline_active(g.width, S_MAIN, halo_radius(g))
            want_d = dict.fromkeys(_build.ENTRIES, 0)
            want_d["taskbench_step"] = 1
            want_d["taskbench_blocked"] = -(-(g.steps - 1) // S_MAIN) * (1 + split)
            if d != want_d or sum(d.values()) != rt.dispatches_per_run(g):
                fail(f"{g.describe()} {combine} S={S_MAIN} {label}: launches {d}, "
                     f"expected {want_d}, dispatches_per_run "
                     f"{rt.dispatches_per_run(g)}")
            blocked_launches[label] = d["taskbench_blocked"]
            outs[label] = torch.from_numpy(out)
            check_close(f"{g.pattern} {combine} S={S_MAIN} {label} vs S=1",
                        outs[label], want, tol)
        if not torch.equal(outs["pipelined"], outs["serial"]):
            fail(f"{g.pattern} {combine} S={S_MAIN}: pipelined != serial")

    for pattern in HALO_PATTERNS:
        g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", GRAIN), radius=2, seed=0)
        init = rand(W_MAIN, PAYLOAD)
        ps, fk, fp = run_all(g, init)
        run_blocked(g, init, ps, TOL)
        if pattern in ("stencil_1d", "random_nearest"):
            for combine in ("gather", "onehot"):
                run_blocked(g, init, ps, TOL, combine)
        check_close(f"{pattern}: pallas_step vs fused(kernels)", ps, fk, TOL)
        check_close(f"{pattern}: fused(kernels) vs fused(plain)", fk, fp, TOL)
        for combine in ("gather", "onehot"):
            out, d = counted(lambda: get_runtime(
                "pallas_step", combine=combine).execute(g, init))
            if d["taskbench_step"] != T_MAIN:
                fail(f"{pattern} {combine}: launches {d}")
            check_close(f"{pattern}: pallas_step {combine} vs window",
                        torch.from_numpy(out), ps, TOL)
    g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="stencil_1d", payload=PAYLOAD,
                  kernel=KernelSpec("memory_bound", 4, scratch=2048), seed=0)
    init = rand(W_MAIN, PAYLOAD)
    ps, fk, fp = run_all(g, init)
    check_close("memory_bound: pallas_step vs fused(kernels)", ps, fk, TOL_MEMORY_RUN)
    check_close("memory_bound: fused(kernels) vs fused(plain)", fk, fp, TOL_MEMORY_RUN)
    run_blocked(g, init, ps, TOL_MEMORY_RUN)
    # Grain 64 drives every state to the FMA's fixed point 0.2, so also
    # check the dataflow where it shows: grain 1, 8 steps, against the
    # plain path on the CPU.
    for pattern in HALO_PATTERNS:
        g = TaskGraph(steps=8, width=64, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", 1), radius=3, seed=1)
        want = torch.from_numpy(get_runtime("fused", device="cpu").execute(g))
        init = get_runtime("fused", device="cpu")._init(g, None)
        for rt in (get_runtime("pallas_step"), get_runtime("fused", use_kernels=True),
                   get_runtime("pallas_step", combine="onehot"),
                   get_runtime("pallas_step", steps_per_launch=3),
                   get_runtime("pallas_step", steps_per_launch=3, pipeline=False),
                   get_runtime("pallas_step", steps_per_launch=3, combine="gather")):
            check_close(f"small {pattern} {rt.name} {rt.options}",
                        torch.from_numpy(rt.execute(g, init)), want, TOL)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for k, n in launches.items():
        if (n == 0) == (k in TASKBENCH_KERNELS):
            fail(f"kernel {k}: {n} launches on the Task Bench main path")
    print(f"[main] {len(HALO_PATTERNS)} halo patterns, W={W_MAIN} T={T_MAIN} "
          f"P={PAYLOAD} grain {GRAIN}: pallas_step (window, gather, onehot), "
          f"fused(kernels) and fused(plain) agree; pallas_step(steps_per_launch="
          f"{S_MAIN}) pipelined and serial agree with S=1 and with each other bit "
          f"for bit, K4 launches per run {blocked_launches} (+1 K3); launches "
          f"{launches}; {time.perf_counter() - t0:.3f} s", flush=True)

    # ----------------------------------------------------------------- METG
    t0 = time.perf_counter()
    step_wall = {}
    for od in (1, 16):
        W = SMS * od
        for rt_name, opts in (
                ("pallas_step", {}), ("fused", {"use_kernels": True}),
                ("pallas_step", {"steps_per_launch": S_MAIN}),
                ("pallas_step", {"steps_per_launch": S_MAIN, "pipeline": False})):
            rt = get_runtime(rt_name, **opts)
            if opts.get("steps_per_launch"):
                rt_name += f"[S={S_MAIN}{',serial' if 'pipeline' in opts else ''}]"
            samples = []
            for grain in GRAINS:
                g = TaskGraph(steps=T_MAIN, width=W, pattern="stencil_1d",
                              payload=PAYLOAD, kernel=KernelSpec("compute_bound", grain))
                s, st = rt.measure(g, reps=5, warmup=1)
                samples.append(s)
                step_wall[(rt_name, W, grain)] = s.wall_time / T_MAIN
                print(f"  {rt_name} W={W} grain={grain}: wall {s.wall_time:.6f} s "
                      f"({s.wall_time / T_MAIN * 1e6:.3f} us/step, "
                      f"{s.flops_per_second / 1e9:.3f} GFLOP/s, "
                      f"granularity {s.granularity_us:.4f} us, "
                      f"{st.dispatches} launches)")
            m = compute_metg(samples)
            metg = "unreached" if m.metg_us is None else f"{m.metg_us:.4f} us"
            print(f"METG(50%) {rt_name} W={W} (od {od}, T={T_MAIN}, 5 reps): "
                  f"{metg}, peak {m.peak_flops_per_second / 1e9:.3f} GFLOP/s "
                  f"| {smi}", flush=True)
    print(f"[metg] {time.perf_counter() - t0:.3f} s", flush=True)

    # ---------------------------------------------------------------- serve
    def serve_path(tag: str, arch: str, batch: int, prompt: int, gen: int,
                   want: dict, tol: float):
        """Serve ``arch`` at full width and depth through ``serve`` (random
        weights from seed 0, greedy), the launch counters zeroed just before
        and held to ``want`` just after; then the same model through the
        kernels and through the plain path, teacher-forced with the served
        tokens (the prefill and 4 decode steps held to ``tol``: limits on
        max |diff| / max |logit| and ||diff|| / ||logits||, None where a
        metric is only printed), 3 more
        decode steps under torch.profiler, and the prefill again, warm.
        Returns (cfg, serve result, launches, stats)."""
        t0 = time.perf_counter()
        cfg = get_config(arch)
        cap = prompt + gen
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res = serve(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=0, verbose=True,
                    device="cuda")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        want_d = dict.fromkeys(_build.ENTRIES, 0)
        want_d.update(want)
        if launches != want_d:
            fail(f"{tag} launches {launches}, expected {want_d}")
        if want.get("flash_attention"):
            # the counters name the form: the prefill's attention was bf16
            print(f"{tag} K5 received {cfg.dtype} operands: "
                  f"{launches['flash_attention']} launches of its tensor-core form, "
                  f"{launches['flash_attention_f32']} of its f32 form", flush=True)
        if res.tokens.shape != (batch, gen) or res.poisoned_steps:
            fail(f"{tag} tokens {res.tokens.shape}, poisoned steps {res.poisoned_steps}")
        rep = res.report
        stats = {
            "arch": arch, "batch": batch, "prompt": prompt, "gen": gen,
            "prefill_s": res.prefill_s,
            "prefill_tok_per_s": batch * prompt / res.prefill_s,
            "decode_tok_per_s": res.tokens_per_s,
            "decode_tok_per_s_steady": rep.tokens_per_s,
            "step_wall_p50_ms": rep.p50_wall * 1e3,
            "step_wall_mean_ms": rep.mean_wall * 1e3,
            "flagged_steps": len(res.flagged_steps),
            "peak_gib_serve": torch.cuda.max_memory_allocated() / 2**30,
        }
        # the same model (seed 0) through the kernels and through the plain
        # path, on the served prompts, teacher-forced with the served tokens
        models = {"kernels": Model(cfg, device=dev, seed=0),
                  "plain": Model(dataclasses.replace(cfg, use_flash=False),
                                 device=dev, seed=0)}
        prompts = make_prompts(cfg, batch, prompt, 0, dev)
        served = torch.from_numpy(res.tokens).to(dev)
        state = {}
        for label, model in models.items():
            lg, c = model.prefill(prompts)
            state[label] = [lg], _grow_caches(model, c, batch, cap)
        lengths = torch.full((batch,), prompt, dtype=torch.int32, device=dev)
        for i in range(4):
            for label, model in models.items():
                lgs, c = state[label]
                lg, c = model.decode_step(served[:, i:i + 1], lengths, c)
                state[label] = lgs + [lg], c
            lengths = lengths + 1
        rel, rms = [], []
        for i, (lk, lp) in enumerate(zip(state["kernels"][0], state["plain"][0])):
            what = "prefill" if i == 0 else f"decode step {i - 1}"
            if not (bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())):
                fail(f"{tag} {what}: non-finite logits")
            if not torch.equal(lk.argmax(-1), served[:, i]):
                fail(f"{tag} {what}: the kernel path's argmax differs from the served token")
            rel.append(((lk - lp).abs().max() / lp.abs().max()).item())
            rms.append((torch.linalg.vector_norm(lk - lp) / torch.linalg.vector_norm(lp)).item())
        print(f"{tag} kernel vs plain path, prefill and 4 decode steps: max |diff| / "
              f"max |logit| {rel} (limit {tol['max']}); ||diff|| / ||logits|| {rms} "
              f"(limit {tol['rms']})", flush=True)
        for metric, got in (("max", rel), ("rms", rms)):
            if tol[metric] is not None and not max(got) <= tol[metric]:
                fail(f"{tag} kernel vs plain path ({metric}): {got}, above {tol[metric]}")
        agree = [float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
                 for lk, lp in zip(state["kernels"][0], state["plain"][0])]
        # where a decode step's device time goes: 3 more steps of the kernel
        # path under torch.profiler, its kernels' device times summed by name
        from torch.profiler import ProfilerActivity, profile

        km, (_, c) = models["kernels"], state["kernels"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for i in range(4, 7):
                _, c = km.decode_step(served[:, i:i + 1], lengths, c)
                lengths = lengths + 1
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t1) * 1e3
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        busy_ms = sum(by_name.values())
        # and where its host time goes: the operators by self CPU time
        cpu_avg = prof.key_averages()
        cpu_top = sorted(cpu_avg, key=lambda a: -a.self_cpu_time_total)[:12]
        cpu_ops_ms = sum(a.self_cpu_time_total for a in cpu_avg) / 1e3
        # the prefill again, its bf16 weight copies and libraries now warm
        t1 = time.perf_counter()
        km.prefill(prompts)
        torch.cuda.synchronize()
        stats["prefill_warm_s"] = time.perf_counter() - t1
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        stats["profile_3_steps"] = {
            "window_ms": window_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / window_ms,
            "top_kernels_ms": {name[:80]: ms for name, ms in top},
            "cpu_ops_self_ms": cpu_ops_ms,
            "top_cpu_self_ms": {a.key[:80]: [a.self_cpu_time_total / 1e3, a.count]
                                for a in cpu_top}}
        stats.update(kernel_vs_plain_rel=rel, kernel_vs_plain_rms=rms,
                     argmax_agreement=agree,
                     peak_gib_with_two_models=torch.cuda.max_memory_allocated() / 2**30)
        del models, state, c, km
        torch.cuda.empty_cache()
        print(f"{tag} 3 decode steps under torch.profiler: {window_ms:.3f} ms, device "
              f"busy {busy_ms:.3f} ms ({busy_ms / window_ms:.4f}); top kernels "
              f"{[(n[:60], round(ms, 3)) for n, ms in top]}", flush=True)
        print(f"{tag} the same 3 steps, host operators' self CPU time {cpu_ops_ms:.3f} ms "
              f"in all; the top by self CPU time (ms, calls): "
              f"{[(a.key[:60], a.self_cpu_time_total / 1e3, a.count) for a in cpu_top]}",
              flush=True)
        print(f"{tag} {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, bf16 "
              f"compute), batch {batch}, prompt {prompt}, gen {gen}: prefill "
              f"{stats['prefill_tok_per_s']:.1f} tok/s ({res.prefill_s * 1e3:.3f} ms; "
              f"warm {stats['prefill_warm_s'] * 1e3:.3f} ms), "
              f"decode {res.tokens_per_s:.1f} tok/s ({rep.tokens_per_s:.1f} steady), "
              f"p50 step wall {rep.p50_wall * 1e3:.3f} ms; launches {launches}; "
              f"kernel vs plain path, max |diff| / max |logit|: {rel}, ||diff|| / "
              f"||logits||: {rms} (argmax agreement {agree}); "
              f"{time.perf_counter() - t0:.3f} s | {smi}", flush=True)
        print(json.dumps({tag.strip("[]"): stats}), flush=True)
        return cfg, res, launches, stats

    n_layers, steps = cfg_serve.n_layers, SERVE_GEN - 1
    _, res, serve_launches, serve_stats = serve_path(
        "[serve]", SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN,
        dict(flash_attention=n_layers, decode_attention=n_layers * steps),
        {"max": TOL_SERVE_REL, "rms": None})
    rep = res.report
    # mamba2-130m: K7 once per layer in the prefill, no kernel in decode
    _, res_ssm, ssm_launches, ssm_stats = serve_path(
        "[serve-ssm]", SSM_ARCH, SSM_B, SSM_PROMPT, SSM_GEN,
        dict(ssd_chunk=cfg_ssm.n_layers), TOL_SERVE_SSM)
    # hymba-1.5b: K5 and K7 once per layer in the prefill, K6 per layer and step
    hl, hs = cfg_hyb.n_layers, HYB_GEN - 1
    _, _, hyb_launches, hyb_stats = serve_path(
        "[serve-hybrid]", HYB_ARCH, HYB_B, HYB_PROMPT, HYB_GEN,
        dict(flash_attention=hl, ssd_chunk=hl, decode_attention=hl * hs), TOL_SERVE_HYB)

    # ----------------------------------------------------------------- norm
    # K8's one entry point, ops.rmsnorm, over mamba2-130m's norm shapes: the
    # embedded prompts of the served batch (d_model rows) and a gated-norm
    # input (ssm_inner rows), bf16, with the model's f32 weights
    t0 = time.perf_counter()
    emb = Model(cfg_ssm, device=dev, seed=0)
    xs = [emb.embed[make_prompts(cfg_ssm, SSM_B, SSM_PROMPT, 0, dev)].to(torch.bfloat16)
          .reshape(-1, cfg_ssm.d_model),
          normal(SSM_B * SSM_PROMPT, cfg_ssm.ssm_inner, dtype=torch.bfloat16)]
    ws = [emb.final_norm.detach(), emb.layers[0].ssm.norm_w.detach()]
    del emb
    ops.reset_launch_counts()
    normed = [ops.rmsnorm(x, w, cfg_ssm.norm_eps) for x, w in zip(xs, ws)]
    torch.cuda.synchronize()
    norm_launches = ops.launch_counts()
    if norm_launches != dict(dict.fromkeys(_build.ENTRIES, 0), rmsnorm=len(xs)):
        fail(f"[norm] launches {norm_launches}")
    for x, w, o in zip(xs, ws, normed):
        errs["rmsnorm"] = max(errs["rmsnorm"], check_scaled(
            f"[norm] {tuple(x.shape)}", o, ref.rmsnorm_plain(x, w, cfg_ssm.norm_eps)))
    print(f"[norm] ops.rmsnorm over {[tuple(x.shape) for x in xs]} bf16: launches "
          f"{norm_launches['rmsnorm']} K8, agree with the plain version; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # ---------------------------------------------------------------- times
    x = rand(W_MAIN, PAYLOAD)
    H, D = 1, 3  # stencil_1d: the METG pattern
    g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="stencil_1d", payload=PAYLOAD,
                  kernel=KernelSpec("compute_bound", GRAIN))
    from repro_torch.core.runtimes.pallas_step import _window_operands

    _, w_np = _window_operands(g, H)
    wgt = torch.from_numpy(w_np)[None].to(dev)
    src = rand(1, W_MAIN + 2 * H, PAYLOAD)
    n_el = W_MAIN * PAYLOAD
    mem_it, scratch = 4, 2048
    step_kw = dict(kind="compute_bound", iterations=GRAIN, scratch=scratch,
                   combine="window")
    cases = [
        ("taskbench_compute", "K1", "src/repro_torch/kernels/csrc/taskbench_compute.cu",
         "src/repro/kernels/taskbench_compute.py:30",
         lambda: ops.taskbench_compute(x, GRAIN),
         lambda: apply_body(x, "compute_bound", GRAIN, 0),
         2 * n_el * 4, 2 * n_el * GRAIN),
        ("memory_bound", "K2", "src/repro_torch/kernels/csrc/memory_bound.cu",
         "src/repro/kernels/bodies.py:107",
         lambda: ops.taskbench_memory(x, mem_it, scratch),
         lambda: apply_body(x, "memory_bound", mem_it, scratch),
         2 * n_el * 4, W_MAIN * (scratch * (mem_it + 1) + PAYLOAD)),
        ("taskbench_step", "K3", "src/repro_torch/kernels/csrc/taskbench_step.cu",
         "src/repro/kernels/taskbench_step.py:368",
         lambda: ops.taskbench_step(src, None, wgt, **step_kw),
         lambda: taskbench_step_plain(src, None, wgt, **step_kw),
         (src.numel() + wgt.numel() + n_el) * 4, n_el * (2 * D + 2 * GRAIN)),
    ]
    # K4 at the blocked main path's shape: nearest (r = 2, window D = 5),
    # S = 8, a buffer of M = W + 2 * S * r = 2144 rows
    gb = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="nearest", payload=PAYLOAD,
                   kernel=KernelSpec("compute_bound", GRAIN), radius=2)
    Hb, Db = 2, 5
    depth = S_MAIN * Hb
    M = W_MAIN + 2 * depth
    wb = torch.from_numpy(_window_operands(gb, Hb)[1])[None].to(dev)
    wext = ps_mod._wrap(wb, depth, 1)
    srcb = rand(1, M, PAYLOAD)
    actb = torch.ones((1, S_MAIN), device=dev)
    blk_kw = dict(step_kw, steps_per_launch=S_MAIN)

    def k4_cost(rows):
        """(bytes, f32 operations) of one K4 launch on a `rows`-row buffer:
        src, weights and act read once, the buffer written once; per depth
        a D-tap combine and the grain-64 FMA chain per element."""
        return ((2 * rows * PAYLOAD + rows * Db + S_MAIN) * 4,
                S_MAIN * rows * PAYLOAD * (2 * Db + 2 * GRAIN))

    cases.append(
        ("taskbench_blocked", "K4", "src/repro_torch/kernels/csrc/taskbench_blocked.cu",
         "src/repro/kernels/taskbench_step.py:275",
         lambda: ops.taskbench_step(srcb, None, wext, actb, **blk_kw),
         lambda: taskbench_step_blocked_plain(srcb, None, wext, actb, **step_kw),
         *k4_cost(M)))
    kernels = []
    for kname, tag, source, replaces, kern, plain, nbytes, nops in cases:
        check_close(f"{tag} timing inputs", kern(), plain(), TOL)
        ms = gpu_ms(kern, 200)
        # K4's plain version issues ~1100 operations per call, more than
        # the launch queue holds: its time spans the host's enqueue gaps
        plain_ms = gpu_ms(plain, 2, cover=False) if tag == "K4" else gpu_ms(plain, 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS_PER_S * 1e3
        per_run = dict(blocked_launches) if tag == "K4" else T_MAIN
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": errs[kname],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "launches_per_run": per_run,
        })
        print(f"[time] {tag} {kname}: {ms * 1e3:.3f} us per launch, {per_run} "
              f"launches per main-path run (plain version {plain_ms * 1e3:.3f} us, "
              f"no yardstick; no single PyTorch call computes it), bound "
              f"{max(t_bytes, t_ops) * 1e3:.3f} us by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'} | {smi}", flush=True)
    # K2 moves its bytes through shared memory: per row the tile-out writes
    # `scratch` floats, each pass reads and writes them, the fold reads them
    # back; against 132 SMs x 128 B per clock at the card's top SM clock
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    k2 = kernels[1]
    k2["smem_bytes"] = W_MAIN * 4 * scratch * (2 * mem_it + 2)
    k2["smem_bytes_per_s"] = SMS * 128 * sm_mhz * 1e6
    k2["smem_bound_ms"] = k2["smem_bytes"] / k2["smem_bytes_per_s"] * 1e3
    k2["binds"] = "shared memory" if k2["smem_bound_ms"] > k2["bound_ms"] else k2["bound_by"]
    print(f"[time] K2 memory_bound: {k2['smem_bytes']} shared-memory bytes per launch at "
          f"{SMS} SMs x 128 B x {sm_mhz:.0f} MHz: bound {k2['smem_bound_ms'] * 1e3:.3f} us "
          f"({k2['binds']} binds), against {k2['ms'] * 1e3:.3f} us | {smi}", flush=True)
    k3_us = kernels[2]["ms"] * 1e3
    wall_us = step_wall[("pallas_step", W_MAIN, GRAIN)] * 1e6
    print(f"[time] pallas_step W={W_MAIN} grain {GRAIN}: step wall {wall_us:.3f} us, "
          f"K3 {k3_us:.3f} us: device busy share ~{k3_us / wall_us:.4f}")
    # K4's pipelined phases at their shapes: the boundary buffer (6 * depth
    # rows) and the interior (the owned W rows)
    ph = ps_mod._phase_tables(None, wb, depth, "window")
    state = rand(1, W_MAIN, PAYLOAD)
    bl, br = rand(1, 3 * depth, PAYLOAD), rand(1, 3 * depth, PAYLOAD)
    k4 = kernels[3]
    for phase, fn, rows in (
            ("boundary", lambda: ops.taskbench_boundary(
                bl, br, ph.i_bnd, ph.w_bnd, actb, depth=depth, **blk_kw), 6 * depth),
            ("interior", lambda: ops.taskbench_interior(
                state, ph.i_int, ph.w_int, actb, depth=depth, **blk_kw), W_MAIN)):
        ms = gpu_ms(fn, 200)
        nbytes, nops = k4_cost(rows)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS_PER_S) * 1e3
        k4[f"{phase}_ms"], k4[f"{phase}_bound_ms"] = ms, bound
        print(f"[time] K4 {phase} launch ({rows} rows, S={S_MAIN}): {ms * 1e3:.3f} us, "
              f"bound {bound * 1e3:.3f} us | {smi}", flush=True)
    # K4's cost per depth: the full buffer at S = 2 beside S = S_MAIN
    act2 = torch.ones((1, 2), device=dev)
    k4["ms_at_S2"] = ms2 = gpu_ms(lambda: ops.taskbench_step(
        srcb, None, wext, act2, **dict(step_kw, steps_per_launch=2)), 200)
    per_depth = (k4["ms"] - ms2) / (S_MAIN - 2)
    print(f"[time] K4 full buffer: S=2 {ms2 * 1e3:.3f} us, S={S_MAIN} "
          f"{k4['ms'] * 1e3:.3f} us: {per_depth * 1e3:.3f} us per depth, "
          f"{(ms2 - 2 * per_depth) * 1e3:.3f} us per launch besides | {smi}",
          flush=True)
    # one whole pipelined launch (two concatenations, the two phases, the
    # stitching concatenation), its interior on the same stream or on a
    # second one: how far the two K4 launches overlap on the card
    hl, hr = ps_mod._prologue_exchange(state, depth)
    side = torch.cuda.Stream()
    for label, stream in (("one stream", None), ("two streams", side)):
        # ~9 operations per call: 50 calls stay within the launch queue
        k4[f"pipelined_launch_ms_{label.replace(' ', '_')}"] = ms = gpu_ms(
            lambda: ps_mod._pipelined_launch(state, hl, hr, actb, ph, depth,
                                             blk_kw, stream), 50)
        print(f"[time] pipelined launch, interior on {label}: {ms * 1e3:.3f} us "
              f"(boundary {k4['boundary_ms'] * 1e3:.3f} + interior "
              f"{k4['interior_ms'] * 1e3:.3f} us alone) | {smi}", flush=True)
    for label, key, k4_us in (
            ("serial", f"pallas_step[S={S_MAIN},serial]", k4["ms"] * 1e3),
            ("pipelined", f"pallas_step[S={S_MAIN}]",
             (k4["boundary_ms"] + k4["interior_ms"]) * 1e3)):
        wall_us = step_wall[(key, W_MAIN, GRAIN)] * 1e6
        print(f"[time] {key} W={W_MAIN} grain {GRAIN}: step wall {wall_us:.3f} us "
              f"per timestep, K4 {k4_us / S_MAIN:.3f} us per timestep ({label}): "
              f"device busy share ~{k4_us / S_MAIN / wall_us:.4f}")

    # K5 at internlm2's and hymba's prefill shapes (bf16, and its f32 form at
    # internlm2's), K6 at the serving decode warm and L2-cold, each beside
    # scaled_dot_product_attention on the same inputs (a yardstick only)
    t5, (got, want) = attention_times.flash_case(SERVE_B, Hq, Hkv, SERVE_PROMPT, hd)
    check_attn("K5 timing inputs", got, want)
    t5h, (got, want) = attention_times.flash_case(HYB_B, hq, hkv, HYB_PROMPT, hhd, window=win)
    check_attn("K5 hymba timing inputs", got, want)
    t5f, (got, want) = attention_times.flash_case(SERVE_B, Hq, Hkv, SERVE_PROMPT, hd,
                                                  dtype=torch.float32, reps=(5, 3, 20))
    check_attn("K5 f32 timing inputs", got, want)
    t6, (got, want) = attention_times.decode_case(SERVE_B, Hq, Hkv, SERVE_PROMPT, cap, hd)
    check_attn("K6 timing inputs", got, want)
    del got, want
    yard = ("library_backend", "library_pinned_ms", "library_kernels")
    k5 = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:103",
        "launches": serve_launches["flash_attention"],
        "max_abs_err": errs["flash_attention"], "ms": t5["ms"], "plain_ms": t5["plain_ms"],
        "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
        "library_ms": t5["library_ms"], **{key: t5[key] for key in yard},
        "shape_B_Hq_Hkv_S_D": t5["shape"], "dtype": "bfloat16",
        "hymba": {key: t5h[key] for key in ("shape", "window", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms", *yard)},
        "f32_form": {"source": "src/repro_torch/kernels/csrc/flash_attention_f32.cu",
                     "launches": serve_launches["flash_attention_f32"],
                     "max_abs_err": errs["flash_attention_f32"],
                     **{key: t5f[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", *yard)}},
        "launches_by_path": {"serve": serve_launches["flash_attention"],
                             "serve-hybrid": hyb_launches["flash_attention"]},
        "launches_per_run": serve_launches["flash_attention"],
        "prefill_share": n_layers * t5["ms"] / (res.prefill_s * 1e3),
        "prefill_share_warm": n_layers * t5["ms"] / (serve_stats["prefill_warm_s"] * 1e3),
        "hymba_prefill_share_warm": cfg_hyb.n_layers * t5h["ms"]
        / (hyb_stats["prefill_warm_s"] * 1e3),
    }
    k6 = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:76",
        "launches": serve_launches["decode_attention"],
        "max_abs_err": errs["decode_attention"],
        "timing": f"ms and library_ms L2-cold ({t6['cold_copies']} caches, "
                  f"{t6['cold_bytes']} bytes, called in turn); warm_ms and "
                  f"library_warm_ms one cache called back to back",
        "ms": t6["cold_ms"], "warm_ms": t6["ms"], "plain_ms": t6["plain_ms"],
        "bound_ms": t6["bound_ms"], "bound_by": t6["bound_by"],
        "library_ms": t6["library_cold_ms"], "library_warm_ms": t6["library_ms"],
        "library_backend": t6["library_backend"], "library_kernels": t6["library_kernels"],
        "library_pinned_ms": t6["library_pinned_cold_ms"],
        "library_pinned_warm_ms": t6["library_pinned_ms"],
        "shape_B_Hq_Hkv_S_D": t6["shape"], "visible": t6["visible"], "dtype": "bfloat16",
        "launches_by_path": {"serve": serve_launches["decode_attention"],
                             "serve-hybrid": hyb_launches["decode_attention"]},
        "launches_per_run": serve_launches["decode_attention"],
        "decode_share": n_layers * t6["cold_ms"] / (rep.p50_wall * 1e3),
    }
    kernels += [k5, k6]
    for tag, t, shape in (("K5", t5, "internlm2"), ("K5", t5h, "hymba"),
                          ("K5 f32 form", t5f, "internlm2"), ("K6 warm", t6, "internlm2")):
        print(f"[time] {tag} {shape} {t['shape']}: {t['ms'] * 1e3:.3f} us per launch "
              f"(plain version {t['plain_ms'] * 1e3:.3f} us; scaled_dot_product_attention "
              f"{t['library_ms'] * 1e3:.3f} us by PyTorch's choice, {t['library_backend']}; "
              f"pinned {t['library_pinned_ms']}), bound {t['bound_ms'] * 1e3:.3f} us by "
              f"{t['bound_by']} | {smi}", flush=True)
    print(f"[time] K6 cold ({t6['cold_copies']} caches, {t6['cold_bytes']} bytes, in "
          f"turn): {t6['cold_ms'] * 1e3:.3f} us per launch (scaled_dot_product_attention "
          f"{t6['library_cold_ms'] * 1e3:.3f} us, pinned {t6['library_pinned_cold_ms']}), "
          f"bound {t6['bound_ms'] * 1e3:.3f} us by {t6['bound_by']}; "
          f"{serve_launches['decode_attention']} launches in the serve run | {smi}", flush=True)
    print(f"[time] K6 (cold) x {n_layers} layers = {k6['decode_share']:.4f} of the p50 decode "
          f"step wall; K5 x {n_layers} = {k5['prefill_share']:.4f} of the prefill wall, "
          f"{k5['prefill_share_warm']:.4f} of the warm one; hymba's 32 K5 = "
          f"{k5['hymba_prefill_share_warm']:.4f} of its warm prefill", flush=True)

    gen_t = torch.Generator(device=dev).manual_seed(1)

    def bf16(*shape):
        return torch.randn(shape, device=dev, generator=gen_t).to(torch.bfloat16)

    # K7 at the mamba2-130m serving prefill's chunks, in the f32 the path
    # gives it (and in bf16 beside), K8 at mamba2's norm shapes in bf16
    # beside torch.nn.functional.rms_norm (a yardstick only)
    def ssd_cost(BC, H, G, T, N, P, item):
        """(bytes, operations) of one K7 launch: x, B, C, dtA and dt read
        once, y and the state written once; C B^T once per (chunk, group)
        over the causal half, then per head the decay mask, the two
        products (the causal half of Y) and the scalings."""
        tri = T * (T + 1) // 2
        nbytes = item * (2 * BC * H * T * P + 2 * BC * G * T * N) + 4 * (
            2 * BC * H * T + BC * H * N * P)
        nops = 2 * BC * G * tri * N + BC * H * (tri + 2 * tri * P + 2 * T * N * P
                                                + T * P + T * N)
        return nbytes, nops

    shape7 = ssd_cases[0][1:]
    x7 = ssd_inputs(*shape7, dtype=torch.float32)
    x7b = tuple(t.to(torch.bfloat16) if i < 3 else t for i, t in enumerate(x7))
    got, want = ops.ssd_chunk(*x7), ref.ssd_chunk_plain(*x7)
    check_scaled("K7 timing inputs y", got[0], want[0])
    check_scaled("K7 timing inputs state", got[1], want[1])
    ms7 = gpu_ms(lambda: ops.ssd_chunk(*x7), 50)
    # the plain version issues ~140 operations per call (its cumsum is a
    # loop over T): its time spans the host's enqueue gaps, as K4's plain
    plain7 = gpu_ms(lambda: ref.ssd_chunk_plain(*x7), 3, cover=False)
    ms7b = gpu_ms(lambda: ops.ssd_chunk(*x7b), 50)
    nbytes, nops = ssd_cost(*shape7, 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS_PER_S * 1e3
    nb_b, no_b = ssd_cost(*shape7, 2)
    bound_b = max(nb_b / HBM_BYTES_PER_S, no_b / BF16_FLOPS_PER_S) * 1e3
    warm_s = ssm_stats["prefill_warm_s"]
    rec7 = {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:68",
        "launches": ssm_launches["ssd_chunk"], "max_abs_err": errs["ssd_chunk"],
        "ms": ms7, "plain_ms": plain7, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
        "shape_BC_H_G_T_N_P": list(shape7), "dtype": "float32",
        "ms_bf16": ms7b, "bound_ms_bf16": bound_b,
        "launches_by_path": {"serve-ssm": ssm_launches["ssd_chunk"],
                             "serve-hybrid": hyb_launches["ssd_chunk"]},
        "prefill_share_warm": cfg_ssm.n_layers * ms7 / (warm_s * 1e3),
        "prefill_share_cold": cfg_ssm.n_layers * ms7 / (res_ssm.prefill_s * 1e3),
    }
    kernels.append(rec7)
    print(f"[time] K7 ssd_chunk: {ms7 * 1e3:.3f} us per launch at (BC, H, G, T, N, P) = "
          f"{shape7} f32 ({ms7b * 1e3:.3f} us in bf16, bound {bound_b * 1e3:.3f} us), "
          f"{rec7['launches']} launches in the serve-ssm run (plain version "
          f"{plain7 * 1e3:.3f} us, no yardstick; no single PyTorch call computes it), "
          f"bound {rec7['bound_ms'] * 1e3:.3f} us by {rec7['bound_by']} | {smi}", flush=True)
    print(f"[time] K7 x {cfg_ssm.n_layers} layers = {rec7['prefill_share_warm']:.4f} of "
          f"the warm mamba2 prefill wall ({warm_s * 1e3:.3f} ms), "
          f"{rec7['prefill_share_cold']:.4f} of the cold one", flush=True)
    rec8 = None
    for rows, d in ((SSM_B * SSM_PROMPT, cfg_ssm.d_model),
                    (SSM_B * SSM_PROMPT, cfg_ssm.ssm_inner)):
        x8 = bf16(rows, d)
        w8 = bf16(d)
        check_scaled("K8 timing inputs", ops.rmsnorm(x8, w8, 1e-5),
                     ref.rmsnorm_plain(x8, w8, 1e-5))
        ms8 = gpu_ms(lambda: ops.rmsnorm(x8, w8, 1e-5), 200)
        plain8 = gpu_ms(lambda: ref.rmsnorm_plain(x8, w8, 1e-5), 50)
        lib8 = gpu_ms(lambda: F.rms_norm(x8, (d,), w8, 1e-5), 200)
        t_bytes = 2 * (2 * rows * d + d) / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * rows * d / BF16_FLOPS_PER_S * 1e3
        print(f"[time] K8 rmsnorm ({rows}, {d}) bf16: {ms8 * 1e3:.3f} us per launch "
              f"(plain version {plain8 * 1e3:.3f} us, rms_norm {lib8 * 1e3:.3f} us), "
              f"bound {max(t_bytes, t_ops) * 1e3:.3f} us by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'} | {smi}", flush=True)
        if rec8 is None:
            rec8 = {
                "name": "rmsnorm", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                "replaces": "src/repro/kernels/rmsnorm.py:31",
                "launches": norm_launches["rmsnorm"], "max_abs_err": errs["rmsnorm"],
                "ms": ms8, "plain_ms": plain8, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib8, "shape": [rows, d], "dtype": "bfloat16",
                "launches_by_path": {"norm": norm_launches["rmsnorm"]}}
        else:
            rec8["gated_shape"] = [rows, d]
            rec8.update(gated_ms=ms8, gated_plain_ms=plain8, gated_library_ms=lib8,
                        gated_bound_ms=max(t_bytes, t_ops))
    kernels.append(rec8)

    loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "repro" or m.startswith("repro.")]
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded[:5]}")
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.3f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
