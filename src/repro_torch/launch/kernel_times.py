"""K1-K4, K7 and K8 on the card, timed beside their yardsticks.

    PYTHONPATH=src python -m repro_torch.launch.kernel_times [--only floor,k1,k3,k4,k2,k8,k7,step]

The launch floor: a kernel that does nothing (``csrc/launch_floor.cu``, one
CTA of 32 threads), timed with the same method as every case below; no
kernel's time at launch size can go under it. Beside it, the FMA's
dependent latency in SM cycles (clock64 marks around chains of n and 2n
``fmaf(v, 0.5f, 0.1f)`` in one thread).

K1 (``ops.taskbench_compute``) at rows 132, 2112 and 65536 x payload 64
(the METG sweep's two widths and a 16 MiB state), grains 1, 64, 1024 and
16384; K3 (``ops.taskbench_step``) at W = 132 and 2112, payload 64, in
window D = 3 (stencil_1d) and D = 5 (nearest), gather D = 5 (nearest's
tables) and onehot D = 5 (the same with duplicate slots in every other
row), at grain 64, 16384 and the empty body, on the halo-extended source;
and the S = 1 step of ``pallas_step`` as it issues it, at grain 64 and
the empty body: the one K3 launch with the halo wrap folded in (``wrap``)
on the W-row state. Each case prints the CTAs its launch ran (the plan
its wrapper handed the launch, ``_build.LAST_CTAS``). Their bound is the
largest of the HBM bytes (each input read once, the output written once),
the f32 operations at the FMA peak, and each element's chain of dependent
FMAs (K1: grain; K3: D taps and grain) times the FMA's latency at the
card's top SM clock: a launch whose chains cannot fill the card's FMA
pipes is bound by that chain.

``--only step``: ``pallas_step``'s step wall on the host clock at S = 1
and at S = 8 pipelined and serial (stencil_1d and nearest, W = 132 and
2112, grain 64, T = 1000), each run as one CUDA graph replay and as its
eager loop, 10 timed runs each, in two turns of 5 (``_capture.time_runs``:
each input staged outside the timed region, as ``measure`` does).

K4 (``ops.taskbench_step`` at ``steps_per_launch=S``) at the blocked main
path's shape: ``nearest`` at radius 2 (window D = 5), W = 2112, payload
64, compute_bound grain 64, a buffer of M = W + 2 * 8 * 2 = 2144 rows, at
S = 2 and S = 8 (the difference over 6 depths is the time per depth, the
rest the time per launch besides); and the pipelined runtime's two phases
at S = 8, the boundary buffer (96 rows) and the interior (2112 rows). Each
in K4's three forms: the tiled form (radius 2), the resident form and the
cooperative form (each pinned with ``form=``). Then the blocked all-gather
plan's launches in the resident and the cooperative form: fft's
time-varying (1, 8, W, 2) tables at W = 512 and 2048 (the first launch's,
as the runtime builds them) and all_to_all's static (1, 512, 512) table,
grain 64; and the cooperative form's memory body at the main path's
memory_bound run (stencil_1d, window D = 3, 2128 rows, S = 8, iterations
4, scratch 2048) beside S x K2's shared-memory bound on that buffer. The
bound is the larger of the HBM bytes (src, weights and act read once, the
buffer written once) and the f32 operations (per depth a D-tap combine
and the grain's FMA chain per element) at the f32 FMA peak.

K2 (``ops.taskbench_memory``) at (2112, 64), scratch 2048, iterations 1,
4 and 16, beside its shared-memory bound: per row the tile-out writes
``scratch`` floats, each pass reads and writes them and the fold reads them
back, over 132 SMs x 128 B per clock at the card's top SM clock.

K8 (``ops.rmsnorm``) at mamba2-130m's norm shapes, (8192, 768) and (8192,
1536) in bf16 with bf16 weights, beside ``torch.nn.functional.rms_norm`` on
the same inputs, a yardstick the port never calls. Each is timed twice:
warm (one input, called back to back; at d = 768 its 12.6 MB fits the 50
MB L2, so the HBM bound is no floor there) and cold (enough distinct
inputs, called in turn, that together they exceed twice the L2, so that
each call finds its input evicted). The bound is the HBM bytes of x read
once, the output written once and w, in both.

K7 (``ops.ssd_chunk``) at the serving prefills' chunks, mamba2-130m's (BC
64, H 24, G 1, T = N = 128, P 64) and hymba-1.5b's (32, 50, 1, 128, 16,
64), in f32 (the path's dtype) and bf16, beside its plain version (no
single PyTorch call computes it); in f32 both are also held to the same
function in f64 (``ssd_f64``), max and mean error over the output's scale. Its inputs and outputs (~160 MB at
mamba2's shape in f32) exceed the L2 whatever the order. Its bound is the
larger of the HBM bytes and the operations at the rates of the units the
kernel runs them on: C B^T at the f32 FMA peak, the two head products on
the TF32 tensor cores with each f32 product taken as six TF32 products in
Y (three parts of each operand) and three in the state (two parts; with a
bf16 x, exact in TF32: three and two). The f32 FMA figure, the bound of a
kernel without tensor cores, is reported beside it.

``main`` prints one JSON line per case. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import taskbench_step as _k34
from repro_torch.kernels.bodies import apply_body
from repro_torch.launch.attention_times import gpu_ms

# Published H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
F32_FLOPS_PER_S = 67e12

#: (BC, H, G, T, N, P) of one K7 launch at each serving prefill: batch x
#: prompt / chunk chunks (mamba2-130m batch 8, hymba-1.5b batch 4, prompt
#: 1024, chunk 128), the model's SSD heads, groups, state and head size.
SSD_SHAPES = {"mamba2-130m": (64, 24, 1, 128, 128, 64),
              "hymba-1.5b": (32, 50, 1, 128, 16, 64)}
#: (rows, d) of mamba2-130m's norms at the serving prefill (8 x 1024
#: tokens): d_model, and the gated norm over ssm_inner.
NORM_SHAPES = ((8192, 768), (8192, 1536))


#: K4's and K2's shapes on the Task Bench main path (chip_smoke.py's).
TB_W, TB_PAYLOAD, TB_GRAIN, TB_RADIUS, TB_S = 2112, 64, 64, 2, 8
K2_ITERATIONS, K2_SCRATCH = (1, 4, 16), 2048
SMS = 132
#: K1's and K3's cases: rows (widths) x payload TB_PAYLOAD, and grains (0:
#: the empty body); K3's combines as (label, combine, D).
K1_ROWS, K1_GRAINS = (132, 2112, 65536), (1, 64, 1024, 16384)
K3_WIDTHS, K3_GRAINS = (132, 2112), (64, 16384, 0)
K3_COMBINES = (("window D=3", "window", 3), ("window D=5", "window", 5),
               ("gather D=5", "gather", 5), ("onehot D=5 duplicates", "onehot", 5))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _bound(nbytes: float, t_ops_ms: float) -> Dict[str, object]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops_ms),
            "bound_by": "bytes" if t_bytes >= t_ops_ms else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops_ms}


def ssd_cost(BC: int, H: int, G: int, T: int, N: int, P: int,
             item: int) -> Tuple[int, int, int, int]:
    """(bytes, C B^T operations, Y operations, state operations) of one K7
    launch: x, B, C, dtA and dt read once, y and the state written once;
    C B^T once per (chunk, group) over the causal half, then per head the
    decay mask and Y's product over the causal half, and the state's
    product with its scalings."""
    tri = T * (T + 1) // 2
    nbytes = item * (2 * BC * H * T * P + 2 * BC * G * T * N) + 4 * (
        2 * BC * H * T + BC * H * N * P)
    cbt = 2 * BC * G * tri * N
    y = BC * H * (tri + 2 * tri * P + T * P)
    state = BC * H * (2 * T * N * P + T * N)
    return nbytes, cbt, y, state


def ssd_bound(shape, dtype) -> Dict[str, object]:
    """K7's bound at ``shape`` (BC, H, G, T, N, P): bytes against the
    operations at the rates of the units the kernel runs them on, C B^T at
    the f32 FMA peak and the head products on the TF32 tensor cores as the
    kernel splits them (an f32 product: 6 TF32 products in Y, 3 in the
    state; with a bf16 x, exact in TF32: 3 and 2); and beside it the bound
    of a kernel that runs everything at the f32 FMA peak."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes, cbt, y, state = ssd_cost(*shape, item)
    tf32_ops = (6 * y + 3 * state) if dtype == torch.float32 else (3 * y + 2 * state)
    rec = _bound(nbytes, (cbt / F32_FLOPS_PER_S + tf32_ops / TF32_FLOPS_PER_S) * 1e3)
    rec.update(bytes=nbytes, operations=cbt + y + state, tf32_operations=tf32_ops,
               f32_fma_bound_ms=max(rec["bytes_ms"],
                                    (cbt + y + state) / F32_FLOPS_PER_S * 1e3))
    return rec


def cbt_formations(shape, dtype) -> int:
    """How many times one K7 launch forms each (chunk, group)'s C B^T: the
    kernel's head blocks per group (``ssd_scan.cbt_per_chunk_group``)."""
    from repro_torch.kernels import ssd_scan

    return ssd_scan.cbt_per_chunk_group(*shape, dtype)


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(1, max |want|), the scale K7's and K8's
    checks hold to."""
    err = (got.double() - want.double()).abs().max().item()
    return err / max(1.0, want.double().abs().max().item())


def ssd_inputs(BC, H, G, T, N, P, dtype, seed: int = 1):
    """K7's inputs as chip_smoke.py draws them: normal x, B, C; dt in
    [0.001, 0.101); dtA = dt * A with A from -1 to -16 over the heads, and
    every 7th token's dtA = -35 (a decay that underflows)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*s):
        return torch.randn(s, device="cuda", generator=gen).to(dtype)

    x, b, c = normal(BC, H, T, P), normal(BC, G, T, N), normal(BC, G, T, N)
    dt = torch.rand((BC, H, T), device="cuda", generator=gen) * 0.1 + 0.001
    dta = dt * -torch.linspace(1.0, 16.0, H, device="cuda")[None, :, None]
    dta[:, :, ::7] = -35.0
    return x, b, c, dta, dt


def ssd_f64(x, b, c, dta, dt):
    """K7's function in f64 from the same a = cumsum(dtA) (in f32, token
    order, as the kernel and its plain version take it): the reference
    that both are measured against."""
    T = x.shape[2]
    ratio = x.shape[1] // b.shape[1]
    a = torch.empty_like(dta)
    run = torch.zeros_like(dta[..., 0])
    for t in range(T):
        run = run + dta[..., t]
        a[..., t] = run
    a = a.double()
    bh, ch = (v.repeat_interleave(ratio, 1).double() for v in (b, c))
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal, a[..., :, None] - a[..., None, :], float("-inf")))
    scores = torch.einsum("bhin,bhjn->bhij", ch, bh) * decay
    y = torch.einsum("bhij,bhjp->bhip", scores, x.double() * dt.double()[..., None])
    w = torch.exp(a[..., -1:] - a) * dt.double()
    return y, torch.einsum("bhtn,bhtp->bhnp", bh * w[..., None], x.double())


def ssd_case(shape, dtype=torch.float32, plain: bool = True, reps: int = 50):
    """K7 at ``shape`` (BC, H, G, T, N, P). Returns the record and the
    kernel's and plain version's (y, state) for the caller to check. With
    ``plain``, the record also holds the max and mean |error| / scale of
    the kernel's and the plain version's y and state against `ssd_f64`."""
    args = ssd_inputs(*shape, dtype)
    got, want = ops.ssd_chunk(*args), ref.ssd_chunk_plain(*args)
    rec = {"shape_BC_H_G_T_N_P": list(shape), "dtype": str(dtype).split(".")[-1],
           "ms": gpu_ms(lambda: ops.ssd_chunk(*args), reps),
           "cbt_per_chunk_group": cbt_formations(shape, dtype),
           "heads_per_group": shape[1] // shape[2],
           "scaled_err": max(scaled_err(got[0], want[0]), scaled_err(got[1], want[1]))}
    if plain:
        exact = ssd_f64(*args)
        for who, outs in (("kernel", got), ("plain", want)):
            for part, o, e in zip(("y", "state"), outs, exact):
                d = (o.double() - e).abs() / max(1.0, e.abs().max().item())
                rec[f"f64_err_{who}_{part}"] = [d.max().item(), d.mean().item()]
    # the plain version issues ~140 operations per call (its cumsum is a
    # loop over T): its time spans the host's enqueue gaps
    rec["plain_ms"] = (gpu_ms(lambda: ref.ssd_chunk_plain(*args), 3, cover=False)
                       if plain else None)
    rec.update(ssd_bound(shape, dtype))
    return rec, (got, want)


def rmsnorm_case(rows: int, d: int, dtype=torch.bfloat16, eps: float = 1e-5,
                 seed: int = 1, reps: int = 200):
    """K8 and ``rms_norm`` at (rows, d), warm and cold. Returns the record
    and the kernel's and plain version's outputs on the first input."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x0 = torch.randn((rows, d), device="cuda", generator=gen).to(dtype)
    w = torch.randn((d,), device="cuda", generator=gen).to(dtype)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    copies = 2 * l2 // (x0.numel() * x0.element_size()) + 1
    xs = [x0] + [torch.randn((rows, d), device="cuda", generator=gen).to(dtype)
                 for _ in range(copies - 1)]
    turn = itertools.count()

    def kern(x):
        return ops.rmsnorm(x, w, eps)

    def lib(x):
        return F.rms_norm(x, (d,), w, eps)

    def warm(fn):
        return lambda: fn(x0)

    def cold(fn):
        return lambda: fn(xs[next(turn) % copies])

    got, want = kern(x0), ref.rmsnorm_plain(x0, w, eps)
    item = x0.element_size()
    rec = {"shape": [rows, d], "dtype": str(dtype).split(".")[-1],
           "cold_copies": copies, "cold_bytes": copies * x0.numel() * item,
           "warm_ms": gpu_ms(warm(kern), reps), "cold_ms": gpu_ms(cold(kern), reps),
           "library_warm_ms": gpu_ms(warm(lib), reps),
           "library_cold_ms": gpu_ms(cold(lib), reps),
           "plain_ms": gpu_ms(lambda: ref.rmsnorm_plain(x0, w, eps), 50),
           "scaled_err": scaled_err(got, want)}
    rec.update(_bound(item * (2 * rows * d + d), 4 * rows * d / F32_FLOPS_PER_S * 1e3))
    return rec, (got, want)


def floor_case(reps: int = 500) -> Dict[str, object]:
    """The launch floor: one empty CTA of 32 threads a launch; and the FMA's
    dependent latency in cycles at the card's top SM clock."""
    stream = torch.cuda.current_stream().cuda_stream
    return {"ms": gpu_ms(lambda: _build.probe("launch_floor", 1, 32, stream), reps),
            "fma_latency_cycles": fma_latency_cycles(), "sm_max_mhz": sm_max_mhz()}


def fma_latency_cycles(n: int = 8192, tries: int = 5) -> float:
    """The dependent latency of the body's FMA, in SM cycles: the least
    over ``tries`` of (cycles of a 2n chain - cycles of an n chain) / n."""
    sink = torch.full((2,), 0.3, device="cuda")
    cycles = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    best = float("inf")
    for _ in range(tries):
        _build.probe("fma_latency", sink.data_ptr(), cycles.data_ptr(), n, stream)
        c0, c1 = cycles.tolist()
        best = min(best, (c1 - c0) / n)
    return best


def sm_max_mhz() -> float:
    """The card's top SM clock, from nvidia-smi."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def chain_bound(nbytes: float, nops: float, chain: int,
                latency: Tuple[float, float]) -> Dict[str, object]:
    """`_bound` (bytes or f32 operations) and the latency term beside it:
    ``chain`` dependent FMAs x ``latency`` = (cycles, SM MHz); the bound
    with the term is the largest of the three (``bound_with_latency_ms``,
    ``bound_with_latency_by``)."""
    rec = _bound(nbytes, nops / F32_FLOPS_PER_S * 1e3)
    cycles, mhz = latency
    lat_ms = chain * cycles / (mhz * 1e3)
    rec["latency_ms"] = lat_ms
    rec["bound_with_latency_ms"] = max(rec["bound_ms"], lat_ms)
    rec["bound_with_latency_by"] = ("latency" if lat_ms > rec["bound_ms"]
                                    else rec["bound_by"])
    return rec


def k1_case(rows: int, grain: int, latency, payload: int = TB_PAYLOAD,
            seed: int = 1, plain: bool = False) -> Dict[str, object]:
    """K1 at (rows, payload) and ``grain``, beside its bound; ``ctas``: the
    grid its wrapper launched."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((rows, payload), device="cuda", generator=gen) * 0.9 + 0.1
    n = rows * payload
    reps = 200 if n * grain < 2**28 else 20
    err = (ops.taskbench_compute(x, grain)
           - apply_body(x, "compute_bound", grain, 0)).abs().max().item()
    rec = {"shape": [rows, payload], "grain": grain,
           "ctas": _build.LAST_CTAS["taskbench_compute"],
           "ms": gpu_ms(lambda: ops.taskbench_compute(x, grain), reps),
           "plain_ms": gpu_ms(lambda: apply_body(x, "compute_bound", grain, 0), 4)
           if plain else None, "max_abs_err": err}
    rec.update(chain_bound(8 * n, 2 * n * grain, grain, latency))
    return rec


def k3_operands(W: int, combine: str, D: int, seed: int = 1):
    """(state (1, W, P), idx, wgt, H) of one S = 1 step at width W: the
    pattern's tables as ``pallas_step`` builds them (window D = 3:
    stencil_1d; D = 5: nearest at radius 2; gather: nearest's; onehot:
    nearest's with slot 1 set to slot 0 in every other row, duplicates the
    combine merges), addressing the W + 2H rows of the extended source."""
    from repro_torch.core import KernelSpec, TaskGraph
    from repro_torch.core.runtimes import pallas_step as ps

    pattern, H = ("stencil_1d", 1) if D == 3 else ("nearest", 2)
    g = TaskGraph(steps=2, width=W, pattern=pattern, payload=TB_PAYLOAD,
                  kernel=KernelSpec("compute_bound", 1), radius=H)
    if combine == "window":
        idx, wgt = ps._window_operands(g, H)
    else:
        idx, wgt = ps._ext_dep_operands(g, W, H)
        if combine == "onehot":
            idx[::2, 1] = idx[::2, 0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = torch.rand((1, W, TB_PAYLOAD), device="cuda", generator=gen) * 0.9 + 0.1
    idx, wgt = (torch.from_numpy(a)[None].cuda() for a in (idx, wgt))
    return state, idx, wgt, H


def k3_case(W: int, combine: str, D: int, grain: int, latency,
            step: bool = False, reps: int = 200) -> Dict[str, object]:
    """K3 at width W, payload TB_PAYLOAD, ``grain`` (0: the empty body): alone
    on the halo-extended source or, with ``step``, the S = 1 step as the
    runtime issues it (one launch on the W-row state, the halo wrap folded
    in), beside its bound; ``ctas``: the grid its wrapper launched."""
    state, idx, wgt, H = k3_operands(W, combine, D)
    ext = _k34.wrap_rows(state, H)
    P, n = TB_PAYLOAD, W * TB_PAYLOAD
    tables = wgt.numel() * (2 if combine != "window" else 1)
    kind = "compute_bound" if grain else "empty"
    kw = dict(kind=kind, iterations=grain, scratch=2048, combine=combine)
    alone = lambda: ops.taskbench_step(ext, idx, wgt, **kw)  # noqa: E731
    want = _k34.taskbench_step_plain(ext, idx, wgt, **kw)
    rec = {"W": W, "P": P, "combine": combine, "D": D, "grain": grain}
    fn, src_floats = alone, ext.numel()
    if step:
        fn = lambda: ops.taskbench_step(state, idx, wgt, wrap=H, **kw)  # noqa: E731
        src_floats = state.numel()
        rec.update(halo=H, equal_to_gather_then_k3=bool(torch.equal(fn(), alone())))
    rec["max_abs_err"] = (fn() - want).abs().max().item()
    rec["ctas"] = _build.LAST_CTAS["taskbench_step"]
    rec["ms"] = gpu_ms(fn, reps if grain < 16384 else 50)
    rec.update(chain_bound(4 * (src_floats + tables + n), n * (2 * D + 2 * grain),
                           D + grain, latency))
    return rec


def k3_cases(latency):
    """K3 alone at each width, combine and grain, and the S = 1 step as the
    runtime issues it at grain 64 and the empty body. Yields (label, record)."""
    for W, (label, combine, D) in itertools.product(K3_WIDTHS, K3_COMBINES):
        for grain in K3_GRAINS:
            tag = f"W={W} grain {grain or 'empty'}"
            yield f"K3 {label} {tag}", k3_case(W, combine, D, grain, latency)
            if grain != 16384:
                yield f"K3 S=1 step {label} {tag}", k3_case(W, combine, D, grain,
                                                            latency, step=True)


def k4_cost(rows: int, S: int, D: int = 2 * TB_RADIUS + 1,
            table_words: int = 0) -> Tuple[int, int]:
    """(bytes, f32 operations) of one K4 launch on a ``rows``-row buffer:
    src, weights (``table_words`` words of weights and indices, if given)
    and act read once, the buffer written once; per depth a D-tap combine
    and the grain's FMA chain per element."""
    return ((2 * rows * TB_PAYLOAD + (table_words or rows * D) + S) * 4,
            S * rows * TB_PAYLOAD * (2 * D + 2 * TB_GRAIN))


def k4_cases(reps: int = 200, seed: int = 1):
    """K4 at the blocked main path's shape, each form: the full buffer
    (2144 rows) at S = 2 and S = 8, and the pipelined phases at S = 8; the
    all-gather plan's launches in the resident and cooperative forms; the
    memory body in the cooperative form. Yields (label, record)."""
    from repro_torch.core import KernelSpec, TaskGraph
    from repro_torch.core.runtimes import pallas_step as ps

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, device="cuda", generator=gen) * 0.9 + 0.1

    g = TaskGraph(steps=1000, width=TB_W, pattern="nearest", payload=TB_PAYLOAD,
                  kernel=KernelSpec("compute_bound", TB_GRAIN), radius=TB_RADIUS)
    wb = torch.from_numpy(ps._window_operands(g, TB_RADIUS)[1])[None].cuda()
    depth = TB_S * TB_RADIUS
    M = TB_W + 2 * depth
    wext = _k34.wrap_rows(wb, depth)
    src = rand(1, M, TB_PAYLOAD)
    ph = ps._phase_tables(None, wb, depth, "window")
    state = rand(1, TB_W, TB_PAYLOAD)
    bl, br = rand(1, 3 * depth, TB_PAYLOAD), rand(1, 3 * depth, TB_PAYLOAD)
    kw = dict(kind="compute_bound", iterations=TB_GRAIN, scratch=2048, combine="window")
    for form in ("tiled", "resident", "cooperative"):
        fkw = dict(kw, radius=TB_RADIUS) if form == "tiled" else dict(kw, form=form)
        times = {}
        for S in (2, TB_S):
            act = torch.ones((1, S), device="cuda")
            call = (lambda a=act, S=S: ops.taskbench_step(
                src, None, wext, a, steps_per_launch=S, **fkw))
            err = (call() - _k34.taskbench_step_blocked_plain(src, None, wext, act, **kw)
                   ).abs().max().item()
            times[S] = gpu_ms(call, reps)
            nbytes, nops = k4_cost(M, S)
            yield f"K4 {form} full {M} rows S={S}", {
                "form": form, "rows": M, "S": S, "ms": times[S], "max_abs_err": err,
                **_bound(nbytes, nops / F32_FLOPS_PER_S * 1e3)}
        per_depth = (times[TB_S] - times[2]) / (TB_S - 2)
        yield f"K4 {form} per depth", {
            "form": form, "per_depth_ms": per_depth,
            "per_launch_besides_ms": times[2] - 2 * per_depth,
            "per_depth_bound_ms": M * TB_PAYLOAD * (4 * TB_RADIUS + 2 + 2 * TB_GRAIN)
            / F32_FLOPS_PER_S * 1e3}
        act = torch.ones((1, TB_S), device="cuda")
        bkw = dict(fkw, steps_per_launch=TB_S)
        for phase, fn, rows in (
                ("boundary", lambda: ops.taskbench_boundary(
                    bl, br, ph.i_bnd, ph.w_bnd, act, depth=depth, **bkw), 6 * depth),
                ("interior", lambda: ops.taskbench_interior(
                    state, ph.i_int, ph.w_int, act, depth=depth, **bkw), TB_W)):
            nbytes, nops = k4_cost(rows, TB_S)
            yield f"K4 {form} {phase} {rows} rows S={TB_S}", {
                "form": form, "rows": rows, "S": TB_S, "ms": gpu_ms(fn, reps),
                **_bound(nbytes, nops / F32_FLOPS_PER_S * 1e3)}
    yield from k4_plan_cases(rand, reps)
    # the memory body (the cooperative form's alone) at the memory_bound run
    Mm = TB_W + 2 * TB_S
    src, wm = rand(1, Mm, TB_PAYLOAD), rand(1, Mm, 3) / 3
    act = torch.ones((1, TB_S), device="cuda")
    mkw = dict(kind="memory_bound", iterations=4, scratch=K2_SCRATCH, combine="window")
    call = lambda: ops.taskbench_step(src, None, wm, act, steps_per_launch=TB_S, **mkw)  # noqa: E731
    err = (call() - _k34.taskbench_step_blocked_plain(src, None, wm, act, **mkw)
           ).abs().max().item()
    smem = TB_S * k2_smem_bytes(Mm, 4, K2_SCRATCH)
    rate = smem_bytes_per_s()
    yield f"K4 cooperative memory body {Mm} rows S={TB_S}", {
        "form": "cooperative", "rows": Mm, "S": TB_S, "iterations": 4,
        "scratch": K2_SCRATCH, "ms": gpu_ms(call, 50), "max_abs_err": err,
        "smem_bytes": smem, "smem_bound_ms": smem / rate * 1e3}


def k4_plan_cases(rand, reps: int = 200):
    """The blocked all-gather plan's K4 launches, grain 64, S = 8, in the
    resident and cooperative forms: fft's time-varying (1, S, W, 2) tables
    at W = 512 and 2048 and all_to_all's static (1, 512, 512) table.
    Yields (label, record)."""
    from repro_torch.core import KernelSpec, TaskGraph, get_runtime
    from repro_torch.core.runtimes import pallas_step as ps

    def graph(pattern, W):
        return TaskGraph(steps=1000, width=W, pattern=pattern, payload=TB_PAYLOAD,
                         kernel=KernelSpec("compute_bound", TB_GRAIN), seed=0)

    cases = []
    for W in (512, 2048):
        tables_at, key_of, _ = get_runtime("pallas_step")._global_table_fn(graph("fft", W))
        i, w, _ = ps._stack_tables(tables_at, key_of, [list(range(1, TB_S + 1))], "cuda")
        cases.append((f"fft time-varying M={W} D=2", W, 2, i, w))
    i, w = (torch.from_numpy(a[:1]).cuda()
            for a in ps._global_slot_operands(graph("all_to_all", 512)))
    cases.append(("all_to_all static M=512 D=512", 512, 512, i, w))
    act = torch.ones((1, TB_S), device="cuda")
    kw = dict(kind="compute_bound", iterations=TB_GRAIN, scratch=2048, combine="gather")
    for label, W, D, i, w in cases:
        src = rand(1, W, TB_PAYLOAD)
        want = _k34.taskbench_step_blocked_plain(src, i, w, act, **kw)
        nbytes, nops = k4_cost(W, TB_S, D, table_words=2 * w.numel())
        outs = {}
        for form in ("resident", "cooperative"):
            call = (lambda f=form: ops.taskbench_step(src, i, w, act, steps_per_launch=TB_S,
                                                      form=f, **kw))
            outs[form] = call()
            yield f"K4 {form} {label} S={TB_S}", {
                "form": form, "rows": W, "S": TB_S, "D": D,
                "max_abs_err": (outs[form] - want).abs().max().item(),
                "equal_to_resident": torch.equal(outs[form], outs["resident"]),
                "ms": gpu_ms(call, reps // 4),
                **_bound(nbytes, nops / F32_FLOPS_PER_S * 1e3)}


#: The step-wall cases: (label, pallas_step options)
STEP_SCHEDULES = (("S=1", {}), (f"S={TB_S}", {"steps_per_launch": TB_S}),
                  (f"S={TB_S},serial", {"steps_per_launch": TB_S, "pipeline": False}))


def step_wall_case(pattern: str, W: int, options: dict, grain: int = TB_GRAIN,
                   steps: int = 1000, reps: int = 5) -> Dict[str, object]:
    """A ``pallas_step`` run on the host clock, µs per step of each of
    ``reps`` runs (each ending in a synchronize, its input staged before):
    as the runtime runs it, one CUDA graph replay (``build``), and its eager
    loop (``_build_eager``), the two timed in turns."""
    from repro_torch.core import KernelSpec, TaskGraph, get_runtime
    from repro_torch.core.runtimes._capture import time_runs

    g = TaskGraph(steps=steps, width=W, pattern=pattern, payload=TB_PAYLOAD,
                  kernel=KernelSpec("compute_bound", grain), radius=2)
    rt = get_runtime("pallas_step", **options)
    x = rt._init(g, None)
    runs = {"graph": rt.build(g), "eager": rt._build_eager(g)}
    walls = {key: [] for key in runs}
    for _ in range(2):
        for key, run in runs.items():
            walls[key] += time_runs(run, x, reps=reps)
    rec = {"pattern": pattern, "W": W, "grain": grain, "steps": steps,
           "options": options, "dispatches_per_run": rt.dispatches_per_run(g),
           "capture_s": runs["graph"].capture_s, "graph_nodes": runs["graph"].nodes}
    for key, w in walls.items():
        rec[f"{key}_us_per_step"] = [t / steps * 1e6 for t in w]
        rec[f"{key}_best_us_per_step"] = min(w) / steps * 1e6
    return rec


def smem_bytes_per_s() -> float:
    """132 SMs x 128 B of shared memory per clock at the card's top SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    return SMS * 128 * mhz * 1e6


def k2_smem_bytes(rows: int, iterations: int, scratch: int) -> int:
    """Shared-memory bytes of one K2 launch: per row the tile-out writes
    ``scratch`` floats, each pass reads and writes them, the fold reads
    them back."""
    return rows * 4 * scratch * (2 * iterations + 2)


def k2_case(iterations: int, rows: int = TB_W, payload: int = TB_PAYLOAD,
            scratch: int = K2_SCRATCH, reps: int = 200, seed: int = 1,
            plain: bool = True) -> Dict[str, object]:
    """K2 at (rows, payload), beside its bytes-or-operations bound and its
    shared-memory bound."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((rows, payload), device="cuda", generator=gen) * 0.9 + 0.1
    got = ops.taskbench_memory(x, iterations, scratch)
    want = apply_body(x, "memory_bound", iterations, scratch)
    smem = k2_smem_bytes(rows, iterations, scratch)
    rate = smem_bytes_per_s()
    rec = {"shape": [rows, payload], "iterations": iterations, "scratch": scratch,
           "ms": gpu_ms(lambda: ops.taskbench_memory(x, iterations, scratch), reps),
           "plain_ms": gpu_ms(lambda: apply_body(x, "memory_bound", iterations, scratch),
                              4) if plain else None,
           "max_abs_err": (got - want).abs().max().item(),
           "smem_bytes": smem, "smem_bytes_per_s": rate,
           "smem_bound_ms": smem / rate * 1e3}
    rec.update(_bound(2 * rows * payload * 4,
                      rows * (scratch * (iterations + 1) + payload)
                      / F32_FLOPS_PER_S * 1e3))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="floor,k1,k3,k4,k2,k8,k7",
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    groups = []  # (kernel, thunk yielding (label, record)); run in this order
    floor = floor_case()
    latency = (floor["fma_latency_cycles"], floor["sm_max_mhz"])
    groups.append(("floor", lambda: [("launch floor", floor)]))
    groups.append(("k1", lambda: ((f"K1 {rows}x{TB_PAYLOAD} grain {grain}",
                                    k1_case(rows, grain, latency))
                                   for rows in K1_ROWS for grain in K1_GRAINS)))
    groups.append(("k3", lambda: k3_cases(latency)))
    groups.append(("step", lambda: ((f"{label} step wall {pattern} W={W}",
                                      step_wall_case(pattern, W, options))
                                     for pattern in ("stencil_1d", "nearest")
                                     for W in K3_WIDTHS
                                     for label, options in STEP_SCHEDULES)))
    groups.append(("k4", k4_cases))
    groups.append(("k2", lambda: ((f"K2 {TB_W}x{TB_PAYLOAD} iterations {it}",
                                    k2_case(it, plain=it == 4)) for it in K2_ITERATIONS)))
    groups.append(("k8", lambda: ((f"K8 {rows}x{d} bfloat16", rmsnorm_case(rows, d)[0])
                                  for rows, d in NORM_SHAPES)))
    groups.append(("k7", lambda: (
        (f"K7 {arch} {str(dtype).split('.')[-1]}",
         ssd_case(shape, dtype, plain=dtype == torch.float32)[0])
        for arch, shape in SSD_SHAPES.items()
        for dtype in (torch.float32, torch.bfloat16))))
    only = args.only.split(",")
    for kernel, cases in groups:
        if kernel not in only:
            continue
        for label, rec in cases():
            rec["card"] = smi
            print(json.dumps({label: rec}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
