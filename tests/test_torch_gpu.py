"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version, the pipelined phases and schedule against the serial
ones bit for bit, the runtimes on the card against the CPU plain path, and
the LM serving paths (K5, K6; K7 for the ssm and hybrid kinds) on the card
against the same weights on the CPU. K5 is counted per form: the bf16 form
on the tensor cores as ``flash_attention``, the f32 form as
``flash_attention_f32``; K6 is one launch per call. The runs as CUDA graphs:
every schedule's graph equal to its eager loop bit for bit, with its
launches counted per replay; two replays' outputs apart; a capture that
fails raises, and ``build`` never falls back to the eager loop; the decode
step's graph equal to the eager step. ``pallas_step``'s stride and
all-gather plans at small widths: each run's graph equal to its eager loop,
its replay's launches equal to ``dispatches_per_run`` (T K3, or 1 K3 and
ceil((T-1)/S) K4 in the resident form when blocked, the cooperative one
for the memory body), butterfly compute
runs equal to ``fused`` with the kernels bit for bit, the blocked
all-gather plan under masked tails. Ensembles: stacked and tuple ensembles
on both backends, each graph equal to its eager loop bit for bit and its
replay's launches equal to ``ensemble_dispatches_per_run``; a stacked
member equal to its own single-graph run bit for bit; the launch plans
equal to ``build_ensemble`` bit for bit, with ``_build.CAPTURES`` flat under
act edits and ``admit_fn``. The four rungs (``bsp``, ``bsp_scan``,
``overlap``, ``serialized``, with the kernels): each run equal to its eager
loop bit for bit, its K1/K2 launches the bodies it runs and nothing else,
its host calls ``host_calls_per_run``, its device kernels under
``torch.profiler`` ``dispatches_per_run``, its ensembles round-robin or one
graph. Row shards (D = 2, 4 shards of one card): each sharded run equal to
its eager loop bit for bit in three runs, launching D times a shard's
count, and within tolerance of the one-device run and the CPU plain path
at grain 1; the ensembles; ``overlap``'s transfers under compute (> 0 us;
0 with ``overlap=False`` at D = 2); K3 writing into ``out=``; the memory
body's cooperative K4 grids over shards; the halo probe; the stride and
all-gather plans' resident K4 launches over shards; the stride and
all-gather plans over shards (fft, tree, spread, all_to_all under each
transport, blocked too), each bit for bit its eager loop and its D = 1 run
(all_to_all's row mean within tolerance); the stride, gather and
gather-transport probes. Every test carries the ``gpu`` marker and skips
without a card.

Run on a machine with an NVIDIA card (the kernels build with nvcc at first
use):  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import _capture
from repro_torch.core.runtimes import pallas_step as ps
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import ENTRY as K5_FORM  # form per dtype
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import _grow_caches
from repro_torch.models.model import Model
from repro_torch.kernels.bodies import apply_body
from repro_torch.kernels import _build
from repro_torch.kernels.launch_plan import sm_count
from repro_torch.kernels.taskbench_compute import compute_plan
from repro_torch.kernels.taskbench_step import (
    step_plan,
    taskbench_step_blocked_plain,
    taskbench_step_plain,
)

pytestmark = pytest.mark.gpu

# K1: fmaf and multiply-then-add round alike (0.5*x is exact). K2/K3: sums
# in another order (the sweep's mean; the combine's fused multiply-adds).
TOL_K1 = 1e-6
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _rand(shape, seed, device):
    x = np.random.default_rng(seed).uniform(0.1, 1.0, shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("rows,payload", [(37, 13), (130, 64)])
@pytest.mark.parametrize("iterations", [0, 1, 16, 1024])
def test_fma_and_memory_kernels_match_plain(cuda, rows, payload, iterations):
    x = _rand((rows, payload), 0, cuda)
    got = ops.taskbench_compute(x, iterations)
    want = apply_body(x, "compute_bound", iterations, 0)
    assert (got - want).abs().max().item() <= TOL_K1
    got = ops.taskbench_memory(x, iterations, 200)
    want = apply_body(x, "memory_bound", iterations, 200)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("combine", ["window", "gather", "onehot", "pair"])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 16),
                                             ("memory_bound", 3), ("empty", 0)])
@pytest.mark.parametrize("K", [1, 3])
def test_step_kernel_matches_plain(cuda, combine, kind, iterations, K):
    W, D, P = 45, 3, 13
    rng = np.random.default_rng(1)
    S = 2 * W if combine == "pair" else W + D - 1
    src = _rand((K, S, P), 2, cuda)
    idx = torch.from_numpy(rng.integers(0, S, (K, W, D), dtype=np.int32)).to(cuda)
    idx[:, ::2, 1] = idx[:, ::2, 0]  # duplicate slots
    wgt = _rand((K, W, D), 3, cuda) / D
    kw = dict(kind=kind, iterations=iterations, scratch=40, combine=combine)
    before = ops.launch_counts()["taskbench_step"]
    got = ops.taskbench_step(src, idx, wgt, **kw)
    assert ops.launch_counts()["taskbench_step"] == before + 1
    want = taskbench_step_plain(src, idx, wgt, **kw)
    assert got.shape == (K, W, P)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("rows,payload,offset", [
    (132, 64, 0),    # 8448 elements over every SM: one chain a thread
    (37, 13, 0),     # one chain a thread, fewer threads than SMs
    (65537, 13, 0),  # 4 chains a thread, n % 4 != 0: the last thread's scalar tail
    (2112, 64, 1),   # 4 chains, x at a 4-byte offset: the scalar path throughout
    (5, 3, 0),       # fewer elements than one vector
])
@pytest.mark.parametrize("iterations", [0, 1, 16, 1024])
def test_fma_kernel_ragged_and_unaligned(cuda, rows, payload, offset, iterations):
    n = rows * payload
    x = _rand((n + offset,), rows + offset, cuda)[offset:].view(rows, payload)
    before = ops.launch_counts()["taskbench_compute"]
    got = ops.taskbench_compute(x, iterations)
    assert ops.launch_counts()["taskbench_compute"] == before + 1
    assert _build.LAST_CTAS["taskbench_compute"] == compute_plan(n, sm_count(0)).ctas
    want = apply_body(x, "compute_bound", iterations, 0)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL_K1


@pytest.mark.parametrize("combine", ["window", "gather", "onehot", "pair"])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 64),
                                             ("memory_bound", 3), ("empty", 0)])
@pytest.mark.parametrize("W,P", [(132, 64), (132, 13), (2112, 64), (5281, 13)])
@pytest.mark.parametrize("D", [5, 9])
def test_step_kernel_launch_shapes(cuda, combine, kind, iterations, W, P, D):
    """K3 at W = 132 (one task an SM; one column a thread, P = 64 and 13),
    and with 4 columns a thread on its 16-byte path (P = 64) and its scalar
    path (P = 13), each combine and body, with 5 slots and with 9 (onehot's
    merge from memory, past the 8 it keeps in registers), against the plain
    version; the recorded grid is the plan's (a warp per row for the memory
    body), a CTA or more an SM."""
    rng = np.random.default_rng(W + P)
    S = 2 * W if combine == "pair" else W + D - 1
    src = _rand((1, S, P), 6, cuda)
    idx = torch.from_numpy(rng.integers(0, S, (1, W, D), dtype=np.int32)).to(cuda)
    idx[:, ::2, 1] = idx[:, ::2, 0]  # duplicate slots
    wgt = _rand((1, W, D), 7, cuda) / D
    kw = dict(kind=kind, iterations=iterations, scratch=40, combine=combine)
    got = ops.taskbench_step(src, idx, wgt, **kw)
    ctas = _build.LAST_CTAS["taskbench_step"]
    assert ctas == (W if kind == "memory_bound" else step_plan(1, W, P, sm_count(0)).ctas)
    assert ctas >= sm_count(0)
    want = taskbench_step_plain(src, idx, wgt, **kw)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 16),
                                             ("memory_bound", 3), ("empty", 0)])
@pytest.mark.parametrize("W,H,P", [(40, 1, 64), (40, 2, 13), (3, 2, 64), (2, 2, 16),
                                   (1, 2, 8), (132, 2, 64)])
def test_folded_wrap_equals_row_gather_then_step(cuda, combine, kind, iterations, W, H, P):
    """K3 with ``wrap=H`` on the state equals K3 on the state's halo
    extension, bit for bit, with out-of-range gather and onehot indices on
    the extended length and W <= 2H (dependencies more than one ring away)."""
    K, D = 2, 2 * H + 1
    rng = np.random.default_rng(W * 10 + H)
    state = _rand((K, W, P), W + H, cuda)
    ext_rows = W + 2 * H
    idx = torch.from_numpy(rng.integers(-ext_rows - 2, ext_rows + 3, (K, W, D),
                                        dtype=np.int32)).to(cuda)
    idx[:, ::2, 1] = idx[:, ::2, 0]
    wgt = _rand((K, W, D), 8, cuda) / D
    kw = dict(kind=kind, iterations=iterations, scratch=40, combine=combine)
    rows = torch.from_numpy(ps._extend_rows(W, H)).to(cuda)
    ops.reset_launch_counts()
    folded = ops.taskbench_step(state, idx, wgt, wrap=H, **kw)
    assert ops.launch_counts()["taskbench_step"] == 1
    want = ops.taskbench_step(state.index_select(1, rows), idx, wgt, **kw)
    assert torch.equal(folded, want)
    plain = taskbench_step_plain(state, idx, wgt, wrap=H, **kw)
    assert (folded - plain).abs().max().item() <= TOL


def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="float32"):
        ops.taskbench_compute(torch.zeros(4, 4, dtype=torch.float64, device=cuda), 1)
    with pytest.raises(ValueError, match="float32"):
        ops.taskbench_memory(torch.zeros(4, 4, dtype=torch.int32, device=cuda), 1, 8)
    src = torch.zeros(1, 6, 4, device=cuda)
    with pytest.raises(ValueError, match="int32 idx"):
        ops.taskbench_step(src, torch.zeros(1, 4, 1, dtype=torch.int64, device=cuda),
                           torch.ones(1, 4, 1, device=cuda), combine="gather")


@pytest.mark.parametrize("pattern", ["stencil_1d", "nearest", "random_nearest", "trivial"])
def test_runtimes_on_card_match_cpu_plain_path(cuda, pattern):
    g = TaskGraph(steps=6, width=40, pattern=pattern, payload=16,
                  kernel=KernelSpec("compute_bound", 1), radius=3, seed=2)
    want = get_runtime("fused", device="cpu").execute(g)
    ops.reset_launch_counts()
    for combine in ("window", "gather", "onehot"):
        got = get_runtime("pallas_step", combine=combine).execute(g)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ops.launch_counts()["taskbench_step"] == 3 * g.steps
    got = get_runtime("fused", use_kernels=True).execute(g)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ops.launch_counts()["taskbench_compute"] == g.steps


def test_memory_bound_runtimes_on_card(cuda):
    g = TaskGraph(steps=4, width=33, pattern="stencil_1d", payload=8,
                  kernel=KernelSpec("memory_bound", 3, scratch=20))
    want = get_runtime("fused", device="cpu").execute(g)
    for rt in (get_runtime("pallas_step"), get_runtime("fused", use_kernels=True)):
        np.testing.assert_allclose(rt.execute(g), want, atol=1e-5)


def _blocked_operands(combine, K, S, M, D, time_varying, seed, device):
    """Random K4 operands: duplicate slots, out-of-range slots (which the
    index rule wraps, clamps or drops) and an act mask with a masked tail
    and one frozen member."""
    rng = np.random.default_rng(seed)
    src = _rand((K, M, 13), seed, device)
    shape = (K, S, M, D) if time_varying else (K, M, D)
    idx = rng.integers(-2, M + 2, shape, dtype=np.int32)
    idx[..., ::2, 1] = idx[..., ::2, 0]
    wgt = rng.uniform(0, 1, shape).astype(np.float32) / D
    act = np.ones((K, S), np.float32)
    act[:, S - 1] = 0.0  # the masked tail of a run's last launch
    act[K - 1] = 0.0     # a frozen member
    return (src, torch.from_numpy(idx).to(device), torch.from_numpy(wgt).to(device),
            torch.from_numpy(act).to(device))


@pytest.mark.parametrize("combine,time_varying", [
    ("window", False), ("gather", False), ("onehot", False),
    ("gather", True), ("onehot", True)])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 16),
                                             ("memory_bound", 3), ("empty", 0)])
@pytest.mark.parametrize("S", [2, 5])
def test_blocked_kernel_matches_plain(cuda, combine, time_varying, kind, iterations, S):
    K, M, D = 3, 70, 5 if combine == "window" else 3
    src, idx, wgt, act = _blocked_operands(combine, K, S, M, D, time_varying, S, cuda)
    kw = dict(kind=kind, iterations=iterations, scratch=40, combine=combine)
    # no radius: the resident form, the cooperative one for the memory body
    entry = "taskbench_blocked" if kind == "memory_bound" else "taskbench_blocked_resident"
    before = ops.launch_counts()[entry]
    got = ops.taskbench_step(src, idx, wgt, act, steps_per_launch=S, **kw)
    assert ops.launch_counts()[entry] == before + 1
    want = taskbench_step_blocked_plain(src, idx, wgt, act, **kw)
    assert got.shape == (K, M, 13)
    assert (got - want).abs().max().item() <= TOL
    assert torch.equal(got[K - 1], src[K - 1])  # the frozen member


@pytest.mark.parametrize("combine", ["gather", "onehot"])
def test_step_kernel_follows_the_index_rule(cuda, combine):
    """Out-of-range indices: gather wraps negatives once, then clamps;
    onehot drops the slot."""
    S, W = 6, 5
    src = _rand((1, S, 8), 4, cuda)
    idx = torch.tensor([[[-1, 0], [S, 1], [-S - 1, 2], [S + 3, -2], [-2, -2]]],
                       dtype=torch.int32, device=cuda)
    wgt = torch.full((1, W, 2), 0.5, device=cuda)
    kw = dict(kind="empty", iterations=0, combine=combine)
    got = ops.taskbench_step(src, idx, wgt, **kw)
    assert (got - taskbench_step_plain(src, idx, wgt, **kw)).abs().max().item() <= TOL
    s = src[0]
    if combine == "gather":
        want0 = (s[S - 1] + s[0]) * 0.5
    else:
        want0 = s[0] * 0.5
    assert (got[0, 0] - want0).abs().max().item() <= TOL


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 8), ("memory_bound", 2)])
def test_stitched_phases_equal_the_full_launch(cuda, combine, kind, iterations):
    g = TaskGraph(steps=9, width=40, pattern="random_nearest", payload=16,
                  kernel=KernelSpec(kind, iterations, scratch=40), radius=2, seed=1)
    rt = get_runtime("pallas_step", device=cuda, combine=combine)
    S, H = 3, 2
    depth = S * H
    idx, wgt, _, _ = (torch.from_numpy(a)[None].to(cuda)
                      for a in rt._blocked_operands(g, H))
    state = _rand((1, g.width, 16), 5, cuda)
    act = torch.ones((1, S), device=cuda)
    act[0, S - 1] = 0.0
    kw = dict(kind=kind, iterations=iterations, scratch=40, combine=combine,
              steps_per_launch=S)
    iext, wext = ps._extend_tables(idx, wgt, depth, combine, row_axis=1)
    ext = state.index_select(1, torch.from_numpy(ps._extend_rows(g.width, depth)).to(cuda))
    full = ops.taskbench_step(ext, iext, wext, act, **kw)[:, depth:depth + g.width]
    ph = ps._phase_tables(idx, wgt, depth, combine)
    hl, hr = ps._prologue_exchange(state, depth)
    for side in (None, torch.cuda.Stream()):
        stitched, _, _ = ps._pipelined_launch(state, hl, hr, act, ph, depth, kw, side)
        torch.cuda.synchronize()
        assert torch.equal(stitched, full)


@pytest.mark.parametrize("pattern", ["stencil_1d", "nearest", "random_nearest", "dom"])
@pytest.mark.parametrize("S", [2, 3, 8])
def test_pipelined_pallas_step_equals_serial_on_card(cuda, pattern, S):
    g = TaskGraph(steps=11, width=64, pattern=pattern, payload=16,
                  kernel=KernelSpec("compute_bound", 1), radius=2, seed=2)
    want = get_runtime("fused", device="cpu").execute(g)
    for combine in ("window", "gather", "onehot"):
        ops.reset_launch_counts()
        pipe = get_runtime("pallas_step", device=cuda, combine=combine,
                           steps_per_launch=S)
        got = pipe.execute(g)
        counts = ops.launch_counts()
        assert counts["taskbench_step"] + counts["taskbench_blocked_tiled"] == \
            pipe.dispatches_per_run(g)
        assert counts["taskbench_blocked"] == 0  # fixed tables: the tiled form
        serial = get_runtime("pallas_step", device=cuda, combine=combine,
                             steps_per_launch=S, pipeline=False).execute(g)
        assert np.array_equal(got, serial)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _reach_tables(combine, K, M, r, seed, device):
    """(idx, wgt) of reach <= r: a window of D = 2r + 1, or D = 3 gather /
    onehot slots at offsets in [-r, r] clamped into the buffer, every other
    row's first two slots equal."""
    rng = np.random.default_rng(seed)
    D = 2 * r + 1 if combine == "window" else 3
    wgt = torch.from_numpy(rng.uniform(0, 1, (K, M, D)).astype(np.float32) / D)
    if combine == "window":
        return None, wgt.to(device)
    off = rng.integers(-r, r + 1, (K, M, D))
    idx = np.clip(np.arange(M)[:, None] + off, 0, M - 1).astype(np.int32)
    idx[:, ::2, 1] = idx[:, ::2, 0]
    return torch.from_numpy(idx).to(device), wgt.to(device)


def _act(K, S, device):
    act = torch.ones((K, S), device=device)
    act[:, S - 1] = 0.0  # the masked tail
    act[K - 1] = 0.0     # a frozen member
    return act


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 16), ("empty", 0)])
@pytest.mark.parametrize("S", [2, 8])
@pytest.mark.parametrize("M,P", [(70, 13), (2144, 64), (301, 64)])
@pytest.mark.parametrize("tail", [False, True])
def test_tiled_blocked_kernel_equals_cooperative(cuda, combine, kind, iterations, S,
                                                 M, P, tail):
    """K4's tiled form, bit for bit the cooperative and resident forms (each
    pinned), and within TOL of the plain version, on buffers that are and
    are not a multiple of the tile, with every depth active (the whole halo
    read) or a masked tail and a frozen member."""
    K, r = 3, 2
    src = _rand((K, M, P), S + M, cuda)
    idx, wgt = _reach_tables(combine, K, M, r, S, cuda)
    act = _act(K, S, cuda) if tail else torch.ones((K, S), device=cuda)
    kw = dict(kind=kind, iterations=iterations, scratch=40, combine=combine,
              steps_per_launch=S)
    ops.reset_launch_counts()
    tiled = ops.taskbench_step(src, idx, wgt, act, radius=r, **kw)
    coop = ops.taskbench_step(src, idx, wgt, act, form="cooperative", **kw)
    resident = ops.taskbench_step(src, idx, wgt, act, form="resident", **kw)
    counts = ops.launch_counts()
    assert (counts["taskbench_blocked_tiled"], counts["taskbench_blocked"],
            counts["taskbench_blocked_resident"]) == (1, 1, 1)
    assert torch.equal(tiled, coop) and torch.equal(tiled, resident)
    kw.pop("steps_per_launch")
    want = taskbench_step_blocked_plain(src, idx, wgt, act, **kw)
    assert (tiled - want).abs().max().item() <= TOL
    if tail:
        assert torch.equal(tiled[K - 1], src[K - 1])  # the frozen member


def test_blocked_form_rule_and_its_counters(cuda):
    """The tiled form takes fixed tables with a declared radius and the
    compute or empty body; no radius and time-varying tables take the
    resident form, the memory body the cooperative form; a window wider
    than the radius is refused."""
    K, M, P, S, r = 2, 50, 16, 3, 2
    src = _rand((K, M, P), 7, cuda)
    act = torch.ones((K, S), device=cuda)
    idx, wgt = _reach_tables("gather", K, M, r, 7, cuda)
    tv_idx, tv_wgt = (t[:, None].expand(K, S, M, 3).contiguous() for t in (idx, wgt))
    base = dict(combine="gather", scratch=40, steps_per_launch=S)
    cases = [  # (operands, kind, iterations, radius, form)
        ((idx, wgt), "compute_bound", 4, r, "taskbench_blocked_tiled"),
        ((idx, wgt), "empty", 0, r, "taskbench_blocked_tiled"),
        ((idx, wgt), "compute_bound", 4, None, "taskbench_blocked_resident"),
        ((idx, wgt), "memory_bound", 2, r, "taskbench_blocked"),
        ((tv_idx, tv_wgt), "compute_bound", 4, r, "taskbench_blocked_resident"),
    ]
    for (i, w), kind, it, radius, form in cases:
        ops.reset_launch_counts()
        ops.taskbench_step(src, i, w, act, kind=kind, iterations=it, radius=radius,
                           **base)
        counts = ops.launch_counts()
        assert counts[form] == 1 and sum(counts.values()) == 1, (kind, radius, counts)
    _, wide = _reach_tables("window", K, M, r + 1, 7, cuda)
    with pytest.raises(ValueError, match="beyond radius"):
        ops.taskbench_step(src, None, wide, act, combine="window", steps_per_launch=S,
                           radius=r)


@pytest.mark.parametrize("combine", ["gather", "onehot"])
def test_tiled_kernel_reads_nan_past_the_declared_radius(cuda, combine):
    """A table that reaches farther than its declared radius gives NaN rows
    on the tiled form, not silently wrong ones."""
    K, M, P, S, r = 1, 60, 8, 2, 1
    src = _rand((K, M, P), 3, cuda)
    idx, wgt = _reach_tables(combine, K, M, r, 3, cuda)
    idx[0, 30, 0] = 30 + 4 * r  # one tap far past the radius
    act = torch.ones((K, S), device=cuda)
    out = ops.taskbench_step(src, idx, wgt, act, kind="compute_bound", iterations=1,
                             combine=combine, steps_per_launch=S, radius=r)
    assert ops.launch_counts()["taskbench_blocked_tiled"] >= 1
    assert bool(torch.isnan(out[0, 30]).all())


@pytest.mark.parametrize("rows,payload,scratch", [
    (2112, 64, 2048),  # the main path's: 16-byte passes, 2 lanes a payload word
    (50, 12, 2048),    # 16-byte passes, payload 3 words: 10 lanes a word
    (20, 160, 2048),   # 16-byte passes, payload 40 words (> 32 lanes)
    (30, 64, 100),     # 16-byte passes, a ragged last repeat
    (37, 13, 2048),    # the scalar path: payload not a multiple of 4
    (40, 64, 2046),    # the scalar path: scratch not a multiple of 4
])
@pytest.mark.parametrize("iterations", [0, 1, 16, 1024])
def test_memory_kernel_vector_and_scalar_paths(cuda, rows, payload, scratch, iterations):
    x = _rand((rows, payload), rows + payload, cuda)
    before = ops.launch_counts()["memory_bound"]
    got = ops.taskbench_memory(x, iterations, scratch)
    assert ops.launch_counts()["memory_bound"] == before + 1
    want = apply_body(x, "memory_bound", iterations, scratch)
    assert (got - want).abs().max().item() <= TOL


def test_memory_sweeps_at_a_scratch_of_one_row_a_cta(cuda):
    """K2, K3's and K4's memory modes at a scratch whose sweep (160 KB) fills
    a CTA's shared memory alone: each launches with one row a CTA."""
    scratch, P, W, K, S = 20000, 16, 12, 2, 2
    x = _rand((W, P), 11, cuda)
    assert (ops.taskbench_memory(x, 2, scratch)
            - apply_body(x, "memory_bound", 2, scratch)).abs().max().item() <= TOL
    src = _rand((K, W + 2, P), 12, cuda)
    wgt = _rand((K, W, 3), 13, cuda) / 3
    kw = dict(kind="memory_bound", iterations=2, scratch=scratch, combine="window")
    got = ops.taskbench_step(src, None, wgt, **kw)
    assert (got - taskbench_step_plain(src, None, wgt, **kw)).abs().max().item() <= TOL
    src, wgt = src[:, :W], wgt[:, :, :3]
    act = torch.ones((K, S), device=cuda)
    got = ops.taskbench_step(src, None, wgt, act, steps_per_launch=S, radius=1, **kw)
    want = taskbench_step_blocked_plain(src, None, wgt, act, **kw)
    assert (got - want).abs().max().item() <= TOL


# ------------------------------------------------------ attention (K5, K6)
#
# Tolerances, against the plain version on the same inputs. f32: the same
# sums in another order (online softmax by tiles against one dense
# softmax; the K6 query pre-scaled before the product), atol 2e-5 on
# outputs of magnitude ~1. bf16: both compute in f32 (those sums, 2e-5
# apart) and round once to bf16, so each output is held to 2e-5 plus one
# bf16 ulp of its own plain value, 2^(floor(log2 |want|) - 7).


def _attn_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = torch.full(want.shape, 2e-5, dtype=torch.float64, device=want.device)
    if want.dtype == torch.bfloat16:
        tol += torch.exp2(torch.floor(torch.log2(want.double().abs())) - 7)
    assert bool(((got.double() - want.double()).abs() <= tol).all())


def _normal(shape, seed, device, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5), (False, 70)])
@pytest.mark.parametrize("group,seq,D", [(1, 13, 16), (2, 100, 64), (4, 200, 128),
                                         (2, 65, 80), (1, 70, 256)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, window, group, seq, D):
    q = _normal((2, 2 * group, seq, D), 1, cuda, dtype)
    k, v = _normal((2, 2, seq, D), 2, cuda, dtype), _normal((2, 2, seq, D), 3, cuda, dtype)
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    after = ops.launch_counts()
    for form in K5_FORM.values():
        assert after[form] == before[form] + (form == K5_FORM[dtype])
    _attn_close(got, ref.attention_plain(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (130, 130, True, 0),    # neither a multiple of the 64-row or the key tile
    (200, 200, True, 64),   # the window edge on a tile edge
    (200, 200, True, 65),   # and one past it
    (97, 161, True, 33),    # Sq != Sk: rows past Sk see every key up to Sk
    (161, 97, True, 0),     # Sq > Sk: rows past Sk see all of k
    (70, 300, False, 0),    # no mask but the key length
    (300, 70, False, 130)])
def test_flash_tensor_core_form_at_served_widths(cuda, D, sq, sk, causal, window):
    """The bf16 form at every head dim a served config uses, with ragged
    lengths, causal and window edges and Sq != Sk."""
    q = _normal((2, 4, sq, D), D + sq, cuda, torch.bfloat16)
    k = _normal((2, 2, sk, D), D + sk + 1, cuda, torch.bfloat16)
    v = _normal((2, 2, sk, D), D + sk + 2, cuda, torch.bfloat16)
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_f32"] == before["flash_attention_f32"]
    _attn_close(got, ref.attention_plain(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(9, 40), (64, 200), (130, 129)])
def test_flash_kernel_with_other_query_and_key_lengths(cuda, dtype, sq, sk):
    q = _normal((1, 4, sq, 128), 4, cuda, dtype)
    k, v = _normal((1, 2, sk, 128), 5, cuda, dtype), _normal((1, 2, sk, 128), 6, cuda, dtype)
    for causal, window in ((True, 0), (False, 0), (True, 17)):
        _attn_close(ops.flash_attention(q, k, v, causal=causal, window=window, sm_scale=0.2),
                    ref.attention_plain(q, k, v, causal=causal, window=window, sm_scale=0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 3, 300])
@pytest.mark.parametrize("group,S,D", [(1, 24, 16), (2, 1088, 128), (4, 300, 80),
                                       (8, 700, 64), (2, 40, 256),
                                       (2, 50, 20), (5, 33, 6)])  # rows copied by element
def test_decode_kernel_matches_plain(cuda, dtype, window, group, S, D):
    """o, m and l at lengths 0, 1, S - 1, S and one past S."""
    B, Hkv = 5, 2
    q = _normal((B, Hkv * group, D), 7, cuda, dtype)
    kc, vc = _normal((B, Hkv, S, D), 8, cuda, dtype), _normal((B, Hkv, S, D), 9, cuda, dtype)
    lengths = torch.tensor([0, 1, S - 1, S, S + 1], dtype=torch.int32, device=cuda)
    before = ops.launch_counts()
    o, m, l = ops.decode_attention(q, kc, vc, lengths, window=window, return_stats=True)
    after = ops.launch_counts()
    assert after["decode_attention"] == before["decode_attention"] + 1
    assert sum(after.values()) == sum(before.values()) + 1  # one launch, no combine
    wo, wm, wl = ref.decode_attention_plain(q, kc, vc, lengths, window=window,
                                            return_stats=True)
    _attn_close(o, wo)
    torch.testing.assert_close(m, wm, rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(l, wl, rtol=1e-5, atol=2e-5)
    assert l[0].abs().max().item() == 0.0 and o[0].abs().max().item() == 0.0
    assert m[0].max().item() == np.float32(-1e30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,n_split", [(40, 1), (1088, 8)])
def test_decode_kernel_cluster_plan(cuda, dtype, S, n_split):
    """A cluster of one CTA (a short cache) and of eight (the serving
    cache), at the window's edges: lengths - window at 0, 1 and past S."""
    from repro_torch.kernels.decode_attention import split_plan

    B, Hkv, G, D = 3, 2, 2, 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk, n = split_plan(B, Hkv, S, sms)
    assert n == n_split and chunk * n >= S
    q = _normal((B, Hkv * G, D), 16, cuda, dtype)
    kc, vc = _normal((B, Hkv, S, D), 17, cuda, dtype), _normal((B, Hkv, S, D), 18, cuda, dtype)
    window = 30
    lengths = torch.tensor([window, window + 1, S + 1], dtype=torch.int32, device=cuda)
    for w in (0, window):
        o, m, l = ops.decode_attention(q, kc, vc, lengths, window=w, return_stats=True)
        wo, wm, wl = ref.decode_attention_plain(q, kc, vc, lengths, window=w,
                                                return_stats=True)
        _attn_close(o, wo)
        torch.testing.assert_close(m, wm, rtol=1e-5, atol=2e-5)
        torch.testing.assert_close(l, wl, rtol=1e-5, atol=2e-5)


def test_attention_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(1, 3, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.flash_attention(x, x[:, :2], x[:, :2])
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(*(torch.zeros(1, 2, 4, 24, device=cuda),) * 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(*(torch.zeros(1, 2, 4, 16, device=cuda, dtype=torch.float16),) * 3)
    c = torch.zeros(1, 1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="group"):
        ops.decode_attention(torch.zeros(1, 9, 16, device=cuda), c, c,
                             torch.ones(1, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b"])
def test_reduced_serving_on_card_matches_cpu_and_counts_launches(cuda, arch):
    """One prefill and 3 decode steps of the reduced model (f32) on the card
    through K5 and K6, against the same weights on the CPU plain path: K5
    (its f32 form) launches n_layers times, K6 n_layers times per step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    cpu = Model(cfg, device="cpu", seed=3)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))).long()
    ops.reset_launch_counts()
    lg, cc = card.prefill(prompts.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_f32"] == cfg.n_layers
    want, pc = cpu.prefill(prompts)
    torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
    cc, pc = _grow_caches(card, cc, 2, 16), _grow_caches(cpu, pc, 2, 16)
    lengths = torch.full((2,), 12, dtype=torch.int32)
    tok = want.argmax(-1)[:, None]
    ops.reset_launch_counts()
    for _ in range(3):
        lg, cc = card.decode_step(tok.to(cuda), lengths.to(cuda), cc)
        want, pc = cpu.decode_step(tok, lengths, pc)
        torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
        tok, lengths = want.argmax(-1)[:, None], lengths + 1
    counts = ops.launch_counts()
    assert counts["decode_attention"] == 3 * cfg.n_layers
    assert counts["flash_attention"] == counts["flash_attention_f32"] == 0


def test_attention_kernels_at_hymba_shape(cuda):
    """GQA group 5 (25 query over 5 KV heads), head dim 64, window 1024:
    K5 over a 1100-token prompt, K6 at lengths around the window (one
    cluster of 8 CTAs per (batch, KV head))."""
    for dtype in (torch.float32, torch.bfloat16):
        q = _normal((2, 25, 1100, 64), 10, cuda, dtype)
        k, v = _normal((2, 5, 1100, 64), 11, cuda, dtype), _normal((2, 5, 1100, 64), 12,
                                                                   cuda, dtype)
        _attn_close(ops.flash_attention(q, k, v, causal=True, window=1024),
                    ref.attention_plain(q, k, v, causal=True, window=1024))
        lengths = torch.tensor([0, 1, 1023, 1024, 1025, 1100], dtype=torch.int32,
                               device=cuda)
        q6 = _normal((6, 25, 64), 13, cuda, dtype)
        kc, vc = _normal((6, 5, 1100, 64), 14, cuda, dtype), _normal((6, 5, 1100, 64), 15,
                                                                     cuda, dtype)
        o, m, l = ops.decode_attention(q6, kc, vc, lengths, window=1024, return_stats=True)
        wo, wm, wl = ref.decode_attention_plain(q6, kc, vc, lengths, window=1024,
                                                return_stats=True)
        _attn_close(o, wo)
        torch.testing.assert_close(m, wm, rtol=1e-5, atol=2e-5)
        torch.testing.assert_close(l, wl, rtol=1e-5, atol=2e-5)


# ----------------------------------------------------------- SSD (K7), RMSNorm (K8)
#
# Tolerances, against the plain version on the same inputs. Both compute in
# f32 precision (K7's TF32 products with each f32 operand split into a TF32
# high part and residual, K8's f32 FMAs, against the plain version's
# einsums: the same sums in another order), so an output is held to 2e-5
# of the output's scale, max(1, max |plain|); a bf16 y is rounded once from
# those f32 sums, so it also gets one bf16 ulp of its own plain value.


def _scaled_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    tol = 2e-5 * max(1.0, want.double().abs().max().item())
    tol = torch.full(want.shape, tol, dtype=torch.float64, device=want.device)
    if want.dtype == torch.bfloat16:
        tol += torch.exp2(torch.floor(torch.log2(want.double().abs())) - 7)
    assert bool(((got.double() - want.double()).abs() <= tol).all())


def _ssd_inputs(BC, H, G, T, N, P, seed, device, dtype):
    rng = np.random.default_rng(seed)
    x, b, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
               for s in ((BC, H, T, P), (BC, G, T, N), (BC, G, T, N)))
    dt = rng.uniform(0.001, 0.1, (BC, H, T)).astype(np.float32)
    dta = dt * -rng.uniform(1.0, 16.0, (1, H, 1)).astype(np.float32)
    dta[:, :, ::7] = -35.0  # a decay that underflows: must stay finite
    return x, b, c, torch.from_numpy(dta).to(device), torch.from_numpy(dt).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BC,H,G,T,N,P", [
    (4, 24, 1, 128, 128, 64),  # mamba2-130m's chunk
    (2, 50, 1, 128, 16, 64),   # hymba-1.5b's: head blocks that do not divide H
    (3, 4, 2, 5, 8, 8),        # a 5-token prompt, two groups
    (2, 6, 2, 100, 16, 8),     # T not a multiple of the 16-row block
    (1, 2, 1, 17, 128, 64),
    (64, 24, 1, 128, 128, 64),  # mamba2's serving prefill: blocks of 12 heads
    (3, 12, 2, 128, 128, 64),  # two groups of 6 heads, N = 128
    (2, 6, 2, 100, 16, 12),    # P not a multiple of 8 (a multiple of 4)
    (2, 3, 1, 33, 20, 5)])     # odd P and N: the element-wise staging
def test_ssd_chunk_kernel_matches_plain(cuda, dtype, BC, H, G, T, N, P):
    args = _ssd_inputs(BC, H, G, T, N, P, T + N + G, cuda, dtype)
    before = ops.launch_counts()["ssd_chunk"]
    y, state = ops.ssd_chunk(*args)
    assert ops.launch_counts()["ssd_chunk"] == before + 1
    wy, ws = ref.ssd_chunk_plain(*args)
    assert y.dtype == dtype and state.dtype == torch.float32
    _scaled_close(y, wy)
    _scaled_close(state, ws)


def test_ssd_chunk_forms_cbt_once_per_head_block(cuda):
    """At the serving prefills' chunks the kernel forms each (chunk,
    group)'s C B^T fewer times than the group has heads."""
    from repro_torch.kernels.ssd_scan import cbt_per_chunk_group

    for shape in ((64, 24, 1, 128, 128, 64), (32, 50, 1, 128, 16, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            assert 1 <= cbt_per_chunk_group(*shape, dtype) < shape[1] // shape[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8192, 768), (37, 1000), (5, 33), (8192, 1536),
                                    (16, 8192)])  # 8192: wider than 16 vectors a lane
def test_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d):
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(cuda, dtype)
    for w_dtype in (torch.float32, torch.bfloat16):
        w = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(cuda, w_dtype)
        before = ops.launch_counts()["rmsnorm"]
        got = ops.rmsnorm(x, w, 1e-5)
        assert ops.launch_counts()["rmsnorm"] == before + 1
        _scaled_close(got, ref.rmsnorm_plain(x, w, 1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_takes_the_scalar_path_off_alignment(cuda, dtype):
    """A contiguous x whose data_ptr is not 16-byte aligned (a view one
    element into its storage) goes through the scalar path of the same
    launch and agrees with the plain version."""
    from repro_torch.kernels.rmsnorm import vector_width

    rows, d = 64, 768
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.standard_normal(rows * d + 1).astype(np.float32))
    x = base.to(cuda, dtype)[1:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    w = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(cuda)
    assert vector_width(x, w) == 1
    assert vector_width(x.clone(), w) == 16 // x.element_size()
    before = ops.launch_counts()["rmsnorm"]
    got = ops.rmsnorm(x, w, 1e-5)
    assert ops.launch_counts()["rmsnorm"] == before + 1
    _scaled_close(got, ref.rmsnorm_plain(x, w, 1e-5))


def test_ssd_and_rmsnorm_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(1, 3, 4, 8, device=cuda)
    b = torch.zeros(1, 2, 4, 8, device=cuda)
    d = torch.zeros(1, 3, 4, device=cuda)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd_chunk(x, b, b, d, d)
    with pytest.raises(ValueError, match="share"):
        ops.ssd_chunk(x, b[:, :1].bfloat16(), b[:, :1], d, d)
    with pytest.raises(RuntimeError, match="ssd_chunk failed to launch"):
        big = torch.zeros(1, 1, 512, 512, device=cuda)  # T = 512: beyond 8 row blocks
        ops.ssd_chunk(big, big, big, torch.zeros(1, 1, 512, device=cuda),
                      torch.zeros(1, 1, 512, device=cuda))
    with pytest.raises(RuntimeError, match="ssd_chunk failed to launch"):
        wide = torch.zeros(1, 1, 128, 128, device=cuda)  # P = 128: beyond 2 x 4 tiles
        b128 = torch.zeros(1, 1, 128, 16, device=cuda)
        ops.ssd_chunk(wide, b128, b128, torch.zeros(1, 1, 128, device=cuda),
                      torch.zeros(1, 1, 128, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.rmsnorm(torch.zeros(2, 4, device=cuda, dtype=torch.float16),
                    torch.ones(4, device=cuda))


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_reduced_ssm_serving_on_card_matches_cpu_and_counts_launches(cuda, arch):
    """One prefill (12 tokens, chunk 8: two chunks) and 3 decode steps of the
    reduced model (f32) on the card, against the same weights on the CPU
    plain path: K7 launches n_layers times in the prefill and never in
    decode; hymba also K5 n_layers times, and K6 per layer and step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    hybrid = arch == "hymba-1.5b"
    cpu = Model(cfg, device="cpu", seed=3)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))).long()
    ops.reset_launch_counts()
    lg, cc = card.prefill(prompts.to(cuda))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ssd_chunk"] == cfg.n_layers
    assert counts["flash_attention_f32"] == (cfg.n_layers if hybrid else 0)
    want, pc = cpu.prefill(prompts)
    torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
    cc, pc = _grow_caches(card, cc, 2, 16), _grow_caches(cpu, pc, 2, 16)
    lengths = torch.full((2,), 12, dtype=torch.int32)
    tok = want.argmax(-1)[:, None]
    ops.reset_launch_counts()
    for _ in range(3):
        lg, cc = card.decode_step(tok.to(cuda), lengths.to(cuda), cc)
        want, pc = cpu.decode_step(tok, lengths, pc)
        torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
        tok, lengths = want.argmax(-1)[:, None], lengths + 1
    counts = ops.launch_counts()
    assert counts["ssd_chunk"] == counts["flash_attention_f32"] == 0
    k6 = 3 * cfg.n_layers if hybrid else 0
    assert counts["decode_attention"] == k6


# ------------------------------------------------------------ CUDA graphs

GRAPH_SCHEDULES = [{}, {"steps_per_launch": 3}, {"steps_per_launch": 3, "pipeline": False}]


def _graph_vs_eager(rt, g, x):
    """``rt``'s run of ``g`` on ``x`` as a graph replay (its launches
    counted) and as its eager loop."""
    run = rt.build(g)
    assert isinstance(run, _capture.GraphRun)
    ops.reset_launch_counts()
    got = run(x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = run.eager(x.clone())
    torch.cuda.synchronize()
    return got, want, counts


@pytest.mark.parametrize("pattern", ["stencil_1d", "nearest", "random_nearest", "dom"])
@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("opts", GRAPH_SCHEDULES, ids=["S1", "S3", "S3serial"])
def test_pallas_step_graph_equals_its_eager_loop(cuda, pattern, combine, opts):
    g = TaskGraph(steps=11, width=64, pattern=pattern, payload=16,
                  kernel=KernelSpec("compute_bound", 4), radius=2, seed=2)
    rt = get_runtime("pallas_step", device=cuda, combine=combine, **opts)
    got, want, counts = _graph_vs_eager(rt, g, _rand((64, 16), 6, cuda))
    assert torch.equal(got, want)
    assert sum(counts.values()) == rt.dispatches_per_run(g)


@pytest.mark.parametrize("kind,iterations", [("compute_bound", 4), ("memory_bound", 2),
                                             ("empty", 0)])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_fused_graph_equals_its_eager_loop(cuda, kind, iterations, use_kernels):
    g = TaskGraph(steps=7, width=40, pattern="nearest", payload=16,
                  kernel=KernelSpec(kind, iterations, scratch=40), radius=2)
    rt = get_runtime("fused", device=cuda, use_kernels=use_kernels)
    got, want, counts = _graph_vs_eager(rt, g, _rand((40, 16), 7, cuda))
    assert torch.equal(got, want)
    body = {"compute_bound": "taskbench_compute", "memory_bound": "memory_bound"}
    launched = g.steps if use_kernels and kind in body else 0
    assert sum(counts.values()) == launched


@pytest.mark.parametrize("opts", GRAPH_SCHEDULES[1:], ids=["pipelined", "serial"])
def test_memory_bound_blocked_graph_takes_the_cooperative_form(cuda, opts):
    """K4's cooperative launch (the memory body) inside a captured graph."""
    g = TaskGraph(steps=9, width=64, pattern="stencil_1d", payload=16,
                  kernel=KernelSpec("memory_bound", 2, scratch=40))
    rt = get_runtime("pallas_step", device=cuda, **opts)
    got, want, counts = _graph_vs_eager(rt, g, _rand((64, 16), 8, cuda))
    assert torch.equal(got, want)
    assert counts["taskbench_blocked"] > 0 and counts["taskbench_blocked_tiled"] == 0
    assert sum(counts.values()) == rt.dispatches_per_run(g)


# The stride and all-gather plans: (pattern, W, options). fft and tree at
# S = 1 with each combine, an explicit S that re-routes (W under the cap)
# and one that stays per step (over it); spread and all_to_all per step and
# blocked, all_to_all with and without the row mean; W = 1 fft.
PLAN_CASES = [
    ("fft", 64, {}), ("tree", 64, {}), ("fft", 64, {"combine": "gather"}),
    ("tree", 64, {"combine": "onehot"}), ("fft", 16, {"steps_per_launch": 3}),
    ("tree", 16, {"steps_per_launch": 3}),
    ("fft", 64, {"steps_per_launch": 3, "gather_width_cap": 32}),
    ("spread", 24, {}), ("spread", 24, {"steps_per_launch": 3}),
    ("all_to_all", 24, {}), ("all_to_all", 24, {"psum_mean": False}),
    ("all_to_all", 24, {"steps_per_launch": 3}), ("fft", 1, {}),
]


def _plan_run(cuda, pattern, width, opts, kind, iterations, steps, seed):
    """One plan's run of a small graph: graph against eager loop, and the
    launches of the replay against `dispatches_per_run` and the plan's
    kernels (1 K3 + L K4 for the blocked all-gather plan, else T K3)."""
    g = TaskGraph(steps=steps, width=width, pattern=pattern, payload=16,
                  kernel=KernelSpec(kind, iterations, scratch=40), seed=seed)
    rt = get_runtime("pallas_step", device=cuda, **opts)
    x = _rand((width, 16), seed, cuda)
    got, want, counts = _graph_vs_eager(rt, g, x)
    assert torch.equal(got, want)
    assert sum(counts.values()) == rt.dispatches_per_run(g)
    plan = rt._schedule_for_graph(g)
    want_counts = dict.fromkeys(counts, 0)
    if plan.kind == ps.PLAN_ALLGATHER and plan.steps_per_launch > 1:
        want_counts["taskbench_step"] = 1
        memory = kind == "memory_bound" and iterations > 0
        form = "taskbench_blocked" if memory else "taskbench_blocked_resident"
        want_counts[form] = -(-(steps - 1) // plan.steps_per_launch)
    else:
        want_counts["taskbench_step"] = steps
    assert counts == want_counts
    fused = get_runtime("fused", device=cuda, use_kernels=True).build(g)(x)
    torch.cuda.synchronize()
    return g, got, fused


@pytest.mark.parametrize("pattern,width,opts", PLAN_CASES)
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 4), ("memory_bound", 2)])
def test_plan_graph_equals_its_eager_loop(cuda, pattern, width, opts, kind, iterations):
    """Butterfly compute runs equal ``fused[kernels]`` bit for bit (every
    plan and combine); the rest within TOL."""
    g, got, fused = _plan_run(cuda, pattern, width, opts, kind, iterations, 11, 3)
    if pattern in ("fft", "tree") and kind == "compute_bound":
        assert torch.equal(got, fused)
    else:
        assert (got - fused).abs().max().item() <= TOL


@pytest.mark.parametrize("pattern", ["fft", "tree", "spread", "all_to_all"])
@pytest.mark.parametrize("S", [3, 8])
def test_blocked_allgather_masked_tails_equal_the_eager_loop(cuda, pattern, S):
    """T = 7: S = 3 ends on a launch with one masked depth; S = 8 clamps to
    one launch of 6 depths."""
    width = 16 if pattern in ("fft", "tree") else 12
    g, got, fused = _plan_run(cuda, pattern, width, {"steps_per_launch": S},
                              "compute_bound", 1, 7, 4)
    if pattern in ("fft", "tree"):
        assert torch.equal(got, fused)
    else:
        assert (got - fused).abs().max().item() <= TOL


def test_two_replays_do_not_alias(cuda):
    g = TaskGraph(steps=5, width=40, pattern="stencil_1d", payload=16,
                  kernel=KernelSpec("compute_bound", 2))
    run = get_runtime("pallas_step", device=cuda).build(g)
    x, y = _rand((40, 16), 9, cuda), _rand((40, 16), 10, cuda)
    a = run(x)
    b = run(y)
    torch.cuda.synchronize()
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, run.eager(x)) and torch.equal(b, run.eager(y))
    assert not torch.equal(a, b)


def test_a_failed_capture_raises(cuda):
    x = torch.ones(4, device=cuda)
    with pytest.raises(Exception, match="capture"):
        _capture.Graphed(lambda: x.sum().item(), torch.cuda.Stream())
    torch.cuda.synchronize()
    assert (x * 2).sum().item() == 8.0  # the card still runs


def test_build_on_the_card_never_falls_back_to_the_eager_loop(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(_capture, "Graphed", refuse)
    g = TaskGraph(steps=3, width=8, pattern="stencil_1d", payload=4,
                  kernel=KernelSpec("compute_bound", 1))
    for rt in (get_runtime("pallas_step", device=cuda), get_runtime("fused", device=cuda)):
        with pytest.raises(RuntimeError, match="capture refused"):
            rt.build(g)
        with pytest.raises(RuntimeError, match="capture refused"):
            rt.execute(g)


def _served_config(arch):
    """The reduced config of ``arch``; ``+kv_quant`` adds the int8 cache."""
    name, _, opt = arch.partition("+")
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, kv_quant=True) if opt == "kv_quant" else cfg


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m", "hymba-1.5b",
                                  "granite-moe-3b-a800m", "mixtral-8x7b",
                                  "llama-3.2-vision-90b", "musicgen-medium",
                                  "internlm2-1.8b+kv_quant"])
@pytest.mark.parametrize("greedy", [True, False])
def test_decode_graph_equals_the_eager_step(cuda, arch, greedy):
    """The reduced model served with each decode step a graph replay and
    with every step eager: the same tokens and logits (the MoE's routing,
    musicgen's per-step embedding draw and the int8 cache's writes inside
    the graph); K6 launches once per attention layer (cross-attention
    included) and step either way."""
    cfg = _served_config(arch)
    runs = {}
    for graph in (True, False):
        ops.reset_launch_counts()
        runs[graph] = serve_mod.serve(cfg, batch=2, prompt_len=12, gen=7, greedy=greedy,
                                      verbose=False, graph=graph, keep_logits=True)
        runs[graph].counts = ops.launch_counts()
    a, b = runs[True], runs[False]
    assert a.capture_s is not None and a.graph_nodes > 0 and b.capture_s is None
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert torch.equal(a.logits, b.logits)
    assert a.counts == b.counts and a.healthy
    attn = sum(k != "ssm" for k in cfg.layer_plan_flat())
    assert a.counts["decode_attention"] == 6 * attn


def test_moe_decode_captures_as_one_graph(cuda):
    """granite-moe's MoE layer in decode mode (routing, capacity slots, the
    overflow row, the combine) captured and replayed: equal to the eager
    call bit for bit, on fresh inputs staged into the static buffer."""
    from repro_torch.models import moe

    cfg = get_config("granite-moe-3b-a800m").reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.float32, cuda)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe.moe_fwd(p, x, cfg, mode="decode")  # warm-up
        graphed = _capture.Graphed(lambda: moe.moe_fwd(p, x, cfg, mode="decode"), stream)
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (1, 2):
        x.copy_(torch.randn(x.shape, generator=gen, device=cuda))
        out, aux = graphed.replay()
        torch.cuda.synchronize()
        want, want_aux = moe.moe_fwd(p, x, cfg, mode="decode")
        assert torch.equal(out, want) and torch.equal(aux, want_aux)
    graphed.close()


def test_step_embeddings_replay_the_eager_draws(cuda):
    """musicgen's per-step embedding draw with its generator registered
    with the graph: the replays draw what eager calls on a fresh generator
    of the same seed draw, bit for bit, and a fresh tensor each step."""
    cfg = get_config("musicgen-medium").reduced()
    gen = torch.Generator(device=cuda).manual_seed(3)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        first = serve_mod.step_embeds(cfg, 4, gen, cuda).clone()  # step 0, eager
        graphed = _capture.Graphed(lambda: serve_mod.step_embeds(cfg, 4, gen, cuda),
                                   stream, (gen,))
        got = [first] + [graphed.replay().clone() for _ in range(3)]
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graphed.close()
    again = torch.Generator(device=cuda).manual_seed(3)
    want = [serve_mod.step_embeds(cfg, 4, again, cuda) for _ in range(4)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[1], got[2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_non_causal_cross_attention_shape(cuda, dtype):
    """K5 non-causal at Sq 1024 over Sk 1600 image keys, group 8, head dim
    128 (llama-3.2-vision's cross-attention, two batch rows)."""
    q = _normal((2, 64, 1024, 128), 11, cuda, dtype)
    k, v = _normal((2, 8, 1600, 128), 12, cuda, dtype), _normal((2, 8, 1600, 128), 13, cuda, dtype)
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, causal=False)
    assert ops.launch_counts()[K5_FORM[dtype]] == before[K5_FORM[dtype]] + 1
    _attn_close(got, ref.attention_plain(q, k, v, causal=False))


# -------------------------------------------------------------- ensembles


def _ensemble(specs):
    """GraphEnsemble of (steps, width, pattern, kind, iterations) members,
    radius 2, payload 16, seed k."""
    return GraphEnsemble([
        TaskGraph(steps=t, width=w, pattern=p, payload=16, radius=2, seed=k,
                  kernel=KernelSpec(kind, it, scratch=40))
        for k, (t, w, p, kind, it) in enumerate(specs)])


# grain 1 and 2, so that the dataflow shows over 11 steps (the FMA body
# halves a difference each iteration)
STACKED = [(11, 64, "stencil_1d", "compute_bound", 1), (8, 64, "stencil_1d", "compute_bound", 1),
           (1, 64, "stencil_1d", "compute_bound", 1), (11, 64, "nearest", "compute_bound", 1)]
TUPLE = [(11, 64, "stencil_1d", "compute_bound", 1), (7, 48, "nearest", "compute_bound", 2),
         (11, 64, "no_comm", "memory_bound", 2)]
PLANS = [(11, 64, "stencil_1d", "compute_bound", 1), (9, 32, "fft", "compute_bound", 1),
         (11, 24, "spread", "compute_bound", 2), (5, 24, "all_to_all", "compute_bound", 1)]
ENSEMBLE_CASES = [("stacked", STACKED, {}), ("stacked", STACKED, {"steps_per_launch": 3}),
                  ("stacked", STACKED, {"steps_per_launch": 3, "pipeline": False}),
                  ("stacked", STACKED, {"combine": "onehot"}),
                  ("tuple", TUPLE, {}), ("tuple", TUPLE, {"steps_per_launch": 3}),
                  ("tuple", PLANS, {"steps_per_launch": 3})]


def _ensemble_vs_eager(rt, ens, seed):
    """``rt``'s run of ``ens`` as one graph replay (its launches counted)
    and as its eager loop, on the same inits."""
    run = rt.build_ensemble(ens)
    assert isinstance(run, _capture.GraphRun)
    xs = tuple(_rand((g.width, g.payload), seed + k, rt.device)
               for k, g in enumerate(ens.members))
    ops.reset_launch_counts()
    got = run(xs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = run.eager(tuple(x.clone() for x in xs))
    torch.cuda.synchronize()
    assert len(got) == len(want) == len(ens)
    return xs, got, want, counts


@pytest.mark.parametrize("kind,specs,opts", ENSEMBLE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ENSEMBLE_CASES)])
def test_ensemble_graph_equals_its_eager_loop(cuda, kind, specs, opts):
    ens = _ensemble(specs)
    rt = get_runtime("pallas_step", device=cuda, **opts)
    assert rt._is_stacked(ens) == (kind == "stacked")
    _, got, want, counts = _ensemble_vs_eager(rt, ens, 11)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(counts.values()) == rt.ensemble_dispatches_per_run(ens)
    if kind == "stacked" and "steps_per_launch" not in opts:
        assert counts["taskbench_step"] == ens.steps  # one K3 a step for all K


@pytest.mark.parametrize("specs", [STACKED, TUPLE, PLANS], ids=["stacked", "tuple", "plans"])
def test_fused_ensemble_graph_equals_its_eager_loop(cuda, specs):
    """``fused(use_kernels=True)``: one body launch a step over all K*W
    rows of a stacked uniform ensemble, one per member a step otherwise;
    held to pallas_step within TOL (memory_bound, whose sums in another
    order add up over the steps: TOL a step)."""
    ens = _ensemble(specs)
    rt = get_runtime("fused", device=cuda, use_kernels=True)
    xs, got, want, counts = _ensemble_vs_eager(rt, ens, 12)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    uniform = rt._is_stacked(ens) and len({g.kernel for g in ens.members}) == 1
    bodies = ens.steps if uniform else ens.steps * len(ens)
    assert sum(counts.values()) == bodies
    ps_out = get_runtime("pallas_step", device=cuda).build_ensemble(ens)(xs)
    for g, a, b in zip(ens.members, got, ps_out):
        tol = TOL * g.steps if g.kernel.kind == "memory_bound" else TOL
        assert (a - b).abs().max().item() <= tol


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("opts", GRAPH_SCHEDULES, ids=["S1", "S3", "S3serial"])
def test_stacked_member_equals_its_own_run(cuda, combine, opts):
    """K3 and K4 compute each output element in one thread with the same
    arithmetic at every K: each stacked member equals its single-graph
    run bit for bit (a radius-1 member read through the radius-2 window
    too)."""
    ens = _ensemble(STACKED)
    rt = get_runtime("pallas_step", device=cuda, combine=combine, **opts)
    xs = tuple(_rand((64, 16), 20 + k, cuda) for k in range(len(ens)))
    outs = rt.build_ensemble(ens)(xs)
    for g, x, out in zip(ens.members, xs, outs):
        assert torch.equal(out, rt.build(g)(x)), g.describe()


@pytest.mark.parametrize("specs,opts", [(STACKED, {}), (STACKED, {"steps_per_launch": 3}),
                                        (PLANS, {})], ids=["stacked-S1", "stacked-S3", "stepwise"])
def test_launch_plan_equals_build_and_captures_nothing_under_churn(cuda, specs, opts):
    """Stepped on the host, the plan equals ``build_ensemble`` bit for bit;
    evicting member 0 from launch 2 and admitting a fresh member into the
    finished slot 2 capture nothing (``_build.CAPTURES`` flat)."""
    ens = _ensemble(specs)
    rt = get_runtime("pallas_step", device=cuda, **opts)
    lp = rt.build_ensemble_launches(ens)
    xs = tuple(_rand((g.width, g.payload), 30 + k, cuda) for k, g in enumerate(ens.members))

    def step(acts, admit=None):
        carry = lp.init_fn(xs)
        for l in range(lp.num_launches):
            if admit is not None and l == admit[0]:
                carry = lp.admit_fn(carry, admit[1], admit[2])
            carry = lp.launch_fn(carry, acts[l], lp.launch_t0(l))
        return lp.finalize(carry)

    outs = step(lp.acts)
    want = rt.build_ensemble(ens)(xs)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    before = lp.compile_counter()
    acts = lp.acts.copy()
    acts[2:, 0, :] = 0
    fresh = _rand((ens.members[2].width, 16), 40, cuda)
    churned = step(acts, admit=(1, 2, fresh))
    torch.cuda.synchronize()
    assert lp.compile_counter() == before == _build.CAPTURES["graphs"]
    assert not torch.equal(churned[0], outs[0])
    assert torch.equal(churned[1], outs[1])


@pytest.fixture(scope="module")
def card_model():
    """The cost model measured on the card once for this module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    from repro_torch.kernels import probes

    return probes.run_probes()


def test_run_probes_measures_the_card(card_model):
    """A measured one-device model: K3's node cost, a row-step slope above
    its floor (measured, not floored), the self-wrap exchange free, X = 1."""
    from repro_torch.kernels import probes

    m = card_model
    assert (m.source, m.devices, m.payload) == ("measured", 1, 64)
    assert m.platform == torch.cuda.get_device_name(0)
    assert m.launch_us > 0 and m.row_step_us > probes.row_step_floor_us(64)
    assert m.halo_exchange_us == {probes.SELF_EXCHANGE: 0.0} and m.exchange_row_steps == 1.0


@pytest.mark.parametrize("pattern", ["stencil_1d", "nearest"])
def test_auto_main_path_run_equals_its_explicit_twin(card_model, pattern):
    """"auto" at the main path's shape resolves serial S = 16 under the
    card's model, equals the explicit serial S = 16 run bit for bit, and a
    replay launches dispatches_per_run (1 K3 + 63 tiled K4)."""
    g = TaskGraph(steps=1000, width=2112, pattern=pattern, payload=64,
                  kernel=KernelSpec("compute_bound", 64), radius=2, seed=0)
    rt = get_runtime("pallas_step", steps_per_launch="auto", cost_model=card_model)
    plan = rt._schedule_for_graph(g)
    H = ps._patterns.halo_radius(g)
    assert plan[:2] == ("halo", 16) and not rt._pipeline_active(2112, 16, H, 64)
    twin = get_runtime("pallas_step", steps_per_launch=16, pipeline=False)
    x = _rand((2112, 64), 50, torch.device("cuda"))
    run = rt.build(g)
    before = dict(_build.LAUNCHES)
    out = run(x)
    torch.cuda.synchronize()
    d = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items() if n != before.get(k, 0)}
    assert d == {"taskbench_step": 1, "taskbench_blocked_tiled": 63} \
        and sum(d.values()) == rt.dispatches_per_run(g)
    assert torch.equal(out, twin.build(g)(x))


# ------------------------------------------------------------ the four rungs

RUNG_CASES = [("bsp", {}), ("bsp", {"donate": False}), ("bsp_scan", {}), ("overlap", {}),
              ("overlap", {"overlap": False}), ("overlap", {"halo_via": "allgather"}),
              ("serialized", {})]
RUNG_IDS = [f"{b}-{'-'.join(f'{k}={v}' for k, v in o.items()) or 'default'}"
            for b, o in RUNG_CASES]


def _rung_vs_eager(rt, work, xs):
    """``rt``'s run of ``work`` (a graph or an ensemble) on the card, its
    launches and host calls counted, and its eager loop on the same
    inputs (for serialized, whose run is eager, a second run)."""
    ensemble = isinstance(work, GraphEnsemble)
    run = rt.build_ensemble(work) if ensemble else rt.build(work)
    form = {"bsp": _capture.ReplayLoop, "bsp_scan": _capture.GraphRun,
            "overlap": _capture.GraphRun}.get(rt.name)
    assert isinstance(run, form) if form else not isinstance(
        run, (_capture.GraphRun, _capture.ReplayLoop))
    ops.reset_launch_counts()
    got = run(xs)
    torch.cuda.synchronize()
    counts, calls = ops.launch_counts(), ops.host_calls()
    eager = getattr(run, "eager", run)
    want = eager(tuple(x.clone() for x in xs) if ensemble else xs.clone())
    torch.cuda.synchronize()
    return got, want, counts, calls


@pytest.mark.parametrize("pattern", ["stencil_1d", "nearest", "random_nearest", "dom",
                                     "fft", "spread", "all_to_all", "trivial"])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 1), ("memory_bound", 2),
                                             ("empty", 0)])
@pytest.mark.parametrize("backend,opts", RUNG_CASES, ids=RUNG_IDS)
def test_rung_run_equals_its_eager_loop(cuda, backend, opts, kind, iterations, pattern):
    """Each rung's run on the card (bsp: a graph per superstep replayed from
    the host; bsp_scan, overlap: one graph; serialized: eager) equals its
    eager loop bit for bit, launches its bodies as K1/K2 and nothing else,
    makes ``host_calls_per_run`` host calls, and agrees with the CPU plain
    path (grain 1: at larger grains every state nears the FMA's fixed point
    0.2 within T = 7, and the dataflow no longer shows)."""
    g = TaskGraph(steps=7, width=32, pattern=pattern, payload=16,
                  kernel=KernelSpec(kind, iterations, scratch=40), radius=2, seed=4)
    rt = get_runtime(backend, device=cuda, use_kernels=True, **opts)
    if not rt.supports(g)[0]:
        assert backend == "overlap"
        return
    got, want, counts, calls = _rung_vs_eager(rt, g, _rand((32, 16), 9, cuda))
    assert torch.equal(got, want)
    body = {"compute_bound": "taskbench_compute", "memory_bound": "memory_bound"}
    launched = rt.body_launches_per_run(g)
    assert sum(counts.values()) == launched
    if launched:
        assert counts[body[kind]] == launched
    assert calls == rt.host_calls_per_run(g)
    cpu = get_runtime(backend, device="cpu", **opts)
    init = _rand((32, 16), 9, cuda).cpu()
    np.testing.assert_allclose(get_runtime(backend, device=cuda, use_kernels=True, **opts)
                               .execute(g, init), cpu.execute(g, init), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend,opts", RUNG_CASES, ids=RUNG_IDS)
def test_rung_device_kernels_equal_dispatches_per_run(cuda, backend, opts):
    """Under torch.profiler a short run issues one device kernel per
    operation ``dispatches_per_run`` counts (the replays' nodes, without
    the output's clone), K1 among them as counted."""
    from torch.profiler import ProfilerActivity, profile

    g = TaskGraph(steps=5, width=64, pattern="nearest", payload=16,
                  kernel=KernelSpec("compute_bound", 4), radius=2, seed=1)
    rt = get_runtime(backend, device=cuda, use_kernels=True, **opts)
    run = rt.build(g)
    x = _rand((64, 16), 3, cuda)
    run(x)
    if isinstance(run, _capture.GraphRun):
        run.stage(x)
        issue = run.graphed.replay
    elif isinstance(run, _capture.ReplayLoop):
        run.stage(x)

        def issue():
            for i in run.eager.order:
                run.graphs[i].replay()
    else:
        def issue():
            run(x)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        issue()
        torch.cuda.synchronize()
    seen = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(seen) == rt.dispatches_per_run(g)
    assert sum("fma_kernel" in n for n in seen) == ops.launch_counts()["taskbench_compute"]
    assert ops.host_calls() == rt.host_calls_per_run(g)


@pytest.mark.parametrize("backend,opts", RUNG_CASES, ids=RUNG_IDS)
def test_rung_ensemble_equals_its_eager_loop(cuda, backend, opts):
    """Mixed horizons: round-robin host calls (bsp: one per live member a
    timestep; serialized: one per task), one graph for bsp_scan and overlap
    (frozen members step and are masked); each member bit for bit its
    eager loop and within tolerance of its own run on the CPU (grain 1,
    where the dataflow shows)."""
    members = [TaskGraph(steps=T, width=32, pattern=p, payload=16, radius=2, seed=k,
                         kernel=KernelSpec("compute_bound", 1))
               for k, (T, p) in enumerate([(7, "stencil_1d"), (4, "nearest"), (1, "dom"),
                                           (5, "fft")])]
    rt = get_runtime(backend, device=cuda, use_kernels=True, **opts)
    ens = GraphEnsemble([g for g in members if rt.supports(g)[0]])
    xs = tuple(_rand((g.width, g.payload), 20 + k, cuda) for k, g in enumerate(ens.members))
    got, want, counts, calls = _rung_vs_eager(rt, ens, xs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert calls == rt.host_calls_per_run(ens)
    assert sum(counts.values()) == counts["taskbench_compute"] == rt.body_launches_per_run(ens)
    for g, a, x in zip(ens.members, got, xs):
        np.testing.assert_allclose(a.cpu().numpy(),
                                   get_runtime(backend, device="cpu", **opts).execute(g, x.cpu()),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- row shards

SHARD_CASES = [("bsp", {}), ("bsp_scan", {}), ("overlap", {}), ("overlap", {"overlap": False}),
               ("overlap", {"halo_via": "allgather"}), ("pallas_step", {}),
               ("pallas_step", {"steps_per_launch": 2}),
               ("pallas_step", {"steps_per_launch": 2, "pipeline": False}),
               ("pallas_step", {"steps_per_launch": 8, "halo_impl": "ppermute"})]
SHARD_IDS = [f"{b}-{'-'.join(f'{k}={v}' for k, v in o.items()) or 'default'}"
             for b, o in SHARD_CASES]


def _sharded(backend, opts, D, cuda):
    kw = dict(opts) if backend == "pallas_step" else dict(opts, use_kernels=True)
    return get_runtime(backend, devices=[cuda] * D, **kw)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("pattern", ["stencil_1d", "nearest", "random_nearest", "dom"])
@pytest.mark.parametrize("backend,opts", SHARD_CASES, ids=SHARD_IDS)
def test_sharded_run_equals_its_eager_loop_and_d1(cuda, backend, opts, pattern, D):
    """D shards on one card: the run (a ShardedRun over one graph, or bsp's
    graph a superstep) equals its eager loop bit for bit, launches D times
    the per-shard count (K3/K4: ``dispatches_per_run``; K1:
    ``body_launches_per_run``, every shard's) in as many host calls as
    ``host_calls_per_run``, and agrees with the one-device run at grain 1.
    Two more runs equal the eager loop too: a race between the shards'
    streams, or in the allocator, gives wrong bits only sometimes."""
    g = TaskGraph(steps=9, width=64, pattern=pattern, payload=16,
                  kernel=KernelSpec("compute_bound", 1), radius=2, seed=4)
    rt = _sharded(backend, opts, D, cuda)
    run = rt.build(g)
    assert isinstance(run, _capture.ShardedRun)
    assert isinstance(run.inner, _capture.ReplayLoop if backend == "bsp" else _capture.GraphRun)
    x = _rand((64, 16), 9, cuda)
    ops.reset_launch_counts()
    got = run(x)
    torch.cuda.synchronize()
    counts, calls = ops.launch_counts(), ops.host_calls()
    want = run.eager(x.clone())
    assert torch.equal(got, want)
    assert all(torch.equal(run(x), want) for _ in range(2))
    assert calls == rt.host_calls_per_run(g)
    if backend == "pallas_step":
        S = rt._schedule_for_graph(g).steps_per_launch
        k3 = D * (rt.dispatches_per_run(g) if S == 1 else 1)
        assert counts["taskbench_step"] == k3
        assert sum(counts.values()) == D * rt.dispatches_per_run(g)
    else:
        assert sum(counts.values()) == counts["taskbench_compute"] == rt.body_launches_per_run(g)
    one = _sharded(backend, opts, 1, cuda).execute(g, x)
    np.testing.assert_allclose(got.cpu().numpy(), one, rtol=1e-5, atol=1e-5)
    cpu = get_runtime("fused", device="cpu").execute(g, x.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["bsp_scan", "overlap", "pallas_step"])
def test_sharded_ensemble_equals_its_eager_loop(cuda, backend):
    """A K = 3 ensemble of mixed horizons over 4 shards (pallas_step
    stacked): each member bit for bit its eager loop, in three runs, and
    within tolerance of its own run on the CPU."""
    members = [TaskGraph(steps=T, width=64, pattern="stencil_1d", payload=16, seed=k,
                         kernel=KernelSpec("compute_bound", 1)) for k, T in enumerate((7, 4, 1))]
    ens = GraphEnsemble(members)
    rt = _sharded(backend, {}, 4, cuda)
    run = rt.build_ensemble(ens)
    xs = tuple(_rand((64, 16), 30 + k, cuda) for k in range(3))
    got = run(xs)
    want = run.eager(tuple(x.clone() for x in xs))
    for again in (got, run(xs), run(xs)):
        assert all(torch.equal(a, b) for a, b in zip(again, want))
    for g, a, x in zip(members, got, xs):
        np.testing.assert_allclose(a.cpu().numpy(),
                                   get_runtime("fused", device="cpu").execute(g, x.cpu()),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_transfers_run_under_the_interior(cuda, D):
    """overlap=True over D shards: in one replay the transfers (the graph's
    device-to-device copies) overlap compute kernels for a positive time.
    overlap=False joins a shard's transfers before its compute; at D = 2
    every shard waits on every transfer, so nothing overlaps them (at D =
    4 a shard waits on its neighbours' only, and may compute under shard
    d + 2's copies)."""
    from torch.profiler import ProfilerActivity, profile

    g = TaskGraph(steps=4, width=2112, pattern="nearest", payload=64,
                  kernel=KernelSpec("compute_bound", 64), radius=2, seed=0)
    got = {}
    for overlap in (True, False):
        run = _sharded("overlap", {"overlap": overlap}, D, cuda).build(g)
        x = _rand((2112, 64), 1, cuda)
        run(x)
        run.stage(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run.inner.graphed.replay()
            torch.cuda.synchronize()
        ev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
        copies = [(a, b) for a, b, n in ev if "memcpy" in n.lower()]
        comp = [(a, b) for a, b, n in ev if "memcpy" not in n.lower()]
        assert len(copies) == 2 * D * (g.steps - 1)  # 2 a shard a step ("ppermute")
        got[overlap] = sum(max(0, min(b, y) - max(a, x)) for a, b in copies for x, y in comp)
    assert got[True] > 0
    if D == 2:
        assert got[False] == 0


def test_k3_writes_into_out_on_the_card(cuda):
    """K3 with ``out=`` (the owned rows of a halo-extended buffer) writes
    exactly what it returns without it, and nothing outside those rows."""
    x = _rand((1, 2116, 64), 2, cuda)
    idx = torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda)
    wgt = _rand((1, 2112, 5), 3, cuda)
    kw = dict(kind="compute_bound", iterations=64, scratch=0, combine="window")
    want = ops.taskbench_step(x, idx, wgt, **kw)
    buf = torch.full((1, 2116, 64), float("nan"), device=cuda)
    got = ops.taskbench_step(x, idx, wgt, out=buf[:, 2:2114], **kw)
    assert got.data_ptr() == buf[:, 2:2114].data_ptr() and torch.equal(got, want)
    assert torch.isnan(buf[:, :2]).all() and torch.isnan(buf[:, 2114:]).all()


def test_sharded_probe_prices_the_exchange(cuda):
    from repro_torch.kernels import probes

    walls = probes.probe_halo_exchange_us(4, 64, device=cuda, reps=3)
    assert sorted(walls) == ["ppermute", "xla"] and min(walls.values()) > 0


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_memory_body_takes_the_cooperative_form(cuda, D):
    """The memory body's blocked launches take K4's cooperative form: D such
    grids over D shards of one card, each sized to fill the card, run (as
    one graph) and equal the one-device run bit for bit."""
    g = TaskGraph(steps=17, width=2112, pattern="stencil_1d", payload=64,
                  kernel=KernelSpec("memory_bound", 4, scratch=2048), seed=0)
    x = _rand((2112, 64), 5, cuda)
    one = get_runtime("pallas_step", device=cuda, steps_per_launch=8).execute(g, x)
    rt = _sharded("pallas_step", {"steps_per_launch": 8}, D, cuda)
    ops.reset_launch_counts()
    got = rt.execute(g, x)
    assert ops.launch_counts()["taskbench_blocked"] == D * (rt.dispatches_per_run(g) - 1)
    assert np.array_equal(got, one)


SHARD_PLAN_CASES = [("fft", {}), ("fft", {"halo_impl": "ppermute"}), ("tree", {}),
                    ("fft", {"steps_per_launch": 8}), ("fft", {"combine": "gather"}),
                    ("spread", {}), ("spread", {"steps_per_launch": 4}),
                    ("spread", {"gather_impl": "ppermute"}), ("spread", {"gather_impl": "chunked"}),
                    ("all_to_all", {}), ("all_to_all", {"psum_mean": False}),
                    ("all_to_all", {"steps_per_launch": 4, "gather_impl": "chunked"})]


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("pattern,opts", SHARD_PLAN_CASES,
                         ids=[f"{p}-{'-'.join(f'{k}={v}' for k, v in o.items()) or 'default'}"
                              for p, o in SHARD_PLAN_CASES])
def test_sharded_plans_equal_their_eager_loop_and_d1(cuda, pattern, opts, D):
    """The stride and all-gather plans over D shards of one card (W = 64:
    at D = 4 the strides from 16 on are block exchanges): the run, one
    graph, equals its eager loop bit for bit in three runs; it launches D
    times a shard's K3 (and, blocked, resident K4) count; it equals the
    one-device run bit for bit (all_to_all's row mean within tolerance) and
    the CPU plain path within tolerance at grain 1."""
    g = TaskGraph(steps=9, width=64, pattern=pattern, payload=16,
                  kernel=KernelSpec("compute_bound", 1), seed=4)
    rt = _sharded("pallas_step", opts, D, cuda)
    run = rt.build(g)
    assert isinstance(run, _capture.ShardedRun) and isinstance(run.inner, _capture.GraphRun)
    x = _rand((64, 16), 9, cuda)
    ops.reset_launch_counts()
    got = run(x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = run.eager(x.clone())
    assert torch.equal(got, want)
    assert all(torch.equal(run(x), want) for _ in range(2))
    per = rt.dispatches_per_run(g)
    plan = rt._schedule_for_graph(g)
    if plan.steps_per_launch == 1:
        assert counts["taskbench_step"] == D * per == sum(counts.values())
    else:
        assert plan.kind == "allgather"
        assert (counts["taskbench_step"], counts["taskbench_blocked_resident"]) == \
            (D, D * (per - 1))
    one = _sharded("pallas_step", opts, 1, cuda).execute(g, x)
    if pattern == "all_to_all" and opts.get("psum_mean", True) and plan.steps_per_launch == 1:
        np.testing.assert_allclose(got.cpu().numpy(), one, rtol=1e-5, atol=1e-6)
    else:
        assert np.array_equal(got.cpu().numpy(), one)
    cpu = get_runtime("fused", device="cpu").execute(g, x.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), cpu, rtol=1e-5, atol=1e-5)


def test_sharded_probes_time_the_stride_and_gather_transports(cuda):
    from repro_torch.kernels import probes, schedule

    stride = probes.probe_stride_exchange_us(4, 64, device=cuda, reps=3)
    gather = probes.probe_gather_us(4, 64, device=cuda, reps=3)
    table = probes.probe_gather_impl_us(4, 64, device=cuda, reps=5, nodes=20)
    assert sorted(stride) == ["ppermute", "xla"] and min(stride.values()) > 0
    assert sorted(gather) == list(probes.GATHER_WIDTHS) and min(gather.values()) > 0
    assert sorted(table) == ["chunked", "xla"] and sorted(table["xla"]) == [2, 4]
    m = probes.CostModel.from_dict(dict(source="measured", exchange_row_steps=1.0,
                                        gather_impl_us={k: {str(d): c for d, c in v.items()}
                                                        for k, v in table.items()},
                                        devices=4))
    assert schedule.choose_gather_impl(width=512, devices=4, model=m)[1].startswith("measured")


# ------------------------------------------- ensembles across row shards

SHARD_STACKED = [TaskGraph(steps=T, width=64, pattern=p, payload=16, radius=2, seed=k,
                           kernel=KernelSpec("compute_bound", 1))
                 for k, (p, T) in enumerate((("stencil_1d", 7), ("nearest", 6),
                                             ("stencil_1d", 4), ("nearest", 1)))]


def _sharded_ensemble_vs_eager(rt, ens, seed):
    """``rt``'s ensemble run over its shards (a ShardedRun over one graph)
    in three runs, each member bit for bit the eager loop's, and the
    launches of the counted run."""
    run = rt.build_ensemble(ens)
    assert isinstance(run, _capture.ShardedRun) and isinstance(run.inner, _capture.GraphRun)
    xs = tuple(_rand((g.width, g.payload), seed + k, rt.device)
               for k, g in enumerate(ens.members))
    ops.reset_launch_counts()
    got = run(xs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = run.eager(tuple(x.clone() for x in xs))
    for again in (got, run(xs), run(xs)):
        assert all(torch.equal(a, b) for a, b in zip(again, want))
    return xs, got, counts


@pytest.mark.parametrize("dk", [2, 4])
@pytest.mark.parametrize("opts", [{}, {"steps_per_launch": 3},
                                  {"steps_per_launch": 3, "pipeline": False}],
                         ids=["S1", "S3", "S3serial"])
def test_sharded_ensemble_on_the_row_member_mesh(cuda, dk, opts):
    """K = 4 stacked members over D = 4 shards of the card at Dk = 2 and 4
    (the rings' streams forked and joined inside one capture): equal to
    the eager loop in three runs, 4 x ``ensemble_dispatches_per_run``
    launches, bit for bit the replicated run on Dr = 4 / Dk shards, and
    within tolerance of the CPU plain path."""
    ens = GraphEnsemble(SHARD_STACKED)
    rt = get_runtime("pallas_step", devices=[cuda] * 4, member_shards=dk, **opts)
    xs, got, counts = _sharded_ensemble_vs_eager(rt, ens, 50)
    assert sum(counts.values()) == 4 * rt.ensemble_dispatches_per_run(ens)
    twin = get_runtime("pallas_step", devices=[cuda] * (4 // dk), **opts)
    assert all(torch.equal(a, b) for a, b in zip(got, twin.build_ensemble(ens)(xs)))
    for g, a, x in zip(ens.members, got, xs):
        np.testing.assert_allclose(a.cpu().numpy(),
                                   get_runtime("fused", device="cpu").execute(g, x.cpu()),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("specs,opts", [(TUPLE, {}), (TUPLE, {"steps_per_launch": 3}),
                                        (PLANS[:3], {})], ids=["halo-S1", "halo-S3", "plans"])
def test_sharded_ensemble_tuple_equals_one_device(cuda, specs, opts):
    """A tuple ensemble (mixed widths, kernels and plans) over D = 4 shards
    of the card: equal to its eager loop in three runs, 4 x the per-shard
    count launched, and bit for bit its one-device run."""
    ens = _ensemble(specs)
    rt = get_runtime("pallas_step", devices=[cuda] * 4, **opts)
    assert not rt._is_stacked(ens)
    xs, got, counts = _sharded_ensemble_vs_eager(rt, ens, 60)
    assert sum(counts.values()) == 4 * rt.ensemble_dispatches_per_run(ens)
    one = get_runtime("pallas_step", device=cuda, **opts).build_ensemble(ens)(xs)
    assert all(torch.equal(a, b) for a, b in zip(got, one))


@pytest.mark.parametrize("specs,opts", [
    (SHARD_STACKED, {}), (SHARD_STACKED, {"steps_per_launch": 3}),
    (SHARD_STACKED, {"member_shards": 2}),
    (SHARD_STACKED, {"member_shards": 2, "steps_per_launch": 3}), (PLANS[:3], {})],
    ids=["stacked-S1", "stacked-S3", "stacked-dk2-S1", "stacked-dk2-S3", "stepwise"])
def test_sharded_ensemble_launch_plan_captures_nothing_under_churn(cuda, specs, opts):
    """The launch plans over D = 4 shards of the card: stepped on the host,
    equal to ``build_ensemble`` bit for bit; evicting member 0 from launch
    1 and admitting a fresh member into a finished slot capture nothing."""
    ens = GraphEnsemble(specs) if isinstance(specs[0], TaskGraph) else _ensemble(specs)
    rt = get_runtime("pallas_step", devices=[cuda] * 4, **opts)
    lp = rt.build_ensemble_launches(ens)
    xs = tuple(_rand((g.width, g.payload), 70 + k, cuda) for k, g in enumerate(ens.members))

    def step(acts, admit=None):
        carry = lp.init_fn(xs)
        for l in range(lp.num_launches):
            if admit is not None and l == admit[0]:
                carry = lp.admit_fn(carry, admit[1], admit[2])
            carry = lp.launch_fn(carry, acts[l], lp.launch_t0(l))
        return lp.finalize(carry)

    outs = step(lp.acts)
    want = rt.build_ensemble(ens)(xs)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    before = lp.compile_counter()
    acts = lp.acts.copy()
    acts[1:, 0, :] = 0
    slot = min(range(len(ens)), key=lambda k: ens.members[k].steps)
    g = ens.members[slot]
    churned = step(acts, admit=(lp.num_launches - 1, slot,
                                _rand((g.width, g.payload), 80, cuda)))
    torch.cuda.synchronize()
    assert lp.compile_counter() == before == _build.CAPTURES["graphs"]
    assert not torch.equal(churned[0], outs[0])


# ------------------------------------ resilience, serving, restart on the card


def _plan_events(plan):
    want = {"transport": lambda s: ("transport", s.launch, "retried", -1, s.times, ""),
            "launch": lambda s: ("launch", s.launch, "replayed", -1, 0, s.mode),
            "member": lambda s: ("member", s.launch, "evicted", s.member, 0, ""),
            "straggler": lambda s: ("straggler", s.launch, "flagged", -1, 0, "")}
    return sorted(want[s.kind](s) for s in plan.specs)


def _res_plan(S, L):
    from repro_torch.resilience import FaultPlan, FaultSpec

    if S == 1:  # every class at its own launch; the stall after 3 clean walls
        return FaultPlan((FaultSpec("transport", 0, times=2), FaultSpec("launch", 1),
                          FaultSpec("launch", 2, mode="poison"),
                          FaultSpec("straggler", 3, delay_s=0.1),
                          FaultSpec("member", 4, member=1),
                          FaultSpec("member", L - 1, member=0)))
    return FaultPlan((FaultSpec("launch", 0), FaultSpec("member", 0, member=1),
                      FaultSpec("transport", 1, times=2), FaultSpec("launch", 1, mode="poison")))


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("S", [1, 4])
def test_resilient_run_recovers_bit_for_bit_on_the_card(cuda, S, D):
    """``execute_ensemble_resilient`` on the stacked launch plan (K3 at S =
    1, K4 tiled at S = 4), grain 1, T <= 7 (the states at least 1e-3 from
    the FMA's fixed point 0.2, so a wrong replay shows): the clean run
    equals the ``build_ensemble`` replay bit for bit; under a plan of every
    class the survivors equal it, the evicted and re-admitted members their
    same-K oracle; the events are the plan's; the launches the clean run's
    plus one a poisoned or evicting replay and each admission's t = 0 K3."""
    import dataclasses

    from repro_torch.core.task_kernels import initial_state
    from repro_torch.resilience import RecoveryPolicy

    ens = GraphEnsemble([TaskGraph(steps=t, width=64, pattern="stencil_1d", payload=16,
                                   seed=k, kernel=KernelSpec("compute_bound", 1))
                         for k, t in enumerate((7, 7, 6))])
    rt = get_runtime("pallas_step", devices=[cuda] * D, steps_per_launch=S)
    xs = tuple(_rand((64, 16), 90 + k, cuda) for k in range(3))
    lp = rt.build_ensemble_launches(ens)
    want = rt.build_ensemble(ens)(xs)
    ops.reset_launch_counts()
    clean = rt.execute_ensemble_resilient(ens, inits=xs)
    torch.cuda.synchronize()
    d_clean = ops.launch_counts()
    assert all(torch.equal(torch.from_numpy(a), b.cpu()) for a, b in zip(clean.outputs, want))
    plan = _res_plan(S, lp.num_launches)
    ops.reset_launch_counts()
    # the deadline 30 x the clean walls' median: a shared host's stalls
    # stay under it, the 100 ms stall does not
    res = rt.execute_ensemble_resilient(
        ens, plan=plan, policy=RecoveryPolicy(readmit=True, deadline_factor=30.0), inits=xs)
    torch.cuda.synchronize()
    d_fault = ops.launch_counts()
    assert sorted((e.kind, e.launch, e.action, e.member, e.attempts, e.mode)
                  for e in res.events) == _plan_events(plan)
    members, inits = list(ens.members), list(xs)
    for k, frozen in res.evicted.items():
        members[k] = dataclasses.replace(members[k], steps=frozen)
    for k, info in res.readmitted.items():
        members[k] = dataclasses.replace(members[k], steps=info["steps"], seed=info["seed"])
        inits[k] = initial_state(64, 16, info["seed"], device=cuda)
    oracle = rt.build_ensemble(GraphEnsemble(members))(tuple(inits))
    assert min((w.cpu() - 0.2).abs().max().item() for w in list(want) + list(oracle)) >= 1e-3
    for k, (a, b, c) in enumerate(zip(res.outputs, want, oracle)):
        assert torch.equal(torch.from_numpy(a), c.cpu()), k
        if k not in res.evicted:
            assert torch.equal(torch.from_numpy(a), b.cpu()), k
    relaunch = sum(e.kind == "member" or e.mode == "poison" for e in res.events)
    admitted = len(res.readmitted)
    if S == 1:  # D K3 a launch, at the init and at each admission
        assert d_fault["taskbench_step"] == d_clean["taskbench_step"] + D * (relaunch + admitted)
        assert res.stragglers == 1 and res.deadline_source == "observed"
    else:  # D K4 tiled a launch; D K3 at the init and at each admission
        assert d_fault["taskbench_blocked_tiled"] == (d_clean["taskbench_blocked_tiled"]
                                                      + D * relaunch)
        assert d_fault["taskbench_step"] == d_clean["taskbench_step"] + D * admitted
        assert d_clean["taskbench_step"] == D


def test_serving_fabric_on_the_card(cuda):
    """The fabric over the card's launch plans under ``LaunchClock``: a
    stacked cohort that admits mid-run, a stepwise cohort and a nearest
    cohort; grain 1, T <= 7 (the outputs at least 1e-3 from the FMA's
    fixed point 0.2); every outcome bit for bit its same-K oracle, no
    capture mid-cohort."""
    from repro_torch.serving import LaunchClock, ServingFabric, make_request

    rt = get_runtime("pallas_step", device=cuda, steps_per_launch=2)
    g1 = KernelSpec("compute_bound", 1)
    reqs = [make_request(0, steps=7, width=64, seed=1, kernel=g1),
            make_request(1, steps=5, width=64, seed=2, kernel=g1),
            make_request(2, steps=7, width=64, seed=3, arrival_s=1.0, kernel=g1),
            make_request(3, steps=7, width=64, seed=4, arrival_s=1.0, deadline_s=2.0, kernel=g1),
            make_request(4, steps=4, width=32, pattern="all_to_all", arrival_s=2.0, kernel=g1),
            make_request(5, steps=6, width=64, pattern="nearest", radius=2, arrival_s=2.0,
                         seed=5, kernel=g1)]
    rep = ServingFabric(rt, max_slots=2, verify=True, clock=LaunchClock()).serve(reqs)
    assert min(np.abs(o.output - 0.2).max() for o in rep.outcomes) >= 1e-3
    assert rep.bit_identical is True
    assert all(c.recompiles == 0 for c in rep.cohorts)
    assert sum(c.admitted_mid_run for c in rep.cohorts) >= 1
    assert sorted(c.kind for c in rep.cohorts).count("stepwise") == 1


@pytest.mark.parametrize("S", [1, 4])
def test_restart_over_a_launch_plan_on_the_card(cuda, S, tmp_path):
    """``run_with_restarts`` with one launch a step, two failures and the
    newest checkpoint corrupted before the second: the final state equals
    the uninterrupted replay bit for bit, restored onto the card."""
    import os

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.checkpoint.elastic import FailureInjector, run_with_restarts

    ens = GraphEnsemble([TaskGraph(steps=t, width=64, pattern="nearest", radius=2, payload=16,
                                   seed=k, kernel=KernelSpec("compute_bound", 1))
                         for k, t in enumerate((25, 21, 17, 9))])
    rt = get_runtime("pallas_step", device=cuda, steps_per_launch=S)
    xs = tuple(_rand((64, 16), 110 + k, cuda) for k in range(4))
    lp = rt.build_ensemble_launches(ens)
    rows = lp.act_rows()  # staged on the card in one copy
    L = lp.num_launches
    ckpt = Checkpointer(str(tmp_path), keep=2)
    fails = (L // 2, L - 1)

    class Corrupting(FailureInjector):
        def maybe_fail(self, step):
            if step == fails[1] and step not in self.fired:
                path = os.path.join(ckpt.dir, f"step_{ckpt.latest_step():08d}", "arrays.npz")
                with open(path, "r+b") as f:
                    f.seek(64)
                    f.write(b"\xde\xad\xbe\xef")
            super().maybe_fail(step)

    final, restarts = run_with_restarts(
        total_steps=L, ckpt=ckpt, ckpt_every=2, init_state=lambda: {"c": lp.init_fn(xs)},
        step_fn=lambda s, l: {"c": lp.launch_fn(s["c"], rows[l], lp.launch_t0(l))},
        injector=Corrupting(fails))
    assert restarts == 2 and final["c"].device.type == "cuda"
    want = rt.build_ensemble(ens)(xs)
    assert all(torch.equal(a, b) for a, b in zip(lp.finalize(final["c"]), want))


# ------------------------------------------------------------- training


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-3b-a800m", "hymba-1.5b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, accum):
    """One make_train_step on the card against the same step on the CPU,
    one weight set, f32 (the JAX package's step is held to the CPU's in
    tests/test_torch_trainer.py): the loss and grad_norm within 1e-4
    relative, every parameter after the update within 1e-4 (lr 1e-2, eps
    1e-3: each update smooth in its gradient); the card's step launches no
    kernel of the port (train mode runs the plain attention and SSD)."""
    from repro_torch.configs.registry import get_shape
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.optimizer import AdamW, AdamWConfig

    cfg = get_config(arch).reduced()
    weights = Model(cfg, device="cpu").state_dict()
    batch = SyntheticTokenPipeline(cfg, get_shape("train_4k"), batch_override=4,
                                   seq_override=32).batch_at(0)
    out = {}
    for dev in ("cpu", cuda):
        model = Model(cfg, device=dev)
        model.load_state_dict(weights)
        opt = AdamW(AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=1))
        named = dict(model.named_parameters())
        ops.reset_launch_counts()
        _, metrics = make_train_step(model, opt, accum)(
            opt.init(named), {k: v.to(dev) for k, v in batch.items()})
        if dev != "cpu":
            torch.cuda.synchronize()
            assert ops.launch_counts() == dict.fromkeys(_build.ENTRIES, 0)
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         {n: p.detach().cpu() for n, p in named.items()})
    (m_cpu, p_cpu), (m_card, p_card) = out["cpu"], out["cuda"]
    for key in ("loss", "grad_norm", "lr"):
        assert m_card[key] == pytest.approx(m_cpu[key], rel=1e-4)
    for n in p_cpu:
        torch.testing.assert_close(p_card[n], p_cpu[n], rtol=0, atol=1e-4)
