"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version, the pipelined phases and schedule against the serial
ones bit for bit, and the runtimes on the card against the CPU plain path. Every test carries the ``gpu`` marker and skips without a card.

Run on a machine with an NVIDIA card (the kernels build with nvcc at first
use):  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import pallas_step as ps
from repro_torch.kernels import ops
from repro_torch.kernels.bodies import apply_body
from repro_torch.kernels.taskbench_step import (
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
    before = ops.launch_counts()["taskbench_blocked"]
    got = ops.taskbench_step(src, idx, wgt, act, steps_per_launch=S, **kw)
    assert ops.launch_counts()["taskbench_blocked"] == before + 1
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
        assert counts["taskbench_step"] + counts["taskbench_blocked"] == \
            pipe.dispatches_per_run(g)
        serial = get_runtime("pallas_step", device=cuda, combine=combine,
                             steps_per_launch=S, pipeline=False).execute(g)
        assert np.array_equal(got, serial)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
