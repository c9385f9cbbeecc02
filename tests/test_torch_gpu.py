"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version, and the runtimes on the card against the CPU plain
path. Every test carries the ``gpu`` marker and skips without a card.

Run on a machine with an NVIDIA card (the kernels build with nvcc at first
use):  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.kernels import ops
from repro_torch.kernels.bodies import apply_body
from repro_torch.kernels.taskbench_step import taskbench_step_plain

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
