"""Card-only tests of the port's tracing (``trace=True``,
``Runtime.trace_once``): on the card the traced twin equals the build's
replay bit for bit, launches exactly what its eager loop launches (its
warm-up and the pipelined probes counted apart), and the production run
records no span. Every test carries the ``gpu`` marker and skips without a
card.

Run on a machine with an NVIDIA card (the kernels build with nvcc at first
use):  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_obs_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.kernels import ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _rand(shape, seed, device):
    x = np.random.default_rng(seed).uniform(0.1, 1.0, shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


TRACE_CASES = [
    ("pallas_step", 1, {}), ("pallas_step", 1, {"steps_per_launch": 4, "pipeline": False}),
    ("pallas_step", 1, {"steps_per_launch": 4}), ("pallas_step", 4, {}),
    ("pallas_step", 4, {"steps_per_launch": 4}), ("bsp", 1, {"use_kernels": True}),
    ("bsp", 4, {"use_kernels": True}), ("overlap", 4, {"use_kernels": True}),
    ("serialized", 1, {"use_kernels": True}), ("fused", 1, {"use_kernels": True}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,D,opts", TRACE_CASES,
                         ids=[f"{n}-D{d}-{sorted(o.items())}" for n, d, o in TRACE_CASES])
def test_trace_once_on_card_equals_replay(cuda, name, D, opts):
    """``trace_once`` on the card: bit for bit the build's replay, its
    launches (zeroed just before) exactly its eager loop's, the warm-up and
    the probes counted apart; the production run records no span."""

    g = TaskGraph(steps=17, width=96 if name != "serialized" else 16, pattern="stencil_1d",
                  payload=8, kernel=KernelSpec("compute_bound", 1), radius=1)
    rt = get_runtime(name, devices=[cuda] * D, trace=True, **opts)
    x = _rand((g.width, g.payload), 90, cuda)
    run = rt.build(g)
    want = run(x.clone())
    eager = getattr(run, "eager", run)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eager(x.clone())
    torch.cuda.synchronize()
    d_eager = ops.launch_counts()
    assert rt.tracer.spans == []
    ops.reset_launch_counts()
    got = rt.trace_once(g, x)
    assert ops.launch_counts() == d_eager
    assert torch.equal(torch.from_numpy(got), want.cpu())
    s = obs.summarize(rt.tracer.spans)
    assert sum(s["fractions"].values()) == pytest.approx(1.0)
    assert s["fractions"]["dispatch"] > 0
    if opts.get("steps_per_launch") and opts.get("pipeline", True):
        costs = obs.probe_costs(rt.tracer.spans)
        assert set(costs) == {"boundary", "interior"} | ({"exchange"} if D > 1 else set())
        assert all(v > 0 for v in costs.values())
