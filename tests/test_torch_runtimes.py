"""Runtime parity of the PyTorch port with the JAX package, on the CPU.

The port's ``fused`` (both ``use_kernels`` values) and ``pallas_step`` (all
three combine modes) run each of the 7 halo patterns fed the reference's
initial state, and are held against the reference's ``fused`` and
``pallas_step`` on one CPU device. Tolerances: compute_bound and empty
``rtol=1e-5, atol=1e-6``; memory_bound ``atol=1e-5`` (the sweep's mean is
summed in another order).
"""
import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import KernelSpec as RefSpec
from repro.core import TaskGraph as RefGraph
from repro.core import get_runtime as ref_runtime
from repro.core.task_kernels import initial_state as ref_initial_state
from repro_torch.core import KernelSpec, TaskGraph, compute_metg, get_runtime
from repro_torch.core.task_kernels import apply_kernel, initial_state

HALO = ("trivial", "no_comm", "stencil_1d", "stencil_1d_periodic", "dom",
        "nearest", "random_nearest")
COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(pattern, kind="compute_bound", iters=2, width=12, steps=6, **kw):
    kw = dict(dict(radius=2, seed=3), **kw)
    spec = dict(kind=kind, iterations=iters, scratch=30)
    g = TaskGraph(steps=steps, width=width, pattern=pattern, payload=5,
                  kernel=KernelSpec(**spec), **kw)
    r = RefGraph(steps=steps, width=width, pattern=pattern, payload=5,
                 kernel=RefSpec(**spec), **kw)
    init = np.asarray(ref_initial_state(width, 5, r.seed))
    return g, r, init


def _port_outputs(g, init):
    outs = {
        "fused": get_runtime("fused", device="cpu").execute(g, init),
        "fused+kernels": get_runtime("fused", device="cpu", use_kernels=True).execute(g, init),
    }
    for combine in ("window", "gather", "onehot"):
        outs[f"pallas_step/{combine}"] = get_runtime(
            "pallas_step", device="cpu", combine=combine).execute(g, init)
    return outs


@pytest.mark.parametrize("pattern,kind,iters", [
    *((p, "compute_bound", 2) for p in HALO),
    *((p, "memory_bound", 3) for p in HALO),
    ("stencil_1d", "empty", 0), ("random_nearest", "empty", 0),
])
def test_halo_patterns_match_reference_backends(pattern, kind, iters):
    g, r, init = _pair(pattern, kind, iters)
    ref_fused = np.asarray(ref_runtime("fused").execute(r, init))
    ref_ps = np.asarray(ref_runtime("pallas_step").execute(r, init))
    tol = MEMORY_TOL if kind == "memory_bound" else COMPUTE_TOL
    for name, out in _port_outputs(g, init).items():
        assert out.shape == (g.width, g.payload) and out.dtype == np.float32, name
        np.testing.assert_allclose(out, ref_fused, err_msg=name, **tol)
        np.testing.assert_allclose(out, ref_ps, err_msg=name, **tol)


@pytest.mark.parametrize("combine", ["gather", "onehot"])
@pytest.mark.parametrize("pattern", ["stencil_1d", "random_nearest"])
def test_pallas_step_combine_modes_match_reference(pattern, combine):
    g, r, init = _pair(pattern, iters=1, width=10)
    want = np.asarray(ref_runtime("pallas_step", combine=combine).execute(r, init))
    got = get_runtime("pallas_step", device="cpu", combine=combine).execute(g, init)
    np.testing.assert_allclose(got, want, **COMPUTE_TOL)


@pytest.mark.parametrize("pattern,width,radius", [("nearest", 3, 2), ("nearest", 4, 3),
                                                  ("random_nearest", 5, 3),
                                                  ("stencil_1d", 1, 1), ("nearest", 1, 2),
                                                  ("nearest", 2, 2),
                                                  ("stencil_1d_periodic", 2, 1),
                                                  ("dom", 2, 1)])
def test_narrow_widths_wrap_like_the_reference(pattern, width, radius):
    """W <= 2r: dependencies reach past one ring; W = 1 degenerates."""
    g, r, init = _pair(pattern, iters=1, width=width, radius=radius)
    want = np.asarray(ref_runtime("pallas_step").execute(r, init))
    np.testing.assert_allclose(np.asarray(ref_runtime("fused").execute(r, init)),
                               want, **COMPUTE_TOL)
    for name, out in _port_outputs(g, init).items():
        np.testing.assert_allclose(out, want, err_msg=name, **COMPUTE_TOL)


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("pattern", HALO)
def test_s1_pallas_step_folds_the_wrap_into_each_step(monkeypatch, pattern, combine):
    """At S = 1 each timestep is one step call on the (1, W, payload) state
    itself with ``wrap=H`` (the kernel reads the halo extension from it, no
    row gather before it); only the t = 0 body-only call takes no wrap. The
    result is the unpatched run's."""
    from repro_torch.core.patterns import halo_radius
    from repro_torch.core.runtimes import pallas_step as ps

    g, _, init = _pair(pattern, iters=1, width=9, steps=5)
    rt = get_runtime("pallas_step", device="cpu", combine=combine)
    want = rt.execute(g, init)
    calls = []
    step = ps._kops.taskbench_step

    def spy(src, idx, wgt, act=None, **kw):
        calls.append((tuple(src.shape), kw.get("wrap")))
        return step(src, idx, wgt, act, **kw)

    monkeypatch.setattr(ps._kops, "taskbench_step", spy)
    got = rt.execute(g, init)
    H = halo_radius(g)
    assert calls == [((1, 9, 5), None)] + [((1, 9, 5), H)] * (g.steps - 1)
    assert rt.dispatches_per_run(g) == len(calls)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pattern,width", [("fft", 8), ("tree", 8), ("all_to_all", 6),
                                           ("spread", 7)])
def test_fused_runs_the_non_halo_patterns_like_the_reference(pattern, width):
    g, r, init = _pair(pattern, iters=1, width=width)
    want = np.asarray(ref_runtime("fused").execute(r, init))
    for use_kernels in (False, True):
        got = get_runtime("fused", device="cpu", use_kernels=use_kernels).execute(g, init)
        np.testing.assert_allclose(got, want, **COMPUTE_TOL)


def test_one_step_is_the_body_alone():
    g, r, init = _pair("stencil_1d", steps=1)
    want = np.asarray(ref_runtime("pallas_step").execute(r, init))
    for name, out in _port_outputs(g, init).items():
        np.testing.assert_allclose(out, want, err_msg=name, **COMPUTE_TOL)


class _OpCounter(TorchDispatchMode):
    """Counts the operations dispatched to a device, views left out."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("pattern,spec", [
    ("stencil_1d", KernelSpec("compute_bound", 3)),
    ("fft", KernelSpec("empty", 3)),
    ("all_to_all", KernelSpec("memory_bound", 2, 10)),
    ("nearest", KernelSpec("compute_bound", 0)),
])
def test_fused_dispatches_count_what_the_loop_issues(pattern, spec):
    g = TaskGraph(steps=4, width=8, pattern=pattern, payload=4, kernel=spec)
    rt = get_runtime("fused", device="cpu")
    fn = rt.build(g)
    x = initial_state(8, 4, 0, "cpu")
    with _OpCounter() as c:
        fn(x)
    assert c.n == rt.dispatches_per_run(g)
    # with the kernels, each body's plain ops become one launch
    with _OpCounter() as b:
        apply_kernel(x, spec)
    launch = 0 if spec.kind == "empty" or spec.iterations == 0 else 1
    rk = get_runtime("fused", device="cpu", use_kernels=True)
    assert rk.dispatches_per_run(g) == c.n - g.steps * (b.n - launch)


def test_measure_gives_a_grain_sample_and_metg():
    rt = get_runtime("pallas_step", device="cpu")
    samples = []
    for grain in (1, 8):
        g = TaskGraph(steps=3, width=8, pattern="stencil_1d", payload=4,
                      kernel=KernelSpec("compute_bound", grain))
        s, st = rt.measure(g, reps=2, warmup=1)
        assert s.iterations == grain and s.num_tasks == 24 and s.cores == 1
        assert s.wall_time == st.best == min(st.walls) > 0 and len(st.walls) == 2
        assert st.dispatches == 3
        samples.append(s)
    assert compute_metg(samples).peak_flops_per_second > 0


def test_port_initial_state_is_seeded_and_in_range():
    a, b = initial_state(6, 3, 4, "cpu"), initial_state(6, 3, 4, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.min()) >= 0.1 and float(a.max()) < 1.0
    assert not torch.equal(a, initial_state(6, 3, 5, "cpu"))
