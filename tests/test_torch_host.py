"""Host-side parity of the PyTorch port with the JAX package: dependency
tables, METG, step operands, and the runtimes' device and option checks.

Host tables must be byte-equal; METG results equal on identical samples.
"""
import dataclasses

import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

from repro.core import metg as ref_metg
from repro.core.graph import GraphEnsemble as RefEnsemble
from repro.core.graph import TaskGraph as RefGraph
from repro.core.patterns import halo_radius as ref_halo_radius
from repro.core.runtimes import pallas_step as ref_ps
from repro.core.task_kernels import KernelSpec as RefSpec
from repro.kernels import taskbench_step as ref_step
from repro_torch.core import (
    PATTERNS,
    GraphEnsemble,
    KernelSpec,
    TaskGraph,
    available_runtimes,
    get_runtime,
)
from repro_torch.core import metg
from repro_torch.core.patterns import halo_radius
from repro_torch.core.runtimes import pallas_step as ps
from repro_torch.kernels import taskbench_step as step

HALO = ("trivial", "no_comm", "stencil_1d", "stencil_1d_periodic", "dom",
        "nearest", "random_nearest")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graphs(pattern, width, **kw):
    spec = dict(kind="memory_bound", iterations=3, scratch=40)
    g = TaskGraph(steps=9, width=width, pattern=pattern, payload=5,
                  kernel=KernelSpec(**spec), **kw)
    r = RefGraph(steps=9, width=width, pattern=pattern, payload=5,
                 kernel=RefSpec(**spec), **kw)
    return g, r


def _cases():
    out = []
    for pattern in PATTERNS:
        widths = (1, 8, 16) if pattern in ("fft", "tree") else (1, 5, 12)
        for w in widths:
            out.append((pattern, w, dict(radius=2, fanout=3, seed=0)))
    out += [("random_nearest", 12, dict(radius=3, seed=s)) for s in (1, 7)]
    out += [("nearest", 3, dict(radius=2)), ("nearest", 4, dict(radius=3)),
            ("random_nearest", 4, dict(radius=3, seed=5))]  # W <= 2r
    return out


@pytest.mark.parametrize("pattern,width,kw", _cases())
def test_dependency_arrays_byte_equal(pattern, width, kw):
    g, r = _graphs(pattern, width, **kw)
    for a, b in zip(g.dependency_arrays(), r.dependency_arrays()):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert (g.period, g.max_deps, g.num_dependencies, g.total_flops(),
            g.bytes_per_task(), g.describe()) == (
        r.period, r.max_deps, r.num_dependencies, r.total_flops(),
        r.bytes_per_task(), r.describe())
    assert halo_radius(g) == ref_halo_radius(r)
    assert g.dependencies(3, width - 1) == r.dependencies(3, width - 1)


@pytest.mark.parametrize("width", [4, 8])
def test_ensemble_dependency_arrays_byte_equal(width):
    pats = [("stencil_1d", {}), ("fft", {}), ("nearest", dict(radius=3)),
            ("random_nearest", dict(radius=2, seed=4)), ("tree", {})]
    ens = GraphEnsemble([_graphs(p, width, **kw)[0] for p, kw in pats])
    ref = RefEnsemble([_graphs(p, width, **kw)[1] for p, kw in pats])
    for a, b in zip(ens.dependency_arrays(), ref.dependency_arrays()):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (ens.steps, ens.num_tasks, ens.total_flops(), ens.stackable) == (
        ref.steps, ref.num_tasks, ref.total_flops(), ref.stackable)


def _samples(mod, seed):
    rng = np.random.default_rng(seed)
    return [mod.GrainSample(iterations=int(g), wall_time=float(w),
                            total_flops=float(f), num_tasks=132 * 1000, cores=132)
            for g, w, f in zip([1, 4, 16, 64, 256, 1024],
                               rng.uniform(1e-3, 2e-2, 6),
                               rng.uniform(1e6, 1e10, 6))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [0.5, 0.9])
def test_metg_equal_on_identical_samples(seed, threshold):
    got = metg.compute_metg(_samples(metg, seed), threshold=threshold)
    want = ref_metg.compute_metg(_samples(ref_metg, seed), threshold=threshold)
    assert got.metg_us == want.metg_us
    assert got.peak_flops_per_second == want.peak_flops_per_second
    assert [dataclasses.astuple(p) for p in got.curve] == [
        dataclasses.astuple(p) for p in want.curve]
    a = metg.combine_grain_samples(_samples(metg, seed), wall_time=0.5)
    b = ref_metg.combine_grain_samples(_samples(ref_metg, seed), wall_time=0.5)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    a = metg.combine_grain_samples(_samples(metg, seed))
    b = ref_metg.combine_grain_samples(_samples(ref_metg, seed))
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert metg.default_grain_schedule(1, 1 << 14, 4) == \
        ref_metg.default_grain_schedule(1, 1 << 14, 4)


def test_combine_grain_samples_rejects_mixed_cores():
    s = _samples(metg, 0)
    with pytest.raises(ValueError, match="different core counts"):
        metg.combine_grain_samples([s[0], dataclasses.replace(s[1], cores=1)])


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_prepare_step_operands_byte_equal():
    rng = np.random.default_rng(3)
    lists = [list(rng.integers(0, 20, rng.integers(0, 5))) for _ in range(17)]
    selfs = list(rng.integers(0, 20, 17))
    for a, b in zip(step.prepare_step_operands(lists, 17, selfs),
                    ref_step.prepare_step_operands(lists, 17, selfs)):
        _equal(a, b)
    w = rng.uniform(0, 1, (5, 3)) / 3
    _equal(step.finalize_weights(w), ref_step.finalize_weights(w))


@pytest.mark.parametrize("pattern", HALO)
@pytest.mark.parametrize("width,radius", [(1, 1), (9, 1), (16, 3), (3, 2)])
def test_halo_operand_builders_byte_equal(pattern, width, radius):
    g, r = _graphs(pattern, width, radius=radius, seed=2)
    H = halo_radius(g)
    for a, b in zip(ps._window_operands(g, H), ref_ps._window_operands(r, H)):
        _equal(a, b)
    for a, b in zip(ps._ext_dep_operands(g, width, H),
                    ref_ps._ext_dep_operands(r, width, H)):
        _equal(a, b)
    for a, b in zip(ps._self_operands(width, width), ref_ps._self_operands(width, width)):
        _equal(a, b)


def test_extend_rows_wrap_past_the_ring():
    # nearest with W <= 2r reaches past one ring: rows stay exact mod W
    assert list(ps._extend_rows(3, 4)) == [2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0]
    assert list(ps._extend_rows(5, 0)) == [0, 1, 2, 3, 4]


def test_runtimes_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("fused", "serialized", "bsp", "bsp_scan", "overlap", "pallas_step"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_runtime(name)
    with pytest.raises(ValueError, match="unsupported device"):
        get_runtime("fused", device="meta")


def test_registry_and_options():
    assert available_runtimes() == ["bsp", "bsp_scan", "fused", "overlap", "pallas_step",
                                    "serialized"]
    with pytest.raises(KeyError, match="unknown runtime"):
        get_runtime("mpi", device="cpu")
    with pytest.raises(ValueError, match="unknown options"):
        get_runtime("fused", device="cpu", use_pallas=True)
    with pytest.raises(ValueError, match="unknown combine option"):
        get_runtime("pallas_step", device="cpu", combine="pair")
    for s in (2, 8):
        get_runtime("pallas_step", device="cpu", steps_per_launch=s, pipeline=False)
    # "auto", 0 and "0" are the reference's spellings of the depth tuner
    # (repro.kernels.schedule.is_auto): all three construct and resolve alike
    g = TaskGraph(steps=9, width=12, pattern="stencil_1d", payload=5,
                  kernel=KernelSpec("compute_bound", 1))
    auto = get_runtime("pallas_step", device="cpu", steps_per_launch="auto")
    want = auto._schedule_for_graph(g)
    assert want.kind == ps.PLAN_HALO and want.steps_per_launch == 8 and want.reason
    for s in (0, "0"):
        rt = get_runtime("pallas_step", device="cpu", steps_per_launch=s)
        assert rt._schedule_for_graph(g) == want
        assert rt.dispatches_per_run(g) == auto.dispatches_per_run(g)
    with pytest.raises(ValueError, match="steps_per_launch must be >= 1"):
        get_runtime("pallas_step", device="cpu", steps_per_launch=-1)
    get_runtime("pallas_step", device="cpu", steps_per_launch=1)


@pytest.mark.parametrize("pattern", [p for p in PATTERNS if p not in HALO])
def test_pallas_step_refuses_non_halo_patterns(pattern):
    """The non-halo patterns take the reference's plan (stride for fft and
    tree, all-gather for spread and all_to_all) and launch count; past
    ``gather_width_cap`` the port refuses what the reference refuses, the
    reason naming the plans and the `fused` fallback."""
    g, r = _graphs(pattern, 8)
    rt, ref = get_runtime("pallas_step", device="cpu"), ref_ps.PallasStepRuntime()
    assert rt.plan_for(g) == ref.plan_for(r)
    assert rt.plan_for(g)[0] in (ps.PLAN_STRIDE, ps.PLAN_ALLGATHER)
    assert rt.dispatches_per_run(g) == ref.dispatches_per_run(r) == g.steps
    capped = get_runtime("pallas_step", device="cpu", gather_width_cap=4)
    ref_capped = ref_ps.PallasStepRuntime(gather_width_cap=4)
    plan, why = capped.plan_for(g)
    assert plan == ref_capped.plan_for(r)[0]
    if plan is None:  # the global patterns, past the cap
        assert "stride" in why and "allgather" in why and "`fused`" in why
        assert "gather_width_cap=4" in why
        with pytest.raises(ValueError, match="cannot run"):
            capped.execute(g)


@pytest.mark.parametrize("pattern", HALO)
def test_pallas_step_plan_matches_reference(pattern):
    g, r = _graphs(pattern, 8)
    assert get_runtime("pallas_step", device="cpu").plan_for(g) == \
        (ps.PLAN_HALO, "") == ref_ps.PallasStepRuntime().plan_for(r)
    assert get_runtime("pallas_step", device="cpu").dispatches_per_run(g) == \
        ref_ps.PallasStepRuntime().dispatches_per_run(r) == g.steps
