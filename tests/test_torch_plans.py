"""Parity of the port's ``pallas_step`` stride and all-gather plans with the
JAX package's, on the CPU.

The reference runs on one CPU device; the port runs its kernels' plain
versions, fed the reference's initial state. Each of the reference's plan
tests (``tests/test_runtimes.py``: dispatch and refusal, butterfly at S in
{1, 3, 8}, spread and all_to_all at S in {1, 4}, the combine options, the
launch accounting) runs as a case here against the reference's own
``pallas_step`` and ``fused``; the operand tables and the depth parser
are held to the reference's byte for byte, and the plan, depth and launch
count to the reference's for every pattern x S x cap.

Tolerances: compute_bound and empty ``rtol=1e-5, atol=1e-6``; memory_bound
``atol=1e-5`` (the sweep's mean is summed in another order); butterfly
(fft, tree) bit for bit against the port's own ``fused``, as the reference
guarantees against its own (every combine weight is 0.5, so 0.5*a + 0.5*b
rounds as (a + b) / 2).
"""
import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KernelSpec as RefSpec
from repro.core import TaskGraph as RefGraph
from repro.core import get_runtime as ref_runtime
from repro.core.runtimes import pallas_step as ref_ps
from repro.core.task_kernels import initial_state as ref_initial_state
from repro.kernels import schedule as ref_schedule
from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import pallas_step as ps
from repro_torch.kernels import schedule

COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=0, atol=1e-5)
BUTTERFLY = ("fft", "tree")
GLOBAL = ("spread", "all_to_all")
NON_HALO = BUTTERFLY + GLOBAL


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(pattern, kind="compute_bound", iters=1, width=16, steps=7, payload=8, **kw):
    """The same graph in both packages (grain 1 by default, so the
    dataflow shows), and the reference's initial state."""
    kw = dict(dict(radius=2, seed=3), **kw)
    spec = dict(kind=kind, iterations=iters, scratch=30)
    g = TaskGraph(steps=steps, width=width, pattern=pattern, payload=payload,
                  kernel=KernelSpec(**spec), **kw)
    r = RefGraph(steps=steps, width=width, pattern=pattern, payload=payload,
                 kernel=RefSpec(**spec), **kw)
    return g, r, np.asarray(ref_initial_state(width, payload, r.seed))


def _port(**opts):
    return get_runtime("pallas_step", device="cpu", **opts)


# ----------------------------------------------- dispatch and accounting


def test_plan_dispatch_and_refusal_message():
    """The reference's ``test_pallas_step_plan_dispatch_and_rejection_message``:
    every paper pattern gets a plan at moderate widths; past the gather cap
    a global pattern is refused with a reason naming the plans and the
    fused fallback; butterfly keeps the stride plan at any width; W = 1
    butterfly runs the all-gather plan; ``pair`` is no runtime option."""
    rt, ref = _port(), ref_runtime("pallas_step")
    for pattern, want in (("stencil_1d", "halo"), ("random_nearest", "halo"),
                          ("fft", "stride"), ("tree", "stride"),
                          ("spread", "allgather"), ("all_to_all", "allgather")):
        g, r, _ = _pair(pattern)
        assert rt.plan_for(g) == ref.plan_for(r) == (want, "")
    capped, ref_capped = _port(gather_width_cap=64), ref_runtime(
        "pallas_step", gather_width_cap=64)
    g, r, _ = _pair("spread", width=128)
    ok, why = capped.supports(g)
    assert not ok and not ref_capped.supports(r)[0]
    for needle in ("halo", "stride", "allgather", "fused", "gather_width_cap=64"):
        assert needle in why, why
    with pytest.raises(ValueError, match="cannot run"):
        capped.execute(g)
    g, r, _ = _pair("fft", width=128)
    assert capped.supports(g) == (True, "") and ref_capped.supports(r)[0]
    g1, r1, init = _pair("fft", width=1)
    assert rt.plan_for(g1)[0] == ref.plan_for(r1)[0] == "allgather"
    out = rt.execute(g1, init)
    np.testing.assert_array_equal(out, get_runtime("fused", device="cpu").execute(g1, init))
    np.testing.assert_allclose(out, np.asarray(ref.execute(r1, init)), **COMPUTE_TOL)
    for bad in ("pair", "smoke_signals"):
        with pytest.raises(ValueError, match="combine option"):
            _port(combine=bad)


@pytest.mark.parametrize("pattern", NON_HALO + ("stencil_1d", "nearest"))
@pytest.mark.parametrize("S", [None, 1, 2, 3, 8, 50])
def test_plan_depth_and_launches_equal_the_reference(pattern, S):
    """For every cap and (W, T): the plan, its resolved depth, the gathered
    depth and the launch count are the reference's (including the
    refusal past the cap)."""
    for cap in (None, 8, 16, 512):
        opts = {} if S is None else {"steps_per_launch": S}
        if cap is not None:
            opts["gather_width_cap"] = cap
        rt, ref = _port(**opts), ref_runtime("pallas_step", **opts)
        for width, steps in ((16, 7), (16, 2), (1, 5), (32, 1)):
            g, r, _ = _pair(pattern, width=width, steps=steps)
            case = f"cap={cap} W={width} T={steps}"
            assert rt.plan_for(g)[0] == ref.plan_for(r)[0], case
            if rt.plan_for(g)[0] is None:
                with pytest.raises(ValueError, match="cannot run"):
                    rt._schedule_for_graph(g)
                continue
            got, want = rt._schedule_for_graph(g), ref._schedule_for_graph(r)
            assert (got.kind, got.steps_per_launch) == (
                want.kind, want.steps_per_launch), case
            assert rt.dispatches_per_run(g) == ref.dispatches_per_run(r), case
            if got.kind != "halo":
                assert rt._gathered_steps_per_launch(g) == \
                    ref._gathered_steps_per_launch(r), case


def test_butterfly_dispatch_accounting():
    """The reference's ``test_pallas_step_butterfly_dispatch_accounting``:
    the stride plan is per step, so a butterfly run drops below T launches
    only when an explicit depth re-routes it to the all-gather plan (width
    under the cap); "auto" keeps the stride plan under the analytic model,
    as the reference's does (only a measured model may rank the blocked
    all-gather plan ahead)."""
    g, r, init = _pair("fft")  # W = 16, T = 7
    for opts, want in (({}, 7), ({"steps_per_launch": 3}, 3),
                       ({"steps_per_launch": 3, "gather_width_cap": 8}, 7),
                       ({"steps_per_launch": "auto"}, 7)):
        assert _port(**opts).dispatches_per_run(g) == want
        assert ref_runtime("pallas_step", **opts).dispatches_per_run(r) == want
    assert _port(steps_per_launch="auto")._schedule_for_graph(g)[:2] == ("stride", 1)
    # the capped explicit request still runs bit for bit (the stride plan)
    out = _port(steps_per_launch=3, gather_width_cap=8).execute(g, init)
    np.testing.assert_array_equal(out, get_runtime("fused", device="cpu").execute(g, init))


def test_explicit_depth_parser_equals_the_reference():
    never = lambda *_: pytest.fail("an explicit depth consulted the fit rule")  # noqa: E731
    for value in (None, 1, 2, 3, 8, 50, "4"):
        for total in (None, 0, 1, 2, 7, 1000):
            got = schedule._resolve_depth(value, lambda: -1, total)
            assert got == ref_schedule._resolve_depth(value, lambda: -1, total)
            assert schedule.resolve_steps_per_launch_gathered(
                value, width=16, block=16, fits=never, total_steps=total) == got
    for value in ("auto", 0, "0"):
        assert schedule.is_auto(value) and ref_schedule.is_auto(value)
        assert schedule._resolve_depth(value, lambda: 5, 9) == 5
        # "auto" reaches the chooser: the deepest depth <= T - 1 that pays
        # off and fits, as the reference's for the same budget
        fits = lambda s: s <= 4  # noqa: E731
        assert schedule.resolve_steps_per_launch_gathered(
            value, width=16, block=16, fits=fits, total_steps=9) == 4 == \
            ref_schedule.resolve_steps_per_launch_gathered(
                value, width=16, block=16, max_deps=3, payload=8, total_steps=9,
                vmem_budget=ref_schedule.gathered_working_set_bytes(16, 3, 4, 8))
    for value in (-1, -7):
        with pytest.raises(ValueError, match="must be >= 1"):
            schedule._resolve_depth(value, lambda: 1, 9)
    assert schedule.DEFAULT_GATHER_WIDTH_CAP == ref_schedule.DEFAULT_GATHER_WIDTH_CAP


# -------------------------------------------------------- operand tables


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("block,stride", [(16, 1), (16, 8), (8, 4), (2, 1), (8, 8),
                                          (4, 16), (8, 32)])
def test_stride_slot_tables_equal_the_reference(block, stride):
    """At B = W every stride is in-block; B < W (stride >= B) takes the
    off-block branch, the [local | partner] buffer a multi-device run
    would hold."""
    got, want = ps._stride_slot_tables(block, stride), ref_ps._stride_slot_tables(block, stride)
    _equal(got[0], want[0])
    _equal(got[1], want[1])
    assert got[2] == want[2] == (stride >= block)


@pytest.mark.parametrize("pattern,width", [("fft", 16), ("tree", 8), ("fft", 1),
                                           ("spread", 12), ("all_to_all", 6),
                                           ("trivial", 5), ("random_nearest", 9)])
def test_global_slot_operands_equal_the_reference(pattern, width):
    g, r, _ = _pair(pattern, width=width, fanout=4)
    for a, b in zip(ps._global_slot_operands(g), ref_ps._global_slot_operands(r)):
        _equal(a, b)


@pytest.mark.parametrize("width,fanout", [(12, 3), (16, 4), (7, 3), (5, 5), (3, 4)])
def test_spread_base_operands_equal_the_reference(width, fanout):
    g, r, _ = _pair("spread", width=width, fanout=fanout)
    for a, b in zip(ps._spread_base_operands(g), ref_ps._spread_base_operands(r)):
        _equal(a, b)


@pytest.mark.parametrize("rows,stride,tail", [(16, 1, (5,)), (16, 4, (3,)), (16, 8, ()),
                                              (2, 1, (2, 3)), (64, 16, (4,))])
def test_xor_swap_equals_the_reference(rows, stride, tail):
    x = np.random.default_rng(rows + stride).uniform(size=(rows, *tail)).astype(np.float32)
    want = np.asarray(ref_ps._xor_swap(jnp.asarray(x), stride))
    _equal(ps._xor_swap(torch.from_numpy(x), stride).numpy(), want)
    # on the runtime's (1, W, ...) states, along the row axis
    _equal(ps._xor_swap(torch.from_numpy(x)[None], stride, row_axis=1)[0].numpy(), want)
    _equal(want[np.arange(rows) ^ stride], want[np.arange(rows)][np.arange(rows) ^ stride])
    _equal(want, x[np.arange(rows) ^ stride])


def test_self_tables_equal_the_reference():
    i, w = ps._self_tables(6)
    ri, rw = ref_ps._self_tables(6)
    _equal(i.numpy(), ri)
    _equal(w.numpy(), rw)


# ------------------------------------------------------------- outputs


@pytest.mark.parametrize("pattern", BUTTERFLY)
@pytest.mark.parametrize("S", [1, 3, 8])
def test_butterfly_bit_for_bit_with_fused_and_close_to_the_reference(pattern, S):
    """The reference's ``test_pallas_step_butterfly_bit_identical_to_fused``:
    the stride plan at S = 1, the blocked all-gather plan's time-varying
    tables at S = 3 (a masked tail) and S = 8 (clamped to 6)."""
    g, r, init = _pair(pattern)
    out = _port(steps_per_launch=S).execute(g, init)
    np.testing.assert_array_equal(out, get_runtime("fused", device="cpu").execute(g, init))
    for name in ("pallas_step", "fused"):
        opts = {"steps_per_launch": S} if name == "pallas_step" else {}
        np.testing.assert_allclose(
            out, np.asarray(ref_runtime(name, **opts).execute(r, init)),
            err_msg=name, **COMPUTE_TOL)


@pytest.mark.parametrize("pattern", GLOBAL)
@pytest.mark.parametrize("S", [1, 4])
def test_global_patterns_match_the_reference(pattern, S):
    """The reference's ``test_pallas_step_global_patterns_match_fused``:
    spread's rotated tables and all_to_all (row mean at S = 1, static
    global tables at S = 4)."""
    g, r, init = _pair(pattern)
    out = _port(steps_per_launch=S).execute(g, init)
    for name, opts in (("pallas_step", {"steps_per_launch": S}), ("fused", {})):
        np.testing.assert_allclose(
            out, np.asarray(ref_runtime(name, **opts).execute(r, init)),
            err_msg=name, **COMPUTE_TOL)
    np.testing.assert_allclose(out, get_runtime("fused", device="cpu").execute(g, init),
                               **COMPUTE_TOL)


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("pattern", ["fft", "spread"])
def test_nonhalo_combine_modes_match_the_reference(pattern, combine):
    """The reference's ``test_pallas_step_nonhalo_combine_modes``: every
    combine option on the non-halo plans, per step and blocked."""
    g, r, init = _pair(pattern, steps=6)
    fused = get_runtime("fused", device="cpu").execute(g, init)
    for S in (1, 3):
        out = _port(combine=combine, steps_per_launch=S).execute(g, init)
        want = ref_runtime("pallas_step", combine=combine, steps_per_launch=S).execute(r, init)
        np.testing.assert_allclose(out, np.asarray(want), err_msg=f"S={S}", **COMPUTE_TOL)
        if pattern == "fft":
            np.testing.assert_array_equal(out, fused, err_msg=f"S={S}")


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("width", [5, 16])
def test_all_to_all_without_the_row_mean_matches_the_reference(S, width):
    g, r, init = _pair("all_to_all", width=width)
    out = _port(psum_mean=False, steps_per_launch=S).execute(g, init)
    want = ref_runtime("pallas_step", psum_mean=False, steps_per_launch=S).execute(r, init)
    np.testing.assert_allclose(out, np.asarray(want), **COMPUTE_TOL)
    mean = _port(steps_per_launch=S).execute(g, init)
    np.testing.assert_allclose(out, mean, **COMPUTE_TOL)


@pytest.mark.parametrize("pattern", NON_HALO)
@pytest.mark.parametrize("kind,iters", [("memory_bound", 3), ("empty", 0)])
@pytest.mark.parametrize("S", [1, 3])
def test_other_bodies_match_the_reference(pattern, kind, iters, S):
    g, r, init = _pair(pattern, kind=kind, iters=iters, width=8)
    out = _port(steps_per_launch=S).execute(g, init)
    want = ref_runtime("pallas_step", steps_per_launch=S).execute(r, init)
    tol = MEMORY_TOL if kind == "memory_bound" else COMPUTE_TOL
    np.testing.assert_allclose(out, np.asarray(want), **tol)
    if pattern in BUTTERFLY:
        np.testing.assert_array_equal(out, get_runtime("fused", device="cpu").execute(g, init))


@pytest.mark.parametrize("pattern", NON_HALO)
def test_one_step_is_the_body_alone(pattern):
    g, r, init = _pair(pattern, steps=1)
    want = np.asarray(ref_runtime("pallas_step").execute(r, init))
    for S in (1, 4):
        out = _port(steps_per_launch=S).execute(g, init)
        np.testing.assert_allclose(out, want, err_msg=f"S={S}", **COMPUTE_TOL)
        assert _port(steps_per_launch=S).dispatches_per_run(g) == 1


# ------------------------------------------------ what each plan launches


def _spy(monkeypatch):
    calls = []
    step = ps._kops.taskbench_step

    def spy(src, idx, wgt, act=None, **kw):
        calls.append((tuple(src.shape), tuple(wgt.shape), kw.get("combine"),
                      kw.get("steps_per_launch", 1), kw.get("radius")))
        return step(src, idx, wgt, act, **kw)

    monkeypatch.setattr(ps._kops, "taskbench_step", spy)
    return calls


def test_stride_step_is_one_pair_launch_on_the_stacked_halves(monkeypatch):
    g, _, init = _pair("tree", width=8, steps=5)
    rt = _port()
    calls = _spy(monkeypatch)
    rt.execute(g, init)
    assert calls == [((1, 16, 8), (1, 8, 1), "pair", 1, None)] * 5
    assert rt.dispatches_per_run(g) == len(calls)


@pytest.mark.parametrize("pattern,D", [("fft", 2), ("spread", 3), ("all_to_all", 16)])
def test_blocked_allgather_launches_k4_on_the_full_state(monkeypatch, pattern, D):
    """1 K3 + ceil((T-1)/S) K4 launches on (1, W) states, time-varying (1,
    S, W, D) tables for fft and spread, one static (1, W, D) pair for
    all_to_all; no radius declared (K4's cooperative form)."""
    g, _, init = _pair(pattern, steps=7)
    rt = _port(steps_per_launch=4)
    calls = _spy(monkeypatch)
    rt.execute(g, init)
    tables = (1, 16, D) if pattern == "all_to_all" else (1, 4, 16, D)
    assert calls == [((1, 16, 8), (1, 16, 1), "gather", 1, None)] + \
        [((1, 16, 8), tables, "gather", 4, None)] * 2
    assert rt.dispatches_per_run(g) == len(calls)


def test_row_mean_step_is_one_launch_on_the_mean_row(monkeypatch):
    g, _, init = _pair("all_to_all", steps=4)
    calls = _spy(monkeypatch)
    _port().execute(g, init)
    assert calls == [((1, 16, 8), (1, 16, 1), "gather", 1, None)] + \
        [((1, 1, 8), (1, 16, 1), "gather", 1, None)] * 3


def test_tables_are_built_once_and_sliced_per_step(monkeypatch):
    """Every table a run reads exists before the run: per step the loop
    picks a slice of a static stack (what lets a CUDA graph replay it)."""
    g, _, init = _pair("spread", width=12, steps=30)
    rt = _port()
    run = rt._build_eager(g)
    seen = set()
    step = ps._kops.taskbench_step

    def spy(src, idx, wgt, act=None, **kw):
        seen.add(idx.untyped_storage().data_ptr())
        return step(src, idx, wgt, act, **kw)

    monkeypatch.setattr(ps._kops, "taskbench_step", spy)
    x = torch.from_numpy(init.copy())
    a = run(x)
    b = run(x)
    assert torch.equal(a, b)
    assert len(seen) == 2  # the self tables at t = 0, then one stack
