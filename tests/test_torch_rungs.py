"""The paper's other four rungs in the PyTorch port, on the CPU: ``serialized``,
``bsp``, ``bsp_scan`` and ``overlap`` against the same backend of the JAX
package on one CPU device, fed the reference's initial states.

Each port backend gives the reference's ``supports`` verdict and reason on
every pattern, and on every pattern it supports matches the reference's run
of the same backend: the 11 patterns, the three bodies, one step, narrow
widths, ``overlap``'s and ``bsp``'s options, the mixed and heterogeneous
ensembles. ``host_calls_per_run`` equals the reference's own dispatch counts
(``dispatches_per_run``, ``ensemble_dispatches_per_run``), and
``dispatches_per_run`` equals the device operations the run's loop issues,
counted. ``_halo.make_halo_combine`` matches the reference's on every halo
pattern and edge case, and the port's ``combine_dependencies``.

Tolerances, as the reference's own tests state them: compute_bound and
empty ``rtol=1e-5, atol=1e-6``; memory_bound ``atol=1e-5`` (the sweep's mean
is summed in another order). The window combine sums its 2r+1 terms in
another order than the padded gather, so the rungs agree with ``fused`` to
these tolerances, not bit for bit.

Grains. The compute body is x <- 0.5 x + 0.1 per iteration, so every state
nears its fixed point 0.2 by half a grain's worth of halvings a step: at
grain 8 and T = 6 what the dataflow leaves is ~4e-15, below any tolerance,
and a run that dropped its combine would still pass. The parity cases run
at grain 1 (0.5^6 ~ 1.6e-2 of each state's spread survives T = 6), and
memory_bound, which has no fixed point, on every pattern; grain 8 stays as
an extra case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import GraphEnsemble as RefEnsemble
from repro.core import KernelSpec as RefSpec
from repro.core import TaskGraph as RefGraph
from repro.core import get_runtime as _ref_runtime
from repro.core.runtimes import _halo as ref_halo
from repro.core.task_kernels import initial_state as ref_initial_state
from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import _capture, _halo
from repro_torch.core.task_kernels import apply_kernel, combine_dependencies, initial_state
from repro_torch.kernels import _build, ops

PATTERNS = ["trivial", "no_comm", "stencil_1d", "stencil_1d_periodic", "dom",
            "tree", "fft", "all_to_all", "nearest", "spread", "random_nearest"]
HALO = ("no_comm", "stencil_1d", "stencil_1d_periodic", "dom", "nearest",
        "random_nearest")
RUNGS = ["serialized", "bsp", "bsp_scan", "overlap"]
COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_runtime(name, **options):
    return _ref_runtime(name, devices=jax.devices()[:1], **options)


def _spec_kw(kind, iters):
    return dict(kind=kind, iterations=iters, scratch=30)


def _pair(pattern, kind="compute_bound", iters=1, **kw):
    """The port's and the reference's graph of the same shape, and the
    reference's initial state (the reference tests' ``graph``: T = 6, W =
    16, payload 8, radius 2, seed 3; grain 1, where the dataflow shows)."""
    kw = dict(dict(steps=6, width=16, payload=8, radius=2, seed=3), **kw)
    g = TaskGraph(pattern=pattern, kernel=KernelSpec(**_spec_kw(kind, iters)), **kw)
    r = RefGraph(pattern=pattern, kernel=RefSpec(**_spec_kw(kind, iters)), **kw)
    return g, r, np.asarray(ref_initial_state(g.width, g.payload, r.seed))


def _tol(kind):
    return MEMORY_TOL if kind == "memory_bound" else COMPUTE_TOL


def _check_same_backend(backend, g, r, init, port_opts=(), ref_opts=None, kind=None):
    """Verdicts equal; where supported, the port (with and without the
    kernels' wrappers, each option set) against the reference's run."""
    ref = ref_runtime(backend, **(ref_opts or {}))
    want_ok = ref.supports(r)
    for opts in (port_opts or ({},)):
        for uk in (False, True):
            rt = get_runtime(backend, device="cpu", use_kernels=uk, **opts)
            assert rt.supports(g) == want_ok
    if not want_ok[0]:
        return None
    want = np.asarray(ref.execute(r, init))
    for opts in (port_opts or ({},)):
        for uk in (False, True):
            got = get_runtime(backend, device="cpu", use_kernels=uk, **opts).execute(g, init)
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, err_msg=f"{backend} {opts} uk={uk}",
                                       **_tol(kind or g.kernel.kind))
    return want


# -------------------------------------------------------------- registry


def test_available_runtimes_are_the_six_rungs():
    from repro_torch.core import available_runtimes

    assert available_runtimes() == ["bsp", "bsp_scan", "fused", "overlap",
                                    "pallas_step", "serialized"]


@pytest.mark.parametrize("backend,options", [
    ("bsp", {"unroll": 2}), ("bsp_scan", {"donate": True}),
    ("serialized", {"overlap": True}), ("overlap", {"donate": False}),
])
def test_rungs_refuse_options_they_do_not_read(backend, options):
    with pytest.raises(ValueError, match="unknown options"):
        get_runtime(backend, device="cpu", **options)


def test_overlap_refuses_an_unknown_transport():
    with pytest.raises(ValueError, match="unknown halo_via"):
        get_runtime("overlap", device="cpu", halo_via="nccl")


# -------------------------------------------------------------- patterns


@pytest.mark.parametrize("kind,iters", [("compute_bound", 1), ("memory_bound", 2),
                                        ("compute_bound", 8)],
                         ids=["grain1", "memory", "grain8"])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("backend", RUNGS)
def test_rung_matches_the_reference_backend(backend, pattern, kind, iters):
    """Grain 1 and memory_bound, where the dataflow shows in the result;
    grain 8 (at the FMA's fixed point) as an extra."""
    g, r, init = _pair(pattern, kind, iters)
    want = _check_same_backend(backend, g, r, init)
    if want is not None:  # and every rung agrees with fused
        np.testing.assert_allclose(
            get_runtime("fused", device="cpu").execute(g, init), want, **_tol(kind))


@pytest.mark.parametrize("kind,iters", [("compute_bound", 1), ("memory_bound", 4),
                                        ("empty", 0)])
@pytest.mark.parametrize("backend", RUNGS)
def test_rung_bodies_match_the_reference(backend, kind, iters):
    for pattern in ("stencil_1d", "nearest"):
        g, r, init = _pair(pattern, kind, iters)
        _check_same_backend(backend, g, r, init)


@pytest.mark.parametrize("pattern", ["stencil_1d", "fft", "spread"])
@pytest.mark.parametrize("backend", RUNGS)
def test_one_step_is_the_body_alone(backend, pattern):
    g, r, init = _pair(pattern, steps=1)
    want = _check_same_backend(backend, g, r, init)
    if want is not None:
        np.testing.assert_allclose(
            want, apply_kernel(torch.from_numpy(init.copy()), g.kernel).numpy(), **COMPUTE_TOL)


@pytest.mark.parametrize("pattern,width,radius", [
    ("nearest", 4, 5), ("nearest", 3, 2), ("nearest", 4, 2), ("nearest", 4, 3),
    ("random_nearest", 5, 3), ("random_nearest", 3, 4), ("stencil_1d", 1, 1),
    ("nearest", 1, 2), ("nearest", 2, 2), ("stencil_1d_periodic", 2, 1), ("dom", 2, 1),
    ("spread", 3, 1), ("fft", 2, 1),
])
@pytest.mark.parametrize("backend", RUNGS)
def test_narrow_widths_match_the_reference(backend, pattern, width, radius):
    """W <= 2r: windows wrap past one ring, r > B is refused (multi-hop),
    overlap refuses B < 2r; W = 1 degenerates."""
    g, r, init = _pair(pattern, iters=1, width=width, radius=radius, steps=5)
    _check_same_backend(backend, g, r, init)


@pytest.mark.parametrize("backend", RUNGS)
def test_one_point_butterfly_is_the_body_alone(backend):
    """W = 1 fft: the partner p XOR 1 lies outside the width, so each step
    is the body on the point itself, as in ``fused`` (the reference's bsp
    and bsp_scan do not run this graph on one device)."""
    g, _, init = _pair("fft", iters=1, width=1, steps=4)
    ok, why = get_runtime(backend, device="cpu").supports(g)
    assert ok == (backend != "overlap"), why
    if ok:
        np.testing.assert_allclose(get_runtime(backend, device="cpu").execute(g, init),
                                   get_runtime("fused", device="cpu").execute(g, init),
                                   **COMPUTE_TOL)


def test_radius_past_the_block_is_refused_with_the_reference_reason():
    g, r, _ = _pair("nearest", kind="empty", iters=0, steps=3, width=4, radius=5)
    for backend in ("bsp", "bsp_scan", "overlap"):
        ok, why = get_runtime(backend, device="cpu").supports(g)
        assert not ok and why == "halo radius 5 exceeds block 4 (multi-hop needed)"
        assert (ok, why) == ref_runtime(backend).supports(r)
        with pytest.raises(ValueError, match="radius"):
            get_runtime(backend, device="cpu").execute(g)


def test_serialized_limits_are_the_reference_ones():
    rt, ref = get_runtime("serialized", device="cpu"), ref_runtime("serialized")
    for kw in (dict(steps=200, width=1001, pattern="stencil_1d"),
               dict(steps=2, width=1025, pattern="all_to_all"),
               dict(steps=2, width=1024, pattern="all_to_all")):
        assert rt.supports(TaskGraph(**kw)) == ref.supports(RefGraph(**kw))
    assert rt.MAX_TASKS == 200_000
    assert not rt.supports(TaskGraph(steps=1000, width=2112))[0]
    ens = [dict(steps=150, width=1000), dict(steps=60, width=1000)]
    assert (rt.supports_ensemble(GraphEnsemble([TaskGraph(**k) for k in ens]))
            == ref.supports_ensemble(RefEnsemble([RefGraph(**k) for k in ens])))


# ------------------------------------------------------------- ablations


@pytest.mark.parametrize("pattern", ["stencil_1d", "dom", "nearest", "random_nearest"])
def test_overlap_variants_match_the_reference(pattern):
    """The build options change nothing in the result: each against the
    reference's run with the same option, and against the default."""
    g, r, init = _pair(pattern)
    base = get_runtime("overlap", device="cpu").execute(g, init)
    for opts in ({"overlap": False}, {"halo_via": "allgather"}, {"unroll": 2}):
        want = _check_same_backend("overlap", g, r, init, port_opts=(opts,), ref_opts=opts)
        np.testing.assert_allclose(want, base, **COMPUTE_TOL)
        np.testing.assert_array_equal(
            get_runtime("overlap", device="cpu", **opts).execute(g, init), base)


@pytest.mark.parametrize("pattern,kind", [("stencil_1d", "compute_bound"), ("fft", "compute_bound"),
                                          ("spread", "memory_bound"), ("nearest", "empty")])
def test_bsp_donate_toggle_gives_the_same_bits(pattern, kind):
    g, r, init = _pair(pattern, kind, 1 if kind == "compute_bound" else 3)
    outs = {}
    for donate in (True, False):
        _check_same_backend("bsp", g, r, init, port_opts=({"donate": donate},),
                            ref_opts={"donate": donate})
        outs[donate] = get_runtime("bsp", device="cpu", donate=donate).execute(g, init)
    np.testing.assert_array_equal(outs[True], outs[False])


def test_bsp_scan_unroll_changes_nothing():
    g, r, init = _pair("fft")
    _check_same_backend("bsp_scan", g, r, init, port_opts=({"unroll": 2},),
                        ref_opts={"unroll": 2})
    np.testing.assert_array_equal(
        get_runtime("bsp_scan", device="cpu", unroll=2).execute(g, init),
        get_runtime("bsp_scan", device="cpu").execute(g, init))


# ------------------------------------------------------------- ensembles


def _ensembles(specs):
    """(port ensemble, reference ensemble, the reference's inits)."""
    port = GraphEnsemble([TaskGraph(**s) for s in specs])
    ref = RefEnsemble([RefGraph(**{**s, "kernel": RefSpec(**vars(s["kernel"]))})
                       if "kernel" in s else RefGraph(**s) for s in specs])
    inits = tuple(np.asarray(ref_initial_state(g.width, g.payload, g.seed))
                  for g in ref.members)
    return port, ref, inits


# The ensembles' members run at grains 1 and 2 (the reference tests' 8, 32
# and 4 reach the FMA's fixed point within T = 6; see the module docstring),
# two specs mixed.
G1, G2 = KernelSpec("compute_bound", 1), KernelSpec("compute_bound", 2)


def _mixed(steps=6):
    base = dict(steps=steps, width=16, payload=8)
    return [dict(pattern="stencil_1d", kernel=G1, seed=0, **base),
            dict(pattern="nearest", radius=2, kernel=G2, seed=1, **base),
            dict(pattern="fft", kernel=G1, seed=2, **base)]


def _hetero():
    base = dict(width=16, payload=8)
    return [dict(steps=3, pattern="stencil_1d", kernel=G1, seed=0, **base),
            dict(steps=6, pattern="nearest", radius=2, kernel=G2, seed=1, **base),
            dict(steps=4, pattern="fft", kernel=G1, seed=2, **base),
            dict(steps=1, pattern="dom", kernel=G1, seed=3, **base)]


def _ragged(halo_only=False):
    """Members of other widths and payloads (the tuple path); overlap's set
    keeps to halo patterns."""
    if halo_only:
        return [dict(steps=5, width=16, payload=8, pattern="stencil_1d", kernel=G1, seed=1),
                dict(steps=2, width=8, payload=4, pattern="nearest", radius=2, kernel=G2,
                     seed=2),
                dict(steps=7, width=32, payload=8, pattern="dom", kernel=G1, seed=3)]
    return [dict(steps=5, width=16, payload=8, pattern="stencil_1d", kernel=G1, seed=1),
            dict(steps=2, width=8, payload=4, pattern="all_to_all", kernel=G2, seed=2),
            dict(steps=7, width=32, payload=8, pattern="spread", fanout=3, kernel=G1, seed=3)]


@pytest.mark.parametrize("members", ["mixed", "hetero", "ragged", "memory"])
@pytest.mark.parametrize("backend", RUNGS)
def test_ensemble_members_match_the_reference(backend, members):
    """Each member of the port's ensemble run against the reference's run of
    the same backend, and against the member run alone; overlap keeps the
    members it supports, as the reference's tests do."""
    specs = {"mixed": _mixed(), "hetero": _hetero(), "ragged": _ragged(backend == "overlap"),
             "memory": [dict(s, kernel=KernelSpec("memory_bound", 3, 20)) for s in _hetero()]
             }[members]
    rt = get_runtime(backend, device="cpu")
    specs = [s for s in specs if rt.supports(TaskGraph(**s))[0]]
    assert len(specs) >= 2
    port, ref, inits = _ensembles(specs)
    assert rt.supports_ensemble(port) == ref_runtime(backend).supports_ensemble(ref)
    want = ref_runtime(backend).execute_ensemble(ref, inits)
    for uk in (False, True):
        got = get_runtime(backend, device="cpu", use_kernels=uk).execute_ensemble(port, inits)
        for k, (g, a, b) in enumerate(zip(port.members, got, want)):
            tol = _tol(g.kernel.kind)
            np.testing.assert_allclose(a, np.asarray(b), err_msg=f"member {k}", **tol)
            np.testing.assert_allclose(a, rt.execute(g, inits[k]), err_msg=f"member {k}", **tol)


# ----------------------------------------------------------- host calls


@pytest.mark.parametrize("backend", RUNGS + ["fused", "pallas_step"])
def test_host_calls_equal_the_reference_dispatch_counts(backend):
    """The reference's dispatch accounting (its tests' tables): bsp T,
    bsp_scan and overlap 1, serialized T x W; the ensembles' round-robin
    sums; 1 for the one-graph backends."""
    rt = get_runtime(backend, device="cpu")
    ref = ref_runtime(backend)
    g, r, _ = _pair("stencil_1d", steps=7)
    want = 1 if backend == "pallas_step" else ref.dispatches_per_run(r)
    assert rt.host_calls_per_run(g) == want
    assert {"bsp": 7, "bsp_scan": 1, "overlap": 1, "serialized": 7 * 16,
            "fused": 1, "pallas_step": 1}[backend] == want
    two = [dict(steps=3, width=8), dict(steps=7, width=8)]
    port, refe, _ = _ensembles(two)
    mixed, ref_mixed, _ = _ensembles(_mixed(steps=7))
    tables = {"bsp": (3 + 7, 7 * 3), "serialized": ((3 + 7) * 8, mixed.num_tasks),
              "bsp_scan": (1, 1), "overlap": (1, 1), "fused": (1, 1), "pallas_step": (1, 1)}
    assert (rt.host_calls_per_run(port), rt.host_calls_per_run(mixed)) == tables[backend]
    if backend in ("bsp", "serialized", "bsp_scan", "fused"):
        assert rt.host_calls_per_run(port) == ref.ensemble_dispatches_per_run(refe)
        assert rt.host_calls_per_run(mixed) == ref.ensemble_dispatches_per_run(ref_mixed)
    if backend == "overlap":
        halo = GraphEnsemble(mixed.members[:2])
        assert rt.host_calls_per_run(halo) == ref.ensemble_dispatches_per_run(
            RefEnsemble(ref_mixed.members[:2])) == 1


def test_serialized_counts_each_task_as_a_host_call():
    g, _, init = _pair("stencil_1d", steps=4)
    ops.reset_launch_counts()
    get_runtime("serialized", device="cpu").execute(g, init)
    assert _build.HOST_CALLS == ops.host_calls() == 4 * 16
    ops.reset_launch_counts()
    assert ops.host_calls() == 0


class _OpCounter(TorchDispatchMode):
    """Counts the operations dispatched to a device, views left out."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def _count_run(run, x):
    """Operations one run issues: a host loop's programs (its input staged
    outside), or the eager loop."""
    if isinstance(run, _capture.HostLoop):
        run.stage(x)
        with _OpCounter() as c:
            run.run()
        return c.n
    with _OpCounter() as c:
        run(x)
    return c.n


RUNG_OPTIONS = [("bsp", {}), ("bsp", {"donate": False}), ("bsp_scan", {}),
                ("overlap", {}), ("overlap", {"halo_via": "allgather"}),
                ("overlap", {"overlap": False}), ("serialized", {})]


@pytest.mark.parametrize("spec", [KernelSpec("compute_bound", 3),
                                  KernelSpec("memory_bound", 2, 10), KernelSpec("empty")],
                         ids=["compute", "memory", "empty"])
@pytest.mark.parametrize("backend,options", RUNG_OPTIONS,
                         ids=[f"{b}-{'-'.join(o) or 'default'}" for b, o in RUNG_OPTIONS])
def test_dispatches_count_what_the_loop_issues(backend, options, spec):
    """``dispatches_per_run`` is the device operations of a run, counted on
    every pattern the backend supports (W = 8, and W = 4 where a window
    fills the block); with the kernels each body's plain operations become
    one launch."""
    for pattern in PATTERNS:
        for width in (8, 4):
            g = TaskGraph(steps=5, width=width, payload=4, radius=2, pattern=pattern, kernel=spec)
            rt = get_runtime(backend, device="cpu", **options)
            if not rt.supports(g)[0]:
                continue
            x = initial_state(width, 4, 0, "cpu")
            n = _count_run(rt.build(g), x)
            assert n == rt.dispatches_per_run(g), (pattern, width)
            with _OpCounter() as b:
                apply_kernel(x, spec)
            rk = get_runtime(backend, device="cpu", use_kernels=True, **options)
            bodies = rk.body_launches_per_run(g)
            assert rk.dispatches_per_run(g) == n - bodies * (b.n - 1 if bodies else 0), \
                (pattern, width)
            assert (bodies == 0) == (spec.kind == "empty")


@pytest.mark.parametrize("backend,options", RUNG_OPTIONS[:-1] + [("serialized", {})])
def test_ensemble_dispatches_count_what_the_loop_issues(backend, options):
    """The ensemble's device operations, counted; and with one body for
    every member, its K1/K2 launches (``body_launches_per_run``: bsp and
    serialized within each member's own T, the one-graph loops at every
    timestep of the run) are what the kernels take out of that count."""
    rt = get_runtime(backend, device="cpu", **options)
    rk = get_runtime(backend, device="cpu", use_kernels=True, **options)
    spec = KernelSpec("compute_bound", 3)
    for members in (_hetero() + _ragged(backend == "overlap"),
                    [dict(s, kernel=spec) for s in _hetero() + _ragged(backend == "overlap")]):
        specs = [s for s in members if rt.supports(TaskGraph(**s))[0]]
        ens = GraphEnsemble([TaskGraph(**s) for s in specs])
        xs = tuple(initial_state(g.width, g.payload, k, "cpu")
                   for k, g in enumerate(ens.members))
        n = _count_run(rt.build_ensemble(ens), xs)
        assert n == rt.ensemble_dispatches_per_run(ens)
    bodies = rk.body_launches_per_run(ens)
    assert bodies > 0
    assert rk.ensemble_dispatches_per_run(ens) == n - bodies * (2 * spec.iterations - 1)


def test_measure_carries_the_host_calls():
    g = TaskGraph(steps=3, width=8, pattern="stencil_1d", payload=4,
                  kernel=KernelSpec("compute_bound", 2))
    for backend, calls in (("bsp", 3), ("bsp_scan", 1), ("overlap", 1), ("serialized", 24)):
        rt = get_runtime(backend, device="cpu")
        s, st = rt.measure(g, reps=2, warmup=1)
        assert st.host_calls == calls and st.dispatches == rt.dispatches_per_run(g)
        assert s.num_tasks == 24 and s.wall_time == st.best > 0
        assert st.capture_s is None and st.graph_nodes is None
    ens = GraphEnsemble([g, TaskGraph(steps=2, width=8, pattern="fft", payload=4)])
    _, st = get_runtime("bsp", device="cpu").measure_ensemble(ens, reps=1)
    assert st.host_calls == 5


# -------------------------------------------------------------- the combine


def _combine_cases():
    for pattern in HALO:
        wide = pattern in ("nearest", "random_nearest")
        for width, radius in ((16, 2), (9, 3), (5, 2), (3, 2), (2, 1), (1, 1)):
            if wide and radius > width:
                continue  # the refused multi-hop case
            if wide or (width, radius) != (9, 3):
                yield pattern, width, radius


@pytest.mark.parametrize("pattern,width,radius", list(_combine_cases()))
def test_halo_combine_matches_the_reference(pattern, width, radius):
    """The whole block from the wrap-extended state, the interior from the
    block itself, and the top and bottom boundary rows from their 3r-row
    contexts, at the reference's (n, p0); and the whole block against
    ``combine_dependencies`` where the window holds no point twice (below
    2r + 1 points random_nearest's window counts a kept point once per
    offset, as the reference's does, and its dependency set once)."""
    g, rg, _ = _pair(pattern, width=width, radius=radius, seed=5)
    comb = _halo.make_halo_combine(g)
    ref_comb = ref_halo.make_halo_combine(rg)
    r = comb.r
    x = np.random.default_rng(width).uniform(0.1, 1.0, (width, 8)).astype(np.float32)
    xt = torch.from_numpy(x)
    left, right = _halo.exchange_halos(xt, r)
    ext = torch.cat([left, xt, right])
    cases = [(ext, width, 0)]
    if width > 2 * r > 0:
        cases.append((xt, width - 2 * r, r))
    if width >= 2 * r > 0:
        cases += [(torch.cat([left, xt[:2 * r]]), r, 0),
                  (torch.cat([xt[width - 2 * r:], right]), r, width - r)]
    for ctx, n, p0 in cases:
        got = comb(ctx, n, p0)
        want = np.asarray(ref_comb(jnp.asarray(ctx.numpy()), n, jnp.int32(p0)))
        assert got.shape == (n, 8)
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"n={n} p0={p0}", **COMPUTE_TOL)
    if pattern != "random_nearest" or width >= 2 * radius + 1:
        idx, mask = g.dependency_arrays()
        want = combine_dependencies(xt, torch.from_numpy(idx[0]).long(),
                                    torch.from_numpy(mask[0]))
        np.testing.assert_allclose(comb(ext, width, 0).numpy(), want.numpy(), **COMPUTE_TOL)


def test_halo_tables_equal_the_reference():
    for pattern in HALO + ("trivial",):
        g, rg, _ = _pair(pattern, radius=3, seed=7)
        np.testing.assert_array_equal(_halo.offset_keep(g), ref_halo.offset_keep(rg))
        a, b = _halo.random_keep_table(g), ref_halo.random_keep_table(rg)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not halo-expressible"):
        _halo.make_halo_combine(TaskGraph(steps=2, width=8, pattern="fft"))


def test_one_device_exchange_and_gathers():
    """One tensor is the one-device case: the wrap as views, the state
    itself, the row mean; past the block the wrap mod B (the reference's
    multi-hop on one device). Asking for more devices with one tensor
    raises, naming the shards and their mesh."""
    x = torch.arange(12.0).reshape(6, 2)
    left, right = _halo.exchange_halos(x, 2)
    assert torch.equal(left, x[4:]) and torch.equal(right, x[:2])
    assert left.data_ptr() == x[4:].data_ptr()  # views of the state, no copy
    assert _halo.gather_global(x) is x
    assert torch.equal(_halo.global_mean(x, 6), x.mean(dim=0))
    for fn, args in ((_halo.exchange_halos, (x, 1, 2)), (_halo.gather_global, (x, 4)),
                     (_halo.global_mean, (x, 6, 2))):
        with pytest.raises(ValueError, match="ShardMesh"):
            fn(*args)
    left, right = _halo.exchange_halos(x, 7)
    assert torch.equal(left, x[np.arange(-7, 0) % 6])
    assert torch.equal(right, x[np.arange(6, 13) % 6])
