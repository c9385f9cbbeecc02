"""Parity of the port's ensembles (`GraphEnsemble` on ``fused`` and
``pallas_step``, and ``pallas_step``'s launch plans) with the JAX package's,
on the CPU.

The reference runs on one CPU device; the port runs its kernels' plain
versions, fed the reference's initial states. Each of the reference's
ensemble tests (``tests/test_runtimes.py``: the halo patterns at K in {1, 4},
mixed horizons at S in {1, 3, 8}, the mixed-spec and mixed-plan tuples, the
pipelined stacked and tuple ensembles, the members against ``fused``, mixed
shapes, the launch accounting, a single member, ``measure_ensemble``) runs
as a case here against the reference's own ``pallas_step`` and ``fused``.
``stacking_verdict``, ``_ensemble_steps_per_launch`` and
``ensemble_dispatches_per_run`` equal the reference's over a grid of K, S,
pipeline and ensemble kinds. The port's launch plans, stepped on the host,
equal its ``build_ensemble`` bit for bit and the reference's launch plans
stepped the same way within tolerance; eviction and admission edit the
plan's act rows and carry as the reference's do.

Tolerances: compute_bound and empty ``rtol=1e-5, atol=1e-6``; memory_bound
``atol=1e-5`` (the sweep's mean is summed in another order). Sizes: W <= 48,
T <= 10.
"""
import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import GraphEnsemble as RefEnsemble
from repro.core import KernelSpec as RefSpec
from repro.core import TaskGraph as RefGraph
from repro.core import get_runtime as ref_runtime
from repro.core.task_kernels import initial_state as ref_initial_state
from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes.base import EnsembleLaunchPlan
from repro_torch.core.task_kernels import apply_kernel

COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=0, atol=1e-5)
HALO = ("trivial", "no_comm", "stencil_1d", "stencil_1d_periodic", "dom",
        "nearest", "random_nearest")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _member(steps=6, width=16, payload=8, pattern="stencil_1d", kind="compute_bound",
            iters=8, scratch=32, seed=0, **kw):
    """One member as a dict of TaskGraph fields (kernel as a tuple)."""
    return dict(steps=steps, width=width, payload=payload, pattern=pattern,
                kernel=(kind, iters, scratch), seed=seed, **kw)


def _pair(members):
    """The ensemble in both packages, and the reference's initial states."""
    ours, refs = [], []
    for m in members:
        kind, iters, scratch = m["kernel"]
        fields = {k: v for k, v in m.items() if k != "kernel"}
        ours.append(TaskGraph(kernel=KernelSpec(kind, iters, scratch), **fields))
        refs.append(RefGraph(kernel=RefSpec(kind, iters, scratch), **fields))
    inits = [np.asarray(ref_initial_state(g.width, g.payload, g.seed)) for g in refs]
    return GraphEnsemble(ours), RefEnsemble(refs), inits


def _tol(g):
    return MEMORY_TOL if g.kernel.kind == "memory_bound" else COMPUTE_TOL


def _ref_opts(opts):
    return {("use_pallas" if k == "use_kernels" else k): v for k, v in opts.items()}


def _check_case(members, backend="pallas_step", **opts):
    """The port's ensemble run against the reference's (the same backend,
    options and inits), member by member, and each member against the
    port's ``fused`` running it alone. Returns the port's outputs."""
    ens, ref_ens, inits = _pair(members)
    rt = get_runtime(backend, device="cpu", **opts)
    assert rt.supports_ensemble(ens) == (True, "")
    outs = rt.execute_ensemble(ens, inits)
    want = ref_runtime(backend, **_ref_opts(opts)).execute_ensemble(ref_ens, inits)
    alone = get_runtime("fused", device="cpu")
    for k, (g, out, ref, init) in enumerate(zip(ens.members, outs, want, inits)):
        assert out.shape == (g.width, g.payload)
        np.testing.assert_allclose(out, np.asarray(ref), err_msg=f"member {k}", **_tol(g))
        np.testing.assert_allclose(out, alone.execute(g, init),
                                   err_msg=f"member {k} alone", **_tol(g))
    return outs


# ------------------------------------ the reference's ensemble tests as cases


@pytest.mark.parametrize("pattern", HALO)
@pytest.mark.parametrize("K", [1, 4])
def test_halo_patterns_ensembles(pattern, K):
    """``test_pallas_step_halo_patterns_ensembles``: every halo pattern,
    stacked, for K in {1, 4}."""
    members = [_member(steps=5, pattern=pattern, radius=2, seed=k) for k in range(K)]
    _check_case(members)


@pytest.mark.parametrize("S", [1, 3, 8])
def test_blocked_hetero_steps_ensemble(S):
    """``test_pallas_step_blocked_hetero_steps_ensemble``: members end
    mid-launch, frozen by the act rows at inner-step granularity."""
    members = [_member(steps=t, seed=k) for k, t in enumerate((3, 6, 1, 5))]
    _check_case(members, steps_per_launch=S)


def test_blocked_mixed_spec_tuple_ensemble():
    """``test_pallas_step_blocked_mixed_spec_tuple_ensemble``: kernels,
    patterns and T differ, one shared blocked cadence."""
    members = [_member(steps=5, seed=0),
               _member(steps=3, pattern="nearest", radius=2, iters=32, seed=1),
               _member(steps=7, pattern="no_comm", kind="memory_bound", iters=2, seed=2)]
    _check_case(members, steps_per_launch=4)


@pytest.mark.parametrize("S", [3, 4])
def test_pipeline_hetero_stacked_ensemble(S):
    """``test_pallas_step_pipeline_hetero_stacked_ensemble``: pipelined
    equals serial bit for bit, each member within tolerance."""
    members = [_member(steps=t, width=48, seed=k) for k, t in enumerate((3, 10, 6, 1))]
    on = _check_case(members, steps_per_launch=S)
    off = _check_case(members, steps_per_launch=S, pipeline=False)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pipeline", [True, False])
def test_pipeline_tuple_mixed_applicability(pipeline):
    """``test_pallas_step_pipeline_tuple_mixed_applicability``: each tuple
    member pipelines by its own gate (no_comm has no halo; radius 4 at S = 4
    leaves no interior at W = 48)."""
    members = [_member(steps=9, width=48, seed=0),
               _member(steps=5, width=48, pattern="no_comm", kind="memory_bound",
                       iters=2, seed=1),
               _member(steps=7, width=48, pattern="nearest", radius=4, iters=32, seed=2)]
    _check_case(members, steps_per_launch=4, pipeline=pipeline)


def _mixed_plans():
    return [_member(steps=6, seed=0), _member(steps=4, pattern="fft", iters=4, seed=1),
            _member(steps=7, pattern="spread", fanout=3, iters=16, seed=2),
            _member(steps=2, pattern="all_to_all", seed=3)]


@pytest.mark.parametrize("S", [1, 4])
def test_mixed_plan_ensemble(S):
    """``test_pallas_step_mixed_plan_ensemble``: halo, stride and
    all-gather members; the per-step cadence launches every member every
    lockstep step."""
    members = _mixed_plans()
    _check_case(members, steps_per_launch=S)
    ens, ref_ens, _ = _pair(members)
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=S)
    assert rt.ensemble_dispatches_per_run(ens) == len(members) * ens.steps == \
        ref_runtime("pallas_step", steps_per_launch=S).ensemble_dispatches_per_run(ref_ens)


def _mixed_ensemble(steps=6):
    return [_member(steps=steps, seed=0),
            _member(steps=steps, pattern="nearest", radius=2, iters=32, seed=1),
            _member(steps=steps, pattern="fft", iters=4, seed=2)]


@pytest.mark.parametrize("backend,opts", [("fused", {}), ("fused", {"use_kernels": True}),
                                          ("pallas_step", {})])
def test_ensemble_members_match_fused(backend, opts):
    """``test_ensemble_members_match_fused``: a stackable mixed ensemble."""
    _check_case(_mixed_ensemble(), backend, **opts)


def _hetero_shapes(steps=(5, 5, 5)):
    return [_member(steps=steps[0], seed=1, iters=16),
            _member(steps=steps[1], width=8, payload=4, pattern="all_to_all", seed=2, iters=16),
            _member(steps=steps[2], width=32, pattern="spread", fanout=3, seed=3, iters=16)]


@pytest.mark.parametrize("backend,opts", [("fused", {}), ("fused", {"use_kernels": True}),
                                          ("pallas_step", {})])
@pytest.mark.parametrize("steps", [(5, 5, 5), (5, 2, 7)])
def test_ensemble_heterogeneous_shapes(backend, opts, steps):
    """``test_ensemble_heterogeneous_shapes`` and
    ``test_ensemble_heterogeneous_steps_nonstackable``: the tuple paths."""
    ens, _, _ = _pair(_hetero_shapes(steps))
    assert not ens.stackable
    _check_case(_hetero_shapes(steps), backend, **opts)


@pytest.mark.parametrize("backend,opts", [("fused", {}), ("fused", {"use_kernels": True}),
                                          ("pallas_step", {})])
def test_ensemble_heterogeneous_steps_match_fused(backend, opts):
    """``test_ensemble_heterogeneous_steps_match_fused``: masked freezing
    (pallas_step takes the fft member on its stride plan, so the ensemble
    is a tuple)."""
    members = [_member(steps=3, seed=0),
               _member(steps=6, pattern="nearest", radius=2, iters=32, seed=1),
               _member(steps=4, pattern="fft", iters=4, seed=2),
               _member(steps=1, pattern="dom", seed=3)]
    _check_case(members, backend, **opts)


def test_ensemble_validation_and_metadata():
    """``test_ensemble_validation`` and
    ``test_ensemble_heterogeneous_steps_metadata``."""
    g = TaskGraph(steps=4, width=8)
    with pytest.raises(ValueError):
        GraphEnsemble([])
    with pytest.raises(ValueError):
        GraphEnsemble([g, TaskGraph(steps=4, width=4)]).dependency_arrays()
    ens = GraphEnsemble([TaskGraph(steps=4, width=8), TaskGraph(steps=7, width=8),
                         TaskGraph(steps=1, width=8)])
    assert ens.steps == 7 and ens.member_steps == (4, 7, 1)
    assert ens.heterogeneous_steps and ens.num_tasks == (4 + 7 + 1) * 8
    assert not GraphEnsemble([g]).heterogeneous_steps


def test_ensemble_heterogeneous_steps_dispatch_accounting():
    """``test_ensemble_heterogeneous_steps_dispatch_accounting``'s
    pallas_step counts, the port's and the reference's alike."""
    stacked = [dict(steps=3, width=8), dict(steps=7, width=8)]
    mixed = [dict(steps=3, width=8), dict(steps=7, width=8, kernel_iters=99)]
    cases = ((stacked, {}, 7), (stacked, {"steps_per_launch": 3, "pipeline": False}, 3),
             (stacked, {"steps_per_launch": 3}, 5), (mixed, {}, 14),
             (mixed, {"steps_per_launch": 3, "pipeline": False}, 6),
             (mixed, {"steps_per_launch": 3}, 10))
    for fields, opts, want in cases:
        ours = GraphEnsemble([TaskGraph(steps=f["steps"], width=8, kernel=KernelSpec(
            "compute_bound", f.get("kernel_iters", 16))) for f in fields])
        refs = RefEnsemble([RefGraph(steps=f["steps"], width=8, kernel=RefSpec(
            "compute_bound", f.get("kernel_iters", 16))) for f in fields])
        got = get_runtime("pallas_step", device="cpu", **opts).ensemble_dispatches_per_run(ours)
        assert got == want == ref_runtime(
            "pallas_step", **opts).ensemble_dispatches_per_run(refs), (opts, fields)


@pytest.mark.parametrize("backend", ["fused", "pallas_step"])
def test_ensemble_single_member_matches_single_graph(backend):
    """``test_ensemble_single_member_matches_single_graph``."""
    ens, ref_ens, inits = _pair([_member(radius=2, seed=3)])
    rt = get_runtime(backend, device="cpu")
    out = rt.execute_ensemble(ens, inits)[0]
    np.testing.assert_allclose(out, rt.execute(ens.members[0], inits[0]), rtol=1e-6)
    np.testing.assert_allclose(
        out, np.asarray(ref_runtime(backend).execute_ensemble(ref_ens, inits)[0]),
        **COMPUTE_TOL)


@pytest.mark.parametrize("backend", ["fused", "pallas_step"])
def test_measure_ensemble_aggregates(backend):
    """``test_measure_ensemble_aggregates``: one sample of the ensemble's
    wall, FLOPs and tasks summed; and ``measure_launch_plan`` on
    pallas_step."""
    ens, _, _ = _pair(_mixed_ensemble(steps=4))
    rt = get_runtime(backend, device="cpu")
    sample, stats = rt.measure_ensemble(ens, reps=2, warmup=1)
    assert sample.num_tasks == ens.num_tasks
    assert sample.total_flops == pytest.approx(ens.total_flops())
    assert sample.wall_time == stats.best > 0 and len(stats.walls) == 2
    assert stats.dispatches == rt.ensemble_dispatches_per_run(ens)
    assert stats.capture_s is None and stats.graph_nodes is None  # eager on the CPU
    if backend == "pallas_step":
        sample, stats = rt.measure_launch_plan(ens, reps=2, warmup=1)
        assert sample.num_tasks == ens.num_tasks and stats.best > 0
        assert stats.dispatches == 1 + (ens.steps - 1)
    else:
        with pytest.raises(NotImplementedError, match="pallas_step"):
            rt.build_ensemble_launches(ens)


def test_ensemble_inits_are_checked_and_converted():
    ens, _, inits = _pair(_mixed_ensemble())
    rt = get_runtime("fused", device="cpu")
    with pytest.raises(ValueError, match="3 ensemble members"):
        rt.execute_ensemble(ens, inits[:2])
    xs = rt._ensemble_inits(ens, inits)
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float32 for x in xs)
    np.testing.assert_array_equal(xs[1].numpy(), inits[1])
    own = rt._ensemble_inits(ens)
    assert torch.equal(own[2], rt._init(ens.members[2], None))


def test_ensembles_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ("fused", "pallas_step"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_runtime(name).execute_ensemble(GraphEnsemble([TaskGraph(steps=2, width=4)]))


# --------------------------------------------- fused: operations counted


class _OpCounter(TorchDispatchMode):
    """Counts the operations dispatched to a device, views left out."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("members", [
    [(4, "stencil_1d", ("compute_bound", 3, 8))] * 3,
    [(4, "stencil_1d", ("compute_bound", 3, 8)), (2, "fft", ("compute_bound", 3, 8)),
     (4, "nearest", ("empty", 3, 8))],
    [(4, "stencil_1d", ("compute_bound", 3, 8)), (3, "all_to_all", ("memory_bound", 2, 10))],
    [(3, "all_to_all", ("memory_bound", 2, 10)), (4, "spread", ("compute_bound", 0, 8))],
    [(4, "stencil_1d", ("compute_bound", 3, 8)), (4, "stencil_1d", ("compute_bound", 3, 8)),
     (2, "all_to_all", ("memory_bound", 2, 10), 4)],
], ids=["uniform", "mixed-spec", "hetero", "all_to_all", "tuple"])
def test_fused_ensemble_dispatches_count_what_the_loop_issues(members):
    """``ensemble_dispatches_per_run`` of ``fused`` is the device
    operations its eager loop issues; with the kernels each body
    application's plain operations become one launch (one application a
    step over all rows when a stacked ensemble's spec is uniform, else one
    per member a step, frozen members included)."""
    graphs = [TaskGraph(steps=m[0], width=m[3] if len(m) > 3 else 8, pattern=m[1],
                        payload=4, kernel=KernelSpec(*m[2]), seed=i)
              for i, m in enumerate(members)]
    ens = GraphEnsemble(graphs)
    plain = get_runtime("fused", device="cpu")
    fn = plain.build_ensemble(ens)
    xs = plain._ensemble_inits(ens)
    with _OpCounter() as c:
        fn(xs)
    assert c.n == plain.ensemble_dispatches_per_run(ens)
    specs = [g.kernel for g in graphs]
    if plain._is_stacked(ens) and len(set(specs)) == 1:
        specs = specs[:1]
    saved = 0
    for spec in specs:
        with _OpCounter() as b:
            apply_kernel(xs[0], spec)
        launch = 0 if spec.kind == "empty" or spec.iterations == 0 else 1
        saved += ens.steps * (b.n - launch)
    kernels = get_runtime("fused", device="cpu", use_kernels=True)
    assert kernels.ensemble_dispatches_per_run(ens) == c.n - saved
    assert plain._is_stacked(ens) == (len({g.width for g in graphs}) == 1)


# ------------------------- the dispatch grid against the reference's


def _grid_members(kind, K):
    if kind == "uniform":
        return [_member(steps=10, width=48, seed=k) for k in range(K)]
    if kind == "mixed-spec":
        pool = [_member(steps=10, width=48, seed=0),
                _member(steps=8, width=48, pattern="nearest", radius=2, iters=32, seed=1),
                _member(steps=10, width=48, pattern="no_comm", kind="memory_bound",
                        iters=2, seed=2),
                _member(steps=3, width=48, pattern="dom", iters=4, seed=3)]
    elif kind == "mixed-width":
        pool = [_member(steps=10, width=48, seed=0), _member(steps=9, width=32, seed=1),
                _member(steps=10, width=16, pattern="nearest", radius=2, seed=2),
                _member(steps=10, width=24, seed=3)]
    else:
        pool = _mixed_plans()
    return pool[:K]


@pytest.mark.parametrize("kind", ["uniform", "mixed-spec", "mixed-width", "mixed-plan"])
@pytest.mark.parametrize("K", [1, 3, 4])
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("pipeline", [True, False])
def test_stacking_depth_and_launches_equal_the_reference(kind, K, S, pipeline):
    ens, ref_ens, _ = _pair(_grid_members(kind, K))
    opts = dict(steps_per_launch=S, pipeline=pipeline)
    rt, ref = get_runtime("pallas_step", device="cpu", **opts), ref_runtime("pallas_step", **opts)
    assert rt.stacking_verdict(ens) == ref.stacking_verdict(ref_ens)
    assert rt._ensemble_steps_per_launch(ens) == ref._ensemble_steps_per_launch(ref_ens)
    assert rt.ensemble_dispatches_per_run(ens) == ref.ensemble_dispatches_per_run(ref_ens)


def test_stacking_verdict_names_each_failed_requirement():
    ens, _, _ = _pair([_member(), _member(width=8, iters=4), _member(pattern="fft")])
    ok, why = get_runtime("pallas_step", device="cpu").stacking_verdict(ens)
    assert not ok
    for needle in ("widths [8, 16]", "mixed kernels", "member 2 (fft) resolves the stride plan"):
        assert needle in why, why


# ----------------------------------------------------------- launch plans


def _step_plan(lp: EnsembleLaunchPlan, inits, acts=None, admit=None):
    """A launch plan stepped on the host: init, then every launch with its
    act row (``acts``, default the plan's), ``admit`` = (launch, slot, init)
    admitted before that launch."""
    acts = lp.acts if acts is None else acts
    carry = lp.init_fn(inits)
    for l in range(lp.num_launches):
        if admit is not None and admit[0] == l:
            carry = lp.admit_fn(carry, admit[1], admit[2])
        carry = lp.launch_fn(carry, acts[l], lp.launch_t0(l))
    return lp.finalize(carry)


def _ref_step_plan(lp, inits):
    carry = lp.init_fn(tuple(jnp.asarray(x) for x in inits))
    for l in range(lp.num_launches):
        carry = lp.launch_fn(carry, jnp.asarray(lp.acts[l]),
                             jnp.asarray(lp.launch_t0(l), jnp.int32))
    return [np.asarray(x) for x in lp.finalize(carry)]


PLAN_CASES = [
    ("stacked", [_member(steps=t, width=24, seed=k) for k, t in enumerate((10, 7, 1))], 1, "stacked"),
    ("stacked-blocked", [_member(steps=t, width=24, pattern="nearest", radius=2, seed=k)
                         for k, t in enumerate((10, 7, 1))], 3, "stacked"),
    ("stacked-radii", [_member(steps=10, width=24, seed=0),
                       _member(steps=8, width=24, pattern="nearest", radius=2, seed=1)], 4, "stacked"),
    ("stepwise-plans", _mixed_plans(), 1, "stepwise"),
    ("stepwise-shapes", _hetero_shapes((5, 2, 7)), 1, "stepwise"),
    ("stepwise-blocked-tuple", [_member(steps=9, width=24, seed=0),
                                _member(steps=5, width=24, pattern="no_comm", kind="memory_bound",
                                        iters=2, seed=1)], 3, "stepwise"),
]


@pytest.mark.parametrize("name,members,S,kind", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_launch_plan_stepped_on_the_host(name, members, S, kind):
    """The port's plan equals its ``build_ensemble`` bit for bit (where
    the build runs the plan's schedule: every stacked plan, the stepwise
    plan at S = 1), and the reference's plan stepped the same way within
    tolerance."""
    ens, ref_ens, inits = _pair(members)
    opts = {"steps_per_launch": S}
    rt = get_runtime("pallas_step", device="cpu", **opts)
    lp = rt.build_ensemble_launches(ens)
    ref_lp = ref_runtime("pallas_step", **opts).build_ensemble_launches(ref_ens)
    assert lp.kind == ref_lp.kind == kind
    assert lp.steps_per_launch == ref_lp.steps_per_launch
    assert lp.member_steps == ref_lp.member_steps == ens.member_steps
    np.testing.assert_array_equal(lp.acts, ref_lp.acts)
    assert lp.expected_launch_us is None and lp.compile_counter() == lp.compile_counter()
    xs = rt._ensemble_inits(ens, inits)
    outs = _step_plan(lp, xs)
    if kind == "stacked" or rt._ensemble_steps_per_launch(ens) == 1:
        for a, b in zip(outs, rt.build_ensemble(ens)(xs)):
            assert torch.equal(a, b)
    if kind == "stacked":  # the act rows staged as tensors ahead: the same bits
        for a, b in zip(_step_plan(lp, xs, torch.from_numpy(lp.acts)), outs):
            assert torch.equal(a, b)
    for g, a, b in zip(ens.members, outs, _ref_step_plan(ref_lp, inits)):
        np.testing.assert_allclose(a.numpy(), b, **_tol(g))


@pytest.mark.parametrize("S", [1, 3])
def test_stacked_plan_evicts_and_admits(S):
    """Zeroing member 1's act rows from launch l on freezes it at T = 1 +
    l*S: it equals its own run of that horizon (bit for bit: the plain
    version's arithmetic does not depend on K); a member admitted into the
    finished slot 2 holds the t = 0 launch of its init; the capture count
    stays flat."""
    members = [_member(steps=t, width=24, pattern="nearest", radius=2, seed=k)
               for k, t in enumerate((10, 10, 1))]
    ens, _, inits = _pair(members)
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=S)
    lp = rt.build_ensemble_launches(ens)
    xs = rt._ensemble_inits(ens, inits)
    before = lp.compile_counter()
    l_evict = 2
    acts = lp.acts.copy()
    acts[l_evict:, 1, :] = 0
    fresh = torch.from_numpy(np.random.default_rng(5).uniform(0.1, 1.0, (24, 8)).astype(np.float32))
    outs = _step_plan(lp, xs, acts, admit=(lp.num_launches - 1, 2, fresh))
    assert lp.compile_counter() == before
    frozen = members[1] | {"steps": 1 + l_evict * S}
    g1, _, _ = _pair([frozen])
    alone = get_runtime("pallas_step", device="cpu", steps_per_launch=S).execute(
        g1.members[0], inits[1])
    np.testing.assert_array_equal(outs[1].numpy(), alone)
    t0, _ = rt._halo_step_fns(ens.members[2])
    assert torch.equal(outs[2], t0(fresh[None])[0])
    full = _step_plan(lp, xs)
    assert torch.equal(outs[0], full[0])


# ------------------------------------------- K-dependent rounding (Queue 3)


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("S,pipeline", [(1, True), (3, True), (3, False)])
def test_stacked_member_equals_its_own_run_bit_for_bit(combine, S, pipeline):
    """On the CPU plain path a stacked member equals its own single-graph
    ``pallas_step`` run bit for bit, at K = 4 and with a radius-1 member
    read through a radius-2 window (ROADMAP Queue 3's K-dependent rounding
    check)."""
    members = [_member(steps=9, width=48, seed=k, iters=3) for k in range(3)]
    members.append(_member(steps=9, width=48, pattern="nearest", radius=2, seed=3, iters=3))
    ens, _, inits = _pair(members)
    opts = dict(combine=combine, steps_per_launch=S, pipeline=pipeline)
    rt = get_runtime("pallas_step", device="cpu", **opts)
    assert rt._is_stacked(ens)
    outs = rt.execute_ensemble(ens, inits)
    for k, (g, out, init) in enumerate(zip(ens.members, outs, inits)):
        np.testing.assert_array_equal(out, rt.execute(g, init), err_msg=f"member {k}")
