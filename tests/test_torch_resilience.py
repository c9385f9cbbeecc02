"""Parity of the port's resilience layer (``repro_torch.resilience``) with the
JAX package's, on the CPU.

The reference's ``tests/test_resilience.py`` unit cases run here as cases
against the port: plan validation, seeding, the JSON round-trip, fault-state
consumption, the chaos transport wrappers and the arming stack, and the
deadline detector. ``FaultPlan.random`` gives the reference's plan, dict for
dict, for 8 seeds. On the reference's two-member ensemble, each fault class
run through both packages' ``run_resilient`` (the port fed the reference's
initial states) gives the same events (kind, launch, action, member,
attempts, mode), outputs within ``rtol=1e-5, atol=1e-6`` and the same
``fault`` tracer records; within the port, recovered runs equal the clean
run bit for bit, an evicted member its truncated oracle, and a run over D =
2 and 4 row shards (``devices=["cpu"] * D``) its D = 1 run. A hypothesis
property (``derandomize=True``) draws seeded plans.

Every step moves a state ``grain`` halvings closer to the FMA's fixed point
0.2, so the state comparisons run at grain 1 and T <= 7 (``SHORT``), where a
replay from a wrong carry, a wrong shard dataflow or a wrong admission shows
in the bits, and each checks that its reference lies at least ``SHOWS_MIN``
from 0.2. The reference's two-member ensemble (grain 4, T = 13 and 9,
``LONG``), at the fixed point, serves the event and record checks only.
Sizes: W <= 16, T <= 13.
"""
import dataclasses
import functools

import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import GraphEnsemble as RefEnsemble
from repro.core import KernelSpec as RefSpec
from repro.core import TaskGraph as RefGraph
from repro.core import get_runtime as ref_runtime
from repro.core.task_kernels import initial_state as ref_initial_state
from repro.obs import Tracer as RefTracer
from repro.resilience import FaultPlan as RefPlan
from repro.resilience import RecoveryPolicy as RefPolicy
from repro.resilience import run_resilient as ref_run_resilient
from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import _halo
from repro_torch.core.task_kernels import initial_state
from repro_torch.obs import Tracer
from repro_torch.obs.tracer import CAT_FAULT
from repro_torch.resilience import (
    FAULT_LAUNCH,
    FAULT_MEMBER,
    FAULT_STRAGGLER,
    FAULT_TRANSPORT,
    READMIT_SEED_OFFSET,
    DeadlineDetector,
    FaultPlan,
    FaultSpec,
    FaultState,
    RecoveryPolicy,
    TransientTransportFault,
    UnrecoverableFault,
    armed,
    install_chaos_impls,
    run_resilient,
    transport_site,
)
from repro_torch.resilience import engine as engine_mod
from repro_torch.resilience import faults as faults_mod

TOL = dict(rtol=1e-5, atol=1e-6)
#: (grain, member horizons): the reference's ensemble, and one inside the
#: contraction horizon
LONG, SHORT = (4, (13, 9)), (1, (7, 6))
FIXED_POINT, SHOWS_MIN = 0.2, 1e-3
#: a deadline no CPU hiccup reaches, for the cases that inject no straggler
#: (the same policy in both packages, so their events stay comparable)
CALM = dict(deadline_factor=1e4)
EVENT_FIELDS = ("kind", "launch", "action", "member", "attempts", "mode")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _transport_registries():
    """The chaos wrappers a test installs leave with it: the registries are
    process-wide, and other files compare them with the reference's."""
    saved = {kind: dict(reg) for kind, reg in _halo.TRANSPORT_REGISTRIES.items()}
    yield
    for kind, reg in _halo.TRANSPORT_REGISTRIES.items():
        reg.clear()
        reg.update(saved[kind])


def _fields(steps=13, seed=0, pattern="stencil_1d", width=8):
    return dict(steps=steps, width=width, pattern=pattern, payload=16, radius=1, seed=seed)


def graph(steps=13, seed=0, pattern="stencil_1d", width=8, grain=4):
    return TaskGraph(kernel=KernelSpec("compute_bound", grain),
                     **_fields(steps, seed, pattern, width))


def ensemble(pattern="stencil_1d", width=8, spec=SHORT):
    grain, steps = spec
    return GraphEnsemble(tuple(graph(t, k, pattern, width, grain) for k, t in enumerate(steps)))


def ref_ensemble(pattern="stencil_1d", spec=SHORT):
    grain, steps = spec
    return RefEnsemble(tuple(RefGraph(kernel=RefSpec("compute_bound", grain),
                                      **_fields(t, k, pattern))
                             for k, t in enumerate(steps)))


def _shows(outputs):
    """The states lie far enough from the fixed point for a wrong dataflow
    to show."""
    dist = min(float(np.abs(np.asarray(o) - FIXED_POINT).max()) for o in outputs)
    assert dist >= SHOWS_MIN, f"the reference is {dist:.3g} from {FIXED_POINT}: no dataflow shows"


def ref_inits(ens):
    return [np.asarray(ref_initial_state(g.width, g.payload, g.seed)) for g in ens.members]


def runtime(S=4, **opts):
    return get_runtime("pallas_step", device="cpu", steps_per_launch=S, **opts)


def _events(res):
    return [tuple(getattr(e, f) for f in EVENT_FIELDS) for e in res.events]


def _ref_plan(plan: FaultPlan) -> RefPlan:
    return RefPlan.from_dict(plan.to_dict())


@functools.lru_cache(maxsize=None)
def _ref_result(pattern: str, S: int, plan_json: str, policy_json: str, spec=SHORT):
    import json

    plan = RefPlan.from_dict(json.loads(plan_json)) if plan_json else None
    rt = ref_runtime("pallas_step", steps_per_launch=S)
    return ref_run_resilient(rt, ref_ensemble(pattern, spec), plan=plan,
                             policy=RefPolicy(**json.loads(policy_json)))


def _both(pattern: str, S: int, plan, spec=SHORT, **policy):
    """The reference's and the port's resilient runs of the two-member
    ensemble ``spec`` under ``plan``, the port fed the reference's inits."""
    import json

    ref = _ref_result(pattern, S, json.dumps(plan.to_dict()) if plan else "",
                      json.dumps(policy), spec)
    ours = run_resilient(runtime(S), ensemble(pattern, spec=spec), plan=plan,
                         policy=RecoveryPolicy(**policy),
                         inits=ref_inits(ref_ensemble(pattern, spec)))
    return ref, ours


def _assert_close(ref, ours):
    for k, (a, b) in enumerate(zip(ours.outputs, ref.outputs)):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=f"member {k}", **TOL)


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("make,match", [
    (lambda: FaultSpec("cosmic_ray", 0), "unknown fault kind"),
    (lambda: FaultSpec(FAULT_LAUNCH, -1), "launch index"),
    (lambda: FaultSpec(FAULT_TRANSPORT, 0, times=0), "times"),
    (lambda: FaultSpec(FAULT_LAUNCH, 0, mode="segfault"), "unknown launch fault mode"),
    (lambda: FaultPlan((FaultSpec(FAULT_LAUNCH, 2), FaultSpec(FAULT_LAUNCH, 2))),
     "duplicate fault site"),
    (lambda: FaultPlan((FaultSpec(FAULT_MEMBER, 0, member=1),
                        FaultSpec(FAULT_MEMBER, 3, member=1))), "die twice"),
], ids=["kind", "launch", "times", "mode", "duplicate", "die-twice"])
def test_fault_plan_validation(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_fault_plan_random_is_deterministic_and_valid():
    a = FaultPlan.random(7, num_launches=20, num_members=3, rate=0.5)
    assert a == FaultPlan.random(7, num_launches=20, num_members=3, rate=0.5)
    assert a.specs
    assert FaultPlan.random(8, num_launches=20, num_members=3, rate=0.5) != a
    FaultPlan(specs=a.specs)  # every drawn spec satisfies the invariants


@pytest.mark.parametrize("seed", range(8))
def test_fault_plan_random_equals_the_reference(seed):
    kw = dict(num_launches=25, num_members=4, rate=0.35,
              kinds=(FAULT_TRANSPORT, FAULT_LAUNCH, FAULT_MEMBER, FAULT_STRAGGLER))
    ours = FaultPlan.random(seed, **kw)
    assert ours.to_dict() == RefPlan.random(seed, **kw).to_dict()
    assert ours.describe() == RefPlan.random(seed, **kw).describe()


def test_fault_plan_json_roundtrip():
    plan = FaultPlan.random(3, num_launches=10, num_members=2, rate=0.4,
                            kinds=(FAULT_TRANSPORT, FAULT_LAUNCH, FAULT_MEMBER, FAULT_STRAGGLER))
    assert FaultPlan.from_dict(plan.to_dict()) == plan
    assert _ref_plan(plan).to_dict() == plan.to_dict()  # it crosses packages too


def test_fault_state_consumption():
    plan = FaultPlan((FaultSpec(FAULT_TRANSPORT, 1, times=2),
                      FaultSpec(FAULT_LAUNCH, 3, mode="poison")))
    st_ = FaultState(plan)
    assert st_.transport_should_fail(1)
    assert st_.transport_should_fail(1)
    assert not st_.transport_should_fail(1)  # healed after `times`
    assert not st_.transport_should_fail(0)
    assert st_.peek(FAULT_LAUNCH, 3).mode == "poison"
    assert st_.take(FAULT_LAUNCH, 3) is not None
    assert st_.take(FAULT_LAUNCH, 3) is None  # one-shot


# ------------------------------------------------- chaos transport impls


def test_install_chaos_impls_registers_wrappers():
    names = install_chaos_impls()
    assert "chaos+xla" in names and "chaos+ppermute" in names
    for registry in _halo.TRANSPORT_REGISTRIES.values():
        assert "chaos+xla" in registry
    assert install_chaos_impls() == names  # idempotent


def test_register_transport_impl_refuses_shadowing():
    with pytest.raises(ValueError, match="already registered"):
        _halo.register_transport_impl("halo", "xla", lambda *a, **k: None)
    with pytest.raises(ValueError, match="unknown transport registry"):
        _halo.register_transport_impl("warp", "x", lambda *a, **k: None)


def test_chaos_impl_raises_only_while_armed():
    install_chaos_impls()
    start = _halo.HALO_ASYNC_IMPLS["chaos+xla"]
    plan = FaultPlan((FaultSpec(FAULT_TRANSPORT, 5, times=1),))
    # disarmed: delegates straight to the base impl (which fails on the
    # missing arguments, but raises no injected fault)
    with pytest.raises(TypeError):
        start()
    with armed(FaultState(plan)), transport_site(5):
        with pytest.raises(TransientTransportFault):
            start()
    # the site consumed its single failure: the next call delegates again
    with armed(FaultState(plan)), transport_site(4):
        with pytest.raises(TypeError):
            start()


def test_chaos_impl_fires_at_every_eager_call():
    """On the eager path (row shards on the CPU) the wrapper runs at each
    call, not once at trace time as in the reference: disarmed, a run over
    ``halo_impl="chaos+xla"`` equals "xla" bit for bit; armed at the site,
    the same run raises the injected fault."""
    install_chaos_impls()
    g = TaskGraph(steps=9, width=32, pattern="stencil_1d", payload=8,
                  kernel=KernelSpec("compute_bound", 1), seed=0)
    mk = lambda impl: get_runtime("pallas_step", devices=["cpu"] * 2,  # noqa: E731
                                  steps_per_launch=2, halo_impl=impl)
    rt = mk("chaos+xla")
    assert rt._pipeline_active(16, 2, 1, 8)
    np.testing.assert_array_equal(rt.execute(g), mk("xla").execute(g))
    plan = FaultPlan((FaultSpec(FAULT_TRANSPORT, 0, times=1),))
    with armed(FaultState(plan)), transport_site(0):
        with pytest.raises(TransientTransportFault, match="chaos\\+xla"):
            rt.execute(g)


def test_armed_stack_restores_on_exit():
    st_ = FaultState(FaultPlan((FaultSpec(FAULT_LAUNCH, 0),)))
    assert faults_mod.armed_state() is None
    with armed(st_):
        assert faults_mod.armed_state() is st_
    assert faults_mod.armed_state() is None


# --------------------------------------------------- engine against the reference


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("pattern", ["stencil_1d", "tree", "all_to_all"])
def test_resilient_clean_matches_execute_ensemble(pattern, S):
    """The clean run equals the port's ``execute_ensemble`` bit for bit,
    and the reference's clean run within tolerance, with no events."""
    ens = ensemble(pattern)
    rt = runtime(S)
    inits = ref_inits(ref_ensemble(pattern))
    ref, res = _both(pattern, S, None, **CALM)
    _shows(ref.outputs)
    assert res.launches == ref.launches == rt.build_ensemble_launches(ens).num_launches
    assert not res.events and not ref.events
    for got, want in zip(res.outputs, rt.execute_ensemble(ens, inits)):
        np.testing.assert_array_equal(got, want)
    _assert_close(ref, res)
    res2 = rt.execute_ensemble_resilient(ens, inits=inits)
    for a, b in zip(res.outputs, res2.outputs):
        np.testing.assert_array_equal(a, b)


SPECS = [
    (FaultSpec(FAULT_TRANSPORT, 1, times=3), {}),
    (FaultSpec(FAULT_LAUNCH, 1, mode="raise"), {}),
    (FaultSpec(FAULT_LAUNCH, 1, mode="poison"), {}),
    (FaultSpec(FAULT_STRAGGLER, 1, delay_s=0.001), {}),
]


@pytest.mark.parametrize("spec", [s for s, _ in SPECS],
                         ids=["transport", "raise", "poison", "straggler"])
def test_recovery_per_class_against_the_reference(spec):
    """Each class recovers to the clean run's bits and gives the
    reference's events, retries and replays."""
    plan = FaultPlan((spec,))
    ref, res = _both("stencil_1d", 4, plan, **CALM)
    _shows(ref.outputs)
    clean = run_resilient(runtime(4), ensemble(),
                          inits=ref_inits(ref_ensemble()))
    for got, want in zip(res.outputs, clean.outputs):
        np.testing.assert_array_equal(got, want)
    assert _events(res) == _events(ref)
    assert (res.retries, res.replays, res.stragglers) == (ref.retries, ref.replays,
                                                          ref.stragglers)
    _assert_close(ref, res)
    if spec.kind == FAULT_TRANSPORT:
        assert res.retries == spec.times
    if spec.kind == FAULT_LAUNCH:
        assert res.replays == 1 and any(e.mode == spec.mode for e in res.events)


def test_straggler_flagged_as_the_reference_flags_it():
    """A 0.25 s stall past the self-calibrated deadline (100 x the median
    of the clean walls, after the 3-launch warm-up) is flagged in both
    packages at the same launch, and nothing else is (the reference's
    ensemble: 12 launches at S = 1)."""
    plan = FaultPlan((FaultSpec(FAULT_STRAGGLER, 6, delay_s=0.25),))
    ref, res = _both("stencil_1d", 1, plan, LONG, deadline_factor=100.0)
    assert _events(res) == _events(ref) == [("straggler", 6, "flagged", -1, 0, "")]
    assert res.events[0].overshoot_us > 0 and res.deadline_source == "observed"
    assert res.deadline_us < 0.25e6
    _assert_close(ref, res)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("pattern", ["stencil_1d", "tree", "all_to_all"])
def test_recovery_across_plan_kinds(pattern, S):
    """Stacked (halo) and stepwise (stride/allgather) launch plans both
    recover to the clean bits from a mixed plan, with the reference's
    events."""
    plan = FaultPlan((FaultSpec(FAULT_TRANSPORT, 0, times=1),
                      FaultSpec(FAULT_LAUNCH, 1, mode="raise")))
    ref, res = _both(pattern, S, plan, **CALM)
    _shows(ref.outputs)
    clean = run_resilient(runtime(S), ensemble(pattern),
                          inits=ref_inits(ref_ensemble(pattern)))
    for got, want in zip(res.outputs, clean.outputs):
        np.testing.assert_array_equal(got, want)
    assert res.retries == 1 and res.replays == 1
    assert _events(res) == _events(ref)
    _assert_close(ref, res)


@pytest.mark.parametrize("launch,member", [(1, 1), (0, 0)], ids=["mid", "launch0"])
def test_eviction_matches_truncated_oracle(launch, member):
    plan = FaultPlan((FaultSpec(FAULT_MEMBER, launch, member=member),))
    ref, res = _both("stencil_1d", 4, plan, **CALM)
    _shows(ref.outputs)
    frozen = res.evicted[member]
    assert res.evicted == ref.evicted
    assert frozen == min(SHORT[1][member], 1 + launch * 4)
    assert _events(res) == _events(ref)
    members = [graph(t, k, grain=SHORT[0]) for k, t in enumerate(SHORT[1])]
    members[member] = dataclasses.replace(members[member], steps=frozen)
    oracle = runtime(4).execute_ensemble(GraphEnsemble(tuple(members)),
                                         ref_inits(ref_ensemble()))
    for got, want in zip(res.outputs, oracle):
        np.testing.assert_array_equal(got, want)
    _assert_close(ref, res)


def test_readmission_matches_the_reference(monkeypatch):
    """The fresh member drawn at seed + READMIT_SEED_OFFSET (the reference's
    draw, fed through the port's ``initial_state``) runs as the reference's
    does; within the port it equals its own fresh run."""
    def ref_draw(width, payload, seed=0, device="cuda"):
        return torch.from_numpy(np.array(ref_initial_state(width, payload, seed))).to(device)

    monkeypatch.setattr(engine_mod, "initial_state", ref_draw)
    plan = FaultPlan((FaultSpec(FAULT_MEMBER, 0, member=1),))
    ref, res = _both("stencil_1d", 4, plan, readmit=True, **CALM)
    info = res.readmitted[1]
    assert res.readmitted == ref.readmitted
    assert info["launch"] == 1 and info["seed"] == 1 + READMIT_SEED_OFFSET
    assert _events(res) == _events(ref)
    _shows(ref.outputs)
    _assert_close(ref, res)
    first, second = ensemble().members
    fresh = dataclasses.replace(second, steps=info["steps"], seed=info["seed"])
    inits = ref_inits(ref_ensemble())
    oracle = runtime(4).execute_ensemble(
        GraphEnsemble((first, fresh)),
        [inits[0], np.asarray(ref_initial_state(8, 16, info["seed"]))])
    for got, want in zip(res.outputs, oracle):
        np.testing.assert_array_equal(got, want)


def test_transport_budget_exhaustion_raises():
    plan = FaultPlan((FaultSpec(FAULT_TRANSPORT, 0, times=50),))
    policy = RecoveryPolicy(max_transport_retries=2, backoff_base_s=1e-4, backoff_cap_s=1e-3)
    with pytest.raises(UnrecoverableFault, match="still failing"):
        run_resilient(runtime(4), ensemble(), plan=plan, policy=policy)


def test_replay_budget_exhaustion_raises(monkeypatch):
    """A launch that keeps returning poisoned output spends the replay
    budget (every retry poisoned by a stand-in for ``_poison``'s check)."""
    monkeypatch.setattr(engine_mod, "_is_poisoned", lambda states: True)
    plan = FaultPlan((FaultSpec(FAULT_LAUNCH, 0, mode="poison"),))
    with pytest.raises(UnrecoverableFault, match="poisoned"):
        run_resilient(runtime(4), ensemble(), plan=plan,
                      policy=RecoveryPolicy(max_replays_per_launch=2))


def test_resilient_emits_the_reference_fault_records():
    """The ``fault`` records, names and attributes (the backoff delays come
    from the plan seed's generator in both), equal the reference's."""
    plan = FaultPlan((FaultSpec(FAULT_TRANSPORT, 1, times=2),
                      FaultSpec(FAULT_LAUNCH, 2, mode="poison"),
                      FaultSpec(FAULT_MEMBER, 0, member=1)), seed=11)
    tr, ref_tr = Tracer(), RefTracer()
    run_resilient(runtime(4), ensemble(spec=LONG), plan=plan, tracer=tr,
                  policy=RecoveryPolicy(readmit=True, **CALM))
    ref_run_resilient(ref_runtime("pallas_step", steps_per_launch=4), ref_ensemble(spec=LONG),
                      plan=_ref_plan(plan), tracer=ref_tr,
                      policy=RefPolicy(readmit=True, **CALM))

    def records(spans):
        return [(s.name, s.category, s.attrs) for s in spans if s.category == CAT_FAULT]

    got = records(tr.spans)
    assert got == records(ref_tr.spans)
    names = [n for n, _, _ in got]
    assert names.count("transport_fault") == 2 and names.count("backoff") == 2
    assert {"member_evicted", "member_readmitted", "launch_poisoned"} <= set(names)
    assert all(s.end_us > s.start_us for s in tr.spans if s.name == "backoff")


def test_unsupported_backend_names_the_fallback():
    with pytest.raises(NotImplementedError, match="run_with_restarts"):
        get_runtime("fused", device="cpu").build_ensemble_launches(ensemble())
    with pytest.raises(NotImplementedError, match="run_with_restarts"):
        get_runtime("fused", device="cpu").execute_ensemble_resilient(ensemble())


# ------------------------------------------ replays from the pre-launch bits


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("pattern", ["stencil_1d", "tree"])
def test_sharded_resilient_runs_equal_one_device(pattern, S, D):
    """Over D row shards (the eager path: ping-pong halo buffers at S = 1,
    the deep exchange at S > 1, the stride plan's member steps) a transport
    retry, a launch fault, an eviction with re-admission and a poisoned
    launch give the clean run's bits for the survivor and the same-K
    oracle's for the evicted and re-admitted member, each launch replayed
    from its pre-launch bits, and the D = 1 run's bits."""
    ens = ensemble(pattern, width=16)
    plan = FaultPlan((FaultSpec(FAULT_LAUNCH, 0, mode="raise"),
                      FaultSpec(FAULT_MEMBER, 0, member=1),
                      FaultSpec(FAULT_TRANSPORT, 1, times=2),
                      FaultSpec(FAULT_LAUNCH, 1, mode="poison")))
    policy = RecoveryPolicy(readmit=True, backoff_base_s=1e-4, **CALM)
    one = runtime(S)
    shards = get_runtime("pallas_step", devices=["cpu"] * D, steps_per_launch=S)
    clean = run_resilient(one, ens)
    _shows(clean.outputs)
    for x, y in zip(clean.outputs, run_resilient(shards, ens).outputs):
        np.testing.assert_array_equal(x, y)
    a = run_resilient(one, ens, plan=plan, policy=policy)
    b = run_resilient(shards, ens, plan=plan, policy=policy)
    assert _events(a) == _events(b) and a.evicted == b.evicted == {1: 1}
    assert sorted(e[0] for e in _events(a)) == ["launch", "launch", "member", "transport"]
    assert a.readmitted == b.readmitted and a.readmitted[1]["launch"] == 1
    for x, y in zip(a.outputs, b.outputs):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.outputs[0], clean.outputs[0])
    if one.build_ensemble_launches(ens).kind != "stacked":
        # a stepwise plan steps an admitted member at the run's own t, as
        # the reference's does: a time-indexed pattern's fresh run is no
        # oracle for it (ROADMAP Queue 3)
        return
    first, second = ens.members
    info = a.readmitted[1]
    fresh = dataclasses.replace(second, steps=info["steps"], seed=info["seed"])
    oracle = one.execute_ensemble(GraphEnsemble((first, fresh)), [
        initial_state(first.width, first.payload, first.seed, device="cpu"),
        initial_state(fresh.width, fresh.payload, fresh.seed, device="cpu")])
    _shows(oracle)
    for x, y in zip(a.outputs, oracle):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("S", [1, 4])
def test_replays_start_from_the_pre_launch_bits(S):
    """A launch that writes the carry it was given (as an eager launch may
    write its halo rows or ping-pong buffers) does not leak into a replay:
    after a poisoned launch and an eviction each replay starts from the
    pre-launch bits, so the survivor keeps the clean run's bits and the
    evicted member its truncated oracle's."""
    ens = ensemble()
    rt = runtime(S)
    real = rt.build_ensemble_launches

    def scribbling_plan(e):
        lp = real(e)
        launch = lp.launch_fn

        def launch_fn(carry, act_row, t0):
            out = launch(carry, act_row, t0)
            carry.mul_(0.5)  # the launch reused its input's memory
            return out

        return dataclasses.replace(lp, launch_fn=launch_fn)

    rt.build_ensemble_launches = scribbling_plan
    clean = run_resilient(rt, ens)
    np.testing.assert_array_equal(clean.outputs[0], runtime(S).execute_ensemble(ens)[0])
    plan = FaultPlan((FaultSpec(FAULT_LAUNCH, 0, mode="poison"),
                      FaultSpec(FAULT_MEMBER, 1, member=1)))
    res = run_resilient(rt, ens, plan=plan, policy=RecoveryPolicy(**CALM))
    first, second = ens.members
    oracle = runtime(S).execute_ensemble(GraphEnsemble(
        (first, dataclasses.replace(second, steps=res.evicted[1]))))
    _shows(oracle)
    for got, want in zip(res.outputs, oracle):
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- detection


def test_detector_self_calibrates_from_clean_walls():
    det = DeadlineDetector(factor=4.0, warmup=3, min_deadline_us=1.0)
    assert det.deadline_us() is None
    for _ in range(3):
        assert det.observe(100.0) is None
    assert det.deadline_us() == pytest.approx(400.0)
    d = det.observe(1000.0)
    assert d is not None and d.overshoot_us == pytest.approx(600.0)
    assert det.deadline_us() == pytest.approx(400.0)  # not dragged by the flag
    assert det.source == "observed"


def test_detector_prefers_measured_expectation():
    det = DeadlineDetector(factor=2.0, expected_us=50.0, min_deadline_us=1.0)
    assert det.deadline_us() == pytest.approx(100.0)
    assert det.observe(99.0) is None
    assert det.observe(101.0) is not None
    assert det.source == "measured"
    with pytest.raises(ValueError, match="factor"):
        DeadlineDetector(factor=1.0)


# ------------------------------------------------------------ property

PATTERNS = ("stencil_1d", "tree", "all_to_all")


@settings(max_examples=8, deadline=None, derandomize=True)
@given(st.tuples(st.sampled_from(PATTERNS), st.sampled_from((1, 4)),
                 st.sampled_from(((7, 6), (5, 5), (4, 7))),
                 st.sampled_from([(FAULT_TRANSPORT,), (FAULT_LAUNCH,),
                                  (FAULT_TRANSPORT, FAULT_LAUNCH, FAULT_MEMBER)]),
                 st.integers(min_value=0, max_value=10)))
def test_property_any_seeded_plan_recovers_to_the_clean_bits(case):
    """Survivors equal the clean run bit for bit under any drawn plan; an
    evicted member equals the clean run truncated at its frozen step."""
    pattern, S, steps, kinds, seed = case
    members = tuple(graph(t, k, pattern, grain=1) for k, t in enumerate(steps))
    ens = GraphEnsemble(members)
    rt = runtime(S)
    lp = rt.build_ensemble_launches(ens)
    plan = FaultPlan.random(seed, num_launches=lp.num_launches, num_members=2, rate=0.5,
                            kinds=kinds)
    res = run_resilient(rt, ens, plan=plan,
                        policy=RecoveryPolicy(backoff_base_s=1e-4, backoff_cap_s=1e-3, **CALM))
    oracle = rt.execute_ensemble(GraphEnsemble(tuple(
        dataclasses.replace(g, steps=res.evicted[k]) if k in res.evicted else g
        for k, g in enumerate(members))))
    _shows(oracle)
    for k, (got, want) in enumerate(zip(res.outputs, oracle)):
        assert np.array_equal(got, want), f"member {k} under {plan.describe()} ({pattern}, S={S})"
