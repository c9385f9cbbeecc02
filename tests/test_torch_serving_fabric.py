"""Parity of the port's serving fabric (``repro_torch.serving``) with the JAX
package's, on the CPU.

``cohort_key``, ``order_key`` and ``pack`` give the reference's keys, orders
and cohorts. Under the virtual ``LaunchClock`` the fabric's outcomes and
cohort census equal the reference's field by field (all but ``wall_s``; the
outputs within ``rtol=1e-5, atol=1e-6``, both packages fed the reference's
initial states) on the reference's request streams and on seeded drawn
schedules, and within the port ``verify=True`` holds every outcome bit for
bit to its same-K serial oracle. Deadline eviction freezes a request at its
truncated horizon; admission captures nothing (the no-re-capture contract,
checked with the stand-in CUDA graph API of ``test_torch_capture.py``);
duplicate rids are refused; a run over two row shards equals one device's.
The streams run at grain 1 and T <= 7, inside the contraction horizon of the
FMA's fixed point 0.2 (every step halves a state's distance from it
``grain`` times), so an admission into the wrong slot or a wrong snapshot
shows in the bits; each comparison checks that its reference lies at least
``SHOWS_MIN`` from 0.2. Sizes: W <= 16, T <= 7.
"""
import dataclasses
import functools

import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

from repro.core import KernelSpec as RefSpec
from repro.core import get_runtime as ref_runtime
from repro.core.task_kernels import initial_state as ref_initial_state
from repro.serving import LaunchClock as RefLaunchClock
from repro.serving import ServingFabric as RefFabric
from repro.serving import cohort_key as ref_cohort_key
from repro.serving import make_request as ref_make_request
from repro.serving import order_key as ref_order_key
from repro.serving import pack as ref_pack
from repro_torch.core import KernelSpec, get_runtime
from repro_torch.core.runtimes import _capture
from repro_torch.kernels import _build
from repro_torch.serving import fabric as fabric_mod
from repro_torch.serving import (
    LaunchClock,
    ServingFabric,
    WallClock,
    cohort_key,
    make_request,
    order_key,
    pack,
)
from test_torch_capture import fake_card, stub_entries  # noqa: F401  (fixtures)

TOL = dict(rtol=1e-5, atol=1e-6)
WIDTH = 8
GRAIN = 1
FIXED_POINT, SHOWS_MIN = 0.2, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_draws(monkeypatch):
    """The fabric draws each request's initial state as the reference's
    does (its seed), here the reference's own draw."""
    def draw(width, payload, seed=0, device="cuda"):
        return torch.from_numpy(np.array(ref_initial_state(width, payload, seed))).to(device)

    monkeypatch.setattr(fabric_mod, "initial_state", draw)


def _ref_init(g):
    return np.asarray(ref_initial_state(g.width, g.payload, g.seed))


def _shows(outputs):
    dist = min(float(np.abs(np.asarray(o) - FIXED_POINT).max()) for o in outputs)
    assert dist >= SHOWS_MIN, f"the reference is {dist:.3g} from {FIXED_POINT}: no dataflow shows"


def _graph_kw(pattern="stencil_1d", steps=5, width=WIDTH, radius=1, seed=0):
    return dict(steps=steps, width=width, pattern=pattern, radius=radius, seed=seed)


# ----------------------------------------------------------------- packer


KEY_GRAPHS = [_graph_kw(), _graph_kw(steps=11, seed=9), _graph_kw(width=2 * WIDTH),
              _graph_kw(pattern="nearest", radius=2), _graph_kw(pattern="all_to_all"),
              _graph_kw(pattern="tree"), _graph_kw(pattern="random_nearest", seed=1),
              _graph_kw(pattern="random_nearest", seed=2)]


@pytest.mark.parametrize("S", [1, 2])
def test_cohort_key_equals_the_reference(S):
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=S)
    ref_rt = ref_runtime("pallas_step", steps_per_launch=S)
    keys = [cohort_key(rt, make_request(0, **kw).graph) for kw in KEY_GRAPHS]
    ref_keys = [ref_cohort_key(ref_rt, ref_make_request(0, **kw).graph) for kw in KEY_GRAPHS]
    assert [repr(k) for k in keys] == [repr(k) for k in ref_keys]
    assert keys[0] == keys[1]  # only the state differs
    assert len(set(keys)) == len(keys) - 1
    assert keys[6] != keys[7]  # the seed bakes into random_nearest's tables


def test_order_key_equals_the_reference():
    kws = [dict(rid=0, steps=5, priority=2, arrival_s=9.0), dict(rid=1, steps=5, deadline_s=3.0),
           dict(rid=2, steps=5, deadline_s=30.0), dict(rid=3, steps=5),
           dict(rid=4, steps=5, arrival_s=1.0, deadline_s=3.0, priority=1)]
    ours = sorted((make_request(**k) for k in kws), key=order_key)
    ref = sorted((ref_make_request(**k) for k in kws), key=ref_order_key)
    assert [r.rid for r in ours] == [r.rid for r in ref] == [0, 4, 1, 2, 3]
    assert [order_key(r) for r in ours] == [ref_order_key(r) for r in ref]


PACK_STREAM = [dict(rid=0, steps=5), dict(rid=1, steps=9, seed=4),
               dict(rid=2, steps=5, pattern="all_to_all"),
               dict(rid=3, steps=5, width=2 * WIDTH), dict(rid=4, steps=7, seed=8),
               dict(rid=5, steps=6, pattern="nearest", radius=2, priority=1),
               dict(rid=6, steps=3, deadline_s=4.0)]


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_pack_equals_the_reference(slots):
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=2)
    ref_rt = ref_runtime("pallas_step", steps_per_launch=2)
    ours = pack(rt, [make_request(**k) for k in PACK_STREAM], max_slots=slots)
    ref = ref_pack(ref_rt, [ref_make_request(**k) for k in PACK_STREAM], max_slots=slots)
    assert [[r.rid for r in c] for c in ours] == [[r.rid for r in c] for c in ref]
    with pytest.raises(ValueError):
        pack(rt, [], max_slots=0)


# ----------------------------------------------------------------- fabric


def _drawn(seed: int, pattern: str):
    """A seeded request schedule as the reference's property suite draws
    them: staggered arrivals, priorities, explicit deadlines that may or
    may not expire mid-cohort."""
    rng = np.random.default_rng(seed)
    radius = 2 if pattern == "nearest" else 1
    out = []
    for rid in range(int(rng.integers(3, 7))):
        arrival = float(rng.integers(0, 7))
        dl = (None, 3.0, 9.0)[int(rng.integers(3))]
        out.append(dict(rid=rid, steps=int(rng.integers(3, 8)), width=WIDTH,
                        pattern=pattern, radius=radius, seed=17 * rid + 1,
                        arrival_s=arrival, deadline_s=None if dl is None else arrival + dl,
                        priority=int(rng.integers(0, 3))))
    return out


STREAMS = {
    "mixed": ([dict(rid=0, steps=7, seed=1), dict(rid=1, steps=5, seed=2),
               dict(rid=2, steps=7, seed=3, arrival_s=1.0),
               dict(rid=3, steps=5, seed=4, arrival_s=1.0),
               dict(rid=4, steps=4, pattern="all_to_all", arrival_s=2.0),
               dict(rid=5, steps=6, pattern="nearest", radius=2, arrival_s=2.0, seed=5)], 2, 2),
    "deadline": ([dict(rid=0, steps=7, seed=1), dict(rid=1, steps=7, seed=2, deadline_s=1.0)],
                 2, 2),
    "readmission": ([dict(rid=0, steps=7, seed=1), dict(rid=1, steps=3, seed=2),
                     dict(rid=2, steps=5, seed=3, arrival_s=1.0)], 2, 2),
    "drawn-stencil-S1": (_drawn(0, "stencil_1d"), 2, 1),
    "drawn-nearest-S4": (_drawn(1, "nearest"), 3, 4),
    "drawn-stencil-S4": (_drawn(10, "stencil_1d"), 3, 4),
    "drawn-nearest-S2": (_drawn(7, "nearest"), 3, 2),
}


@functools.lru_cache(maxsize=None)
def _ref_report(name: str):
    reqs, slots, S = STREAMS[name]
    fabric = RefFabric(ref_runtime("pallas_step", steps_per_launch=S), max_slots=slots,
                       clock=RefLaunchClock())
    return fabric.serve([ref_make_request(kernel=RefSpec("compute_bound", GRAIN), **k)
                         for k in reqs])


def _requests(name: str):
    return [make_request(kernel=KernelSpec("compute_bound", GRAIN), **k)
            for k in STREAMS[name][0]]


def _serve(name: str, **rt_kw):
    _, slots, S = STREAMS[name]
    rt = get_runtime("pallas_step", steps_per_launch=S, **(rt_kw or {"device": "cpu"}))
    fabric = ServingFabric(rt, max_slots=slots, verify=True, clock=LaunchClock())
    return fabric.serve(_requests(name))


_OUTCOME_SKIP = ("graph", "output", "bit_identical")


@pytest.mark.parametrize("name", list(STREAMS))
def test_fabric_equals_the_reference_field_by_field(name):
    rep, ref = _serve(name), _ref_report(name)
    _shows(r.output for r in ref.outcomes)
    assert rep.bit_identical is True
    assert len(rep.outcomes) == len(ref.outcomes) == len(STREAMS[name][0])
    for o, r in zip(rep.outcomes, ref.outcomes):
        for f in dataclasses.fields(o):
            if f.name not in _OUTCOME_SKIP:
                assert getattr(o, f.name) == getattr(r, f.name), (o.rid, f.name)
        assert dataclasses.asdict(o.graph) == dataclasses.asdict(r.graph)
        np.testing.assert_allclose(o.output, np.asarray(r.output), err_msg=f"rid {o.rid}",
                                   **TOL)
    assert [dataclasses.asdict(c) for c in rep.cohorts] == [
        dataclasses.asdict(c) for c in ref.cohorts]
    assert all(c.recompiles == 0 for c in rep.cohorts)


def test_fabric_deadline_eviction_is_exact():
    rep = _serve("deadline")
    by_rid = {o.rid: o for o in rep.outcomes}
    assert by_rid[1].status == "deadline_evicted" and by_rid[1].effective_steps < 7
    assert by_rid[0].status == "completed" and rep.bit_identical is True
    assert sum(c.deadline_evictions for c in rep.cohorts) == 1
    # the evicted request froze at its truncated horizon: the port's own
    # run of that many steps, at the cohort's K, is its output bit for bit
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=2)
    g = dataclasses.replace(by_rid[1].graph, steps=by_rid[1].effective_steps)
    from repro_torch.core import GraphEnsemble

    want = rt.execute_ensemble(GraphEnsemble((g, g)), [_ref_init(g)] * 2)[1]
    _shows([want])
    np.testing.assert_array_equal(by_rid[1].output, want)


def test_fabric_readmission_reuses_the_freed_slot():
    rep = _serve("readmission")
    assert len(rep.cohorts) == 1
    c = rep.cohorts[0]
    assert c.kind == "stacked" and c.requests == 3 and c.admitted_mid_run == 1
    assert c.recompiles == 0 and c.membership_changes >= 1
    mid = {o.rid: o for o in rep.outcomes}[2]
    assert mid.admitted_mid_run and mid.slot == 1 and rep.bit_identical is True
    # the admitted request is its own run (its seed, its horizon) at K = 2,
    # the founder beside it undisturbed
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=2)
    from repro_torch.core import GraphEnsemble

    for o in rep.outcomes:
        want = rt.execute_ensemble(GraphEnsemble((o.graph, o.graph)), [_ref_init(o.graph)] * 2)
        _shows(want)
        np.testing.assert_array_equal(o.output, want[o.slot])


def test_admission_captures_nothing(fake_card):
    """With the stand-in CUDA graph API in place (a capture counts into
    ``_build.CAPTURES``), serving a stream whose cohort admits mid-run
    captures nothing, and a capture made between a cohort's first launch
    and its end is refused."""
    before = _build.CAPTURES["graphs"]
    rep = _serve("readmission")
    assert rep.cohorts[0].admitted_mid_run == 1
    assert _build.CAPTURES["graphs"] == before

    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=2)
    real = rt.build_ensemble_launches

    def capturing_plan(ens):
        lp = real(ens)
        admit = lp.admit_fn

        def admit_and_capture(carry, slot, init):
            _capture.GraphRun(lambda x: x + 1.0, torch.zeros(2))
            return admit(carry, slot, init)

        return dataclasses.replace(lp, admit_fn=admit_and_capture)

    rt.build_ensemble_launches = capturing_plan
    slots = STREAMS["readmission"][1]
    with pytest.raises(RuntimeError, match="re-captured 1x"):
        ServingFabric(rt, max_slots=slots, clock=LaunchClock()).serve(_requests("readmission"))


def test_fabric_rejects_duplicate_rids():
    fabric = ServingFabric(get_runtime("pallas_step", device="cpu", steps_per_launch=2),
                           max_slots=2, clock=LaunchClock())
    with pytest.raises(ValueError, match="rid"):
        fabric.serve([make_request(0, steps=3), make_request(0, steps=4)])
    with pytest.raises(ValueError, match="max_slots"):
        ServingFabric(fabric.runtime, max_slots=0)


@pytest.mark.parametrize("name", ["mixed", "drawn-nearest-S4"])
def test_fabric_over_row_shards_equals_one_device(name):
    """The sharded launch plans (admission on the member's ring) serve the
    same stream to the same bits and census as one device."""
    one, two = _serve(name), _serve(name, devices=["cpu"] * 2)
    assert two.bit_identical is True
    for a, b in zip(one.outcomes, two.outcomes):
        assert (a.rid, a.status, a.effective_steps, a.slot) == (b.rid, b.status,
                                                                b.effective_steps, b.slot)
        np.testing.assert_array_equal(a.output, b.output)
    assert [c.admitted_mid_run for c in one.cohorts] == [c.admitted_mid_run for c in two.cohorts]


def test_wall_clock_pass_reports_latency_and_utilization():
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=2)
    reqs = [make_request(k, steps=5 + k, seed=k) for k in range(5)]
    rep = ServingFabric(rt, max_slots=2, clock=WallClock()).serve(reqs)
    assert len(rep.completed) == 5 and rep.bit_identical is None
    pct = rep.latency_percentiles_s()
    assert 0 < pct["p50"] <= pct["p95"] <= pct["p99"] <= max(o.finished_s for o in rep.outcomes)
    assert all(0 < c.slot_utilization <= 1 for c in rep.cohorts)
