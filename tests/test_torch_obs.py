"""The port's observability (``repro_torch.obs``, ``trace=``, ``trace_once``)
against the reference's (``repro.obs``) on the CPU.

  * the tracer, the exporters and the decomposition: the reference's unit
    tests as cases against the port's ``obs``; both packages' ``summarize``
    on one hand-built list of spans, equal; the port's JSONL read back to
    the same spans, and its files byte for byte the reference's;
  * the null tracer by structure (one shared context, empty ``__slots__``,
    no clock read), not by a wall ratio;
  * every backend's traced twin at D = 1 on the reference's graphs
    (W = 16 or 32, T = 6, payload 8, radius 1) at grain 8, grain 1 and
    memory_bound: bit for bit the port's ``execute``, within the reference
    tests' tolerances of the reference's ``trace_once``, fractions summing
    to 1, dispatch above 0, the same ordered (name, category) spans as the
    reference apart from the divergences by design (`_expected_sequence`),
    and for ``pallas_step`` the same ``schedule.resolve`` record;
  * the same over D = 2 and 4 row shards (the reference on forced host
    devices in one subprocess, `run_traced_reference`), with the pipelined
    path's three probes and a well-formed verdict;
  * the run-level contracts: the warm-up's spans dropped, the null tracer's
    ``trace_once`` is ``execute``, the production path records nothing and
    issues what it issued; the stacking-degradation records; the tracer hook
    of ``OverheadProfiler``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.obs as ref_obs
import repro_torch.obs as obs
from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import _halo
from repro_torch.obs import (
    CAT_DECISION,
    CAT_LAUNCH,
    CATEGORIES,
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    coerce_tracer,
    summarize,
    to_chrome_trace,
    union_us,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.decompose import (
    category_walls,
    overlap_verdict,
    probe_costs,
    wall_extent_us,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=1e-5, atol=1e-5)
#: the schedule.resolve keys a traced pallas_step run shares with the reference
RECORD_KEYS = ("plan", "steps_per_launch", "pipeline", "runtime", "pattern", "width",
               "launches")


# ---------------------------------------------------------------- tracer --

def test_span_nesting_records_depth():
    tr = Tracer()
    with tr.span("outer", "dispatch"):
        with tr.span("inner", "compute.interior", step=3):
            pass
    assert [s.name for s in tr.spans] == ["inner", "outer"]
    inner, outer = tr.spans
    assert inner.depth == 1 and outer.depth == 0
    assert inner.attrs == {"step": 3}
    assert inner.start_us >= outer.start_us
    assert inner.end_us <= outer.end_us
    assert outer.duration_us >= inner.duration_us >= 0.0


def test_unknown_category_rejected():
    tr = Tracer()
    with pytest.raises(ValueError, match="unknown span category"):
        tr.span("x", "comms")
    with pytest.raises(ValueError, match="unknown span category"):
        tr.add("x", "comms", 0.0, 1.0)
    for cat in CATEGORIES + (CAT_LAUNCH,):
        with tr.span("x", cat):
            pass
    assert CATEGORIES == ref_obs.CATEGORIES
    assert (obs.CAT_FAULT, CAT_LAUNCH, CAT_DECISION) == (
        ref_obs.CAT_FAULT, ref_obs.CAT_LAUNCH, ref_obs.CAT_DECISION)


def test_add_and_instant_and_clear():
    tr = Tracer()
    tr.add("probe", "exchange", 10.0, 25.0, probe=True, phase="exchange",
           per_launch_us=5.0)
    tr.instant("schedule.resolve", plan="halo")
    assert tr.spans[0].duration_us == 15.0
    dec = tr.spans[1]
    assert dec.category == CAT_DECISION
    assert dec.start_us == dec.end_us
    assert dec.attrs["plan"] == "halo"
    tr.clear()
    assert tr.spans == [] and tr._depth == 0


def test_coerce_tracer():
    assert coerce_tracer(None) is NULL_TRACER
    assert coerce_tracer(False) is NULL_TRACER
    assert isinstance(coerce_tracer(True), Tracer)
    assert isinstance(coerce_tracer("on"), Tracer)
    assert isinstance(coerce_tracer(1), Tracer)
    tr = Tracer()
    assert coerce_tracer(tr) is tr
    assert coerce_tracer(NULL_TRACER) is NULL_TRACER
    with pytest.raises(ValueError, match="trace option"):
        coerce_tracer("loud")


def test_null_tracer_is_inert_by_structure(monkeypatch):
    """The off-by-default contract, checked by structure: every call is a
    no-op that reads no clock, ``span()`` hands back one shared context,
    and the instance cannot grow state."""
    nt = NULL_TRACER
    assert isinstance(nt, NullTracer) and nt.enabled is False
    assert NullTracer.__slots__ == ()
    with pytest.raises(AttributeError):
        nt.spans_seen = 1

    def no_clock():
        raise AssertionError("the null tracer read the clock")

    monkeypatch.setattr(time, "perf_counter", no_clock)
    ctx1 = nt.span("a", "dispatch", step=0)
    ctx2 = nt.span("b", "nonsense-category")  # not even validated
    assert ctx1 is ctx2
    with ctx1:
        pass
    nt.add("x", "exchange", 0.0, 1.0)
    nt.instant("x", plan="halo")
    nt.clear()
    assert nt.now_us() == 0.0
    assert nt.spans == ()
    assert _halo.transport_span(nt, "halo_exchange", impl="xla") is not None


# ------------------------------------------------------------- exporters --

def _spans_for_export(mod=obs):
    return [
        mod.Span("launch", "dispatch", 10.0, 30.0, 0, {"launch": 0}),
        mod.Span("decide", CAT_DECISION, 12.0, 12.0, 1, {"plan": "halo"}),
        mod.Span("kernel", "compute.interior", 15.0, 28.0, 1, {}),
    ]


def test_chrome_trace_schema():
    doc = to_chrome_trace(_spans_for_export(), process_name="t")
    assert doc["schemaVersion"] == 1 == ref_obs.TRACE_SCHEMA_VERSION
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M" and evs[0]["args"]["name"] == "t"
    complete = [e for e in evs if e["ph"] == "X"]
    instants = [e for e in evs if e["ph"] == "i"]
    assert len(complete) == 2 and len(instants) == 1
    k = next(e for e in complete if e["name"] == "kernel")
    assert k["ts"] == 15.0 and k["dur"] == 13.0 and k["tid"] == 1
    assert k["args"]["category"] == "compute.interior"
    assert instants[0]["args"]["plan"] == "halo"
    assert doc == ref_obs.to_chrome_trace(_spans_for_export(ref_obs), process_name="t")


def test_write_chrome_trace_and_jsonl_roundtrip(tmp_path):
    spans = _spans_for_export()
    cpath = write_chrome_trace(str(tmp_path / "t.json"), spans)
    with open(cpath) as f:
        doc = json.load(f)
    assert len(doc["traceEvents"]) == 4
    jpath = write_jsonl(str(tmp_path / "t.jsonl"), spans)
    lines = [json.loads(ln) for ln in open(jpath)]
    assert lines[0] == {"schema": 1}
    assert len(lines) == 4
    assert lines[1]["name"] == "launch" and lines[1]["end_us"] == 30.0
    assert lines[2]["attrs"] == {"plan": "halo"}
    # either package's writer gives the same file
    rpath = ref_obs.write_jsonl(str(tmp_path / "r.jsonl"), _spans_for_export(ref_obs))
    assert open(jpath).read() == open(rpath).read()


# ------------------------------------------------------------- decompose --

def test_union_merges_overlaps():
    assert union_us([(0, 10), (5, 15), (20, 25)]) == 20.0
    assert union_us([(0, 0), (3, 2)]) == 0.0


def test_category_walls_no_double_count_and_idle():
    spans = [
        Span("a", "dispatch", 0.0, 10.0),
        Span("b", "dispatch", 5.0, 12.0),
        Span("c", "exchange", 20.0, 30.0),
        Span("d", CAT_DECISION, 1.0, 1.0),
    ]
    walls = category_walls(spans)
    assert walls["dispatch"] == 12.0
    assert walls["exchange"] == 10.0
    assert wall_extent_us(spans) == 30.0
    assert walls["idle"] == pytest.approx(8.0)
    s = summarize(spans)
    assert s["schema"] == 1 == ref_obs.DECOMPOSE_SCHEMA_VERSION and s["span_count"] == 4
    assert sum(s["fractions"].values()) == pytest.approx(1.0)
    assert s["decisions"] == [{"name": "d"}]


def _probe(phase, cost, mod=obs):
    return mod.Span(f"probe.{phase}", "exchange", 100.0, 101.0, 0,
                    {"probe": True, "phase": phase, "per_launch_us": cost})


def test_launch_split_known_answer():
    spans = [Span("L", CAT_LAUNCH, 0.0, 100.0),
             _probe("boundary", 20.0), _probe("interior", 70.0), _probe("exchange", 40.0)]
    assert probe_costs(spans) == {"boundary": 20.0, "interior": 70.0, "exchange": 40.0}
    walls = category_walls(spans)
    assert walls["compute.boundary"] == 20.0
    assert walls["compute.interior"] == 70.0
    assert walls["exchange"] == 10.0
    assert walls["dispatch"] == 0.0
    v = overlap_verdict(spans)
    assert v["verdict"] == "hidden"
    assert v["hidden_fraction"] == pytest.approx(0.75)
    assert v["exchange_hidden_us"] == pytest.approx(30.0)


def test_launch_split_visible_and_slack():
    spans = [Span("L", CAT_LAUNCH, 0.0, 140.0),
             _probe("boundary", 20.0), _probe("interior", 70.0), _probe("exchange", 40.0)]
    walls = category_walls(spans)
    assert walls["exchange"] == 40.0
    assert walls["dispatch"] == pytest.approx(10.0)
    v = overlap_verdict(spans)
    assert v["verdict"] == "visible"
    assert v["hidden_fraction"] == 0.0


def test_overlap_verdict_edge_cases():
    assert overlap_verdict([Span("k", "compute.interior", 0, 5)]) is None
    v = overlap_verdict([Span("L", CAT_LAUNCH, 0.0, 10.0)])
    assert v["verdict"] == "unavailable"
    spans = [Span("k", "exchange", 0.0, 10.0), _probe("exchange", 5.0)]
    assert wall_extent_us(spans) == 10.0
    assert category_walls(spans)["exchange"] == 10.0


def test_summarize_empty():
    s = summarize([])
    assert s["wall_us"] == 0.0 and s["span_count"] == 0
    assert s["overlap"] is None


def _mixed_spans(mod):
    """Launches, probes, decisions, nested and overlapping spans of every
    category, with one idle gap: a trace of every shape decompose reads."""
    S = mod.Span
    return [
        S("t0_launch", "dispatch", 0.0, 4.0),
        S("t0_kernel", "compute.interior", 4.0, 9.5),
        S("schedule.resolve", CAT_DECISION, 0.0, 0.0, 0, {"plan": "halo", "reason": "x"}),
        S("prologue_exchange", "exchange", 9.5, 12.0, 0, {"setup": True}),
        S("pipelined_launch", CAT_LAUNCH, 12.0, 47.0, 0, {"launch": 0}),
        S("pipelined_launch", CAT_LAUNCH, 47.0, 75.5, 0, {"launch": 1}),
        S("gather_global", "gather", 80.0, 90.0),
        S("inner", "gather", 85.0, 95.0, 1),
        S("blocked_kernel", "compute.interior", 95.0, 120.0),
        S("boundary", "compute.boundary", 118.0, 125.0),
        S("fault", "fault", 125.0, 126.5),
        _probe("exchange", 12.5, mod), _probe("boundary", 9.0, mod),
        _probe("interior", 21.25, mod),
    ]


def test_both_decomposes_agree_on_one_trace(tmp_path):
    """One hand-built trace through the reference's ``summarize`` and the
    port's: equal; the port's JSONL reads back to the same spans."""
    mine, theirs = _mixed_spans(obs), _mixed_spans(ref_obs)
    got, want = summarize(mine), ref_obs.summarize(theirs)
    assert got == want
    assert got["overlap"]["verdict"] in ("hidden", "visible")
    assert got["categories_us"]["idle"] == pytest.approx(4.5)
    path = write_jsonl(str(tmp_path / "t.jsonl"), mine)
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0] == {"schema": obs.TRACE_SCHEMA_VERSION}
    back = [Span(d["name"], d["category"], d["start_us"], d["end_us"], d["depth"],
                 d["attrs"]) for d in lines[1:]]
    assert back == mine
    assert summarize(back) == want


# --------------------------------------------------- schedule decisions --

def test_record_resolution_null_and_live():
    from repro.kernels.schedule import record_resolution as ref_record
    from repro_torch.kernels.schedule import record_resolution

    record_resolution(None, plan="halo", steps_per_launch=4, pipeline=True)
    record_resolution(NULL_TRACER, plan="halo", steps_per_launch=4, pipeline=True)
    tr, rt = Tracer(), ref_obs.Tracer()
    kw = dict(plan="halo", steps_per_launch=4, pipeline=True, reason="covering rule",
              pattern="stencil_1d")
    record_resolution(tr, **kw)
    ref_record(rt, **kw)
    (s,) = tr.spans
    assert s.category == CAT_DECISION and s.name == "schedule.resolve"
    assert s.attrs["plan"] == "halo"
    assert s.attrs["steps_per_launch"] == 4
    assert s.attrs["pipeline"] is True
    assert s.attrs["reason"] == "covering rule"
    assert s.attrs["cost_model_source"] in ("analytic", "measured", "env")
    assert s.attrs["exchange_row_steps"] > 0
    assert s.attrs == rt.spans[0].attrs


def test_transport_span_category_and_traced_transports():
    """``transport_span``: a kind naming a gather lands in the gather
    category, every other in exchange; a transport given a tracer records
    its span, with the span's attributes, and is synchronous (the rows are
    there when it returns); with none it records nothing."""
    tr = Tracer()
    with _halo.transport_span(tr, "gather_global", impl="xla", step=1):
        pass
    with _halo.transport_span(tr, "deep_exchange", impl="ppermute", depth=4):
        pass
    assert [(s.name, s.category) for s in tr.spans] == [
        ("gather_global", "gather"), ("deep_exchange", "exchange")]
    assert tr.spans[1].attrs == {"impl": "ppermute", "depth": 4}
    assert isinstance(_halo.transport_span(None, "x", impl="xla"),
                      type(_halo.transport_span(NULL_TRACER, "x", impl="xla")))
    mesh = _halo.ShardMesh(["cpu"] * 4)
    sh = [torch.arange(6.0).reshape(6, 1) + 10 * d for d in range(4)]
    tr.clear()
    want = _halo.exchange_halos(sh, 2, mesh)
    got = _halo.exchange_halos(sh, 2, mesh, tracer=tr, span={"name": "deep_exchange",
                                                             "launch": 3})
    assert all(torch.equal(a, b) for a, b in zip(want[0] + want[1], got[0] + got[1]))
    _halo.exchange_stride(mesh, sh, (1,), tracer=tr, span={"step": 2})
    _halo.gather_global(sh, mesh, impl="chunked", tracer=tr)
    _halo.exchange_halos(sh, 2, mesh, tracer=NULL_TRACER)
    assert [(s.name, s.category, s.attrs.get("impl")) for s in tr.spans] == [
        ("deep_exchange", "exchange", "ppermute"), ("stride_exchange", "exchange", "xla"),
        ("gather_global", "gather", "chunked")]
    assert tr.spans[0].attrs["launch"] == 3 and tr.spans[0].attrs["depth"] == 2
    assert tr.spans[1].attrs["step"] == 2


# ------------------------------------------------------ traced executors --

FORMS = {"grain8": ("compute_bound", 8), "grain1": ("compute_bound", 1),
         "memory": ("memory_bound", 2)}


def _spec(pattern, form, **kw):
    kind, iters = FORMS[form]
    return dict(dict(steps=6, width=16, payload=8, radius=1, seed=3, pattern=pattern,
                     kernel=dict(kind=kind, iterations=iters, scratch=30)), **kw)


def _port_graph(spec):
    spec = dict(spec)
    return TaskGraph(kernel=KernelSpec(**spec.pop("kernel")), **spec)


def _ref_graph(spec):
    from repro.core import KernelSpec as RefSpec
    from repro.core import TaskGraph as RefGraph

    spec = dict(spec)
    return RefGraph(kernel=RefSpec(**spec.pop("kernel")), **spec)


def _tol(form):
    return MEMORY_TOL if form == "memory" else COMPUTE_TOL


def _real(spans):
    """The ordered (name, category) of the spans that carry wall."""
    return [(s.name, s.category) for s in spans
            if s.category != CAT_DECISION and not s.attrs.get("probe")]


def _expected_sequence(ref_seq, devices):
    """The reference's span sequence as the port records it, by design
    (ROADMAP Queue 3): the port cuts its extended tables once per build, so
    no run has a ``table_exchange``; on one device no rows move between
    shards, so where the one-device form moves none (the S = 1 step's wrap
    folded into K3, the pipelined prologue's views, the gather of the state
    itself) there is no transport span."""
    drop = {"table_exchange"}
    if devices == 1:
        drop |= {"halo_exchange", "prologue_exchange", "gather_global"}
    return [(n, c) for n, c in ref_seq if n not in drop]


def _decision(spans):
    recs = [s.attrs for s in spans if s.category == CAT_DECISION]
    assert len(recs) == 1, recs
    return {k: recs[0][k] for k in RECORD_KEYS}


BACKEND_CASES = [
    ("fused", "stencil_1d", {}, {}),
    ("serialized", "stencil_1d", {}, {}),
    ("bsp", "stencil_1d", {}, {}),
    ("bsp", "fft", {}, {}),
    ("bsp", "spread", {}, {}),
    ("bsp_scan", "stencil_1d", {}, {}),
    ("overlap", "stencil_1d", {}, {}),
]
PALLAS_CASES = [
    ("halo-S1", "stencil_1d", {}, {}),
    ("blocked-serial", "stencil_1d", {}, dict(steps_per_launch=2, pipeline=False)),
    ("blocked-pipelined", "stencil_1d", {"width": 32}, dict(steps_per_launch=2)),
    ("stride", "fft", {}, {}),
    ("allgather-step", "spread", {}, {}),
    ("allgather-blocked", "spread", {}, dict(steps_per_launch=2)),
    ("allgather-period1", "all_to_all", {}, {}),
]
D1_CASES = ([(n, p, g, o) for n, p, g, o in BACKEND_CASES]
            + [("pallas_step", p, g, o) for _, p, g, o in PALLAS_CASES])
D1_IDS = ([f"{n}-{p}" for n, p, _, _ in BACKEND_CASES]
          + [f"pallas_step-{label}" for label, *_ in PALLAS_CASES])


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,pattern,gkw,opts", D1_CASES, ids=D1_IDS)
def test_traced_matches_execute_and_reference(name, pattern, gkw, opts, form):
    from repro.core import get_runtime as ref_runtime
    from repro.core.task_kernels import initial_state

    spec = _spec(pattern, form, **gkw)
    g, rg = _port_graph(spec), _ref_graph(spec)
    init = np.asarray(initial_state(rg.width, rg.payload, rg.seed))
    rrt = ref_runtime(name, trace=True, **opts)
    want = np.asarray(rrt.trace_once(rg, init))
    rt = get_runtime(name, device="cpu", trace=True, **opts)
    out = rt.trace_once(g, init)
    np.testing.assert_array_equal(
        out, get_runtime(name, device="cpu", **opts).execute(g, init))
    np.testing.assert_allclose(out, want, **_tol(form))
    spans = rt.tracer.spans
    s = summarize(spans)
    assert s["span_count"] > 0 and s["wall_us"] > 0
    assert sum(s["fractions"].values()) == pytest.approx(1.0)
    assert s["fractions"]["dispatch"] > 0
    assert _real(spans) == _expected_sequence(_real(rrt.tracer.spans), 1)
    if name == "pallas_step":
        assert _decision(spans) == _decision(rrt.tracer.spans)
        assert s["decisions"][0]["name"] == "schedule.resolve"


def test_trace_once_null_tracer_is_plain_execute():
    g = _port_graph(_spec("stencil_1d", "grain1"))
    rt = get_runtime("bsp", device="cpu")
    assert rt.tracer is NULL_TRACER
    np.testing.assert_array_equal(rt.trace_once(g), rt.execute(g))
    assert rt.tracer.spans == ()


@pytest.mark.parametrize("name,opts", [("serialized", {}),
                                       ("pallas_step", dict(steps_per_launch=2))])
def test_trace_once_warmup_does_not_duplicate_spans(name, opts):
    g = _port_graph(_spec("stencil_1d", "grain1", width=32))
    rt = get_runtime(name, device="cpu", trace=True, **opts)
    rt.trace_once(g)
    n1 = len(rt.tracer.spans)
    rt.tracer.clear()
    rt.trace_once(g)
    assert len(rt.tracer.spans) == n1


def test_pallas_pipelined_one_device_probes_and_verdict():
    """On one device the pipelined launch's exchange is a self-wrap of two
    views: the launches and the boundary and interior probes are recorded,
    no exchange probe, and the verdict says why it is unavailable."""
    g = _port_graph(_spec("stencil_1d", "grain1", width=32, steps=9))
    rt = get_runtime("pallas_step", device="cpu", trace=True, steps_per_launch=4,
                     trace_probe_reps=3)
    rt.trace_once(g)
    spans = rt.tracer.spans
    launches = [s for s in spans if s.category == CAT_LAUNCH]
    assert len(launches) == 2 and all(s.attrs["kernel_launches"] == 2 for s in launches)
    costs = probe_costs(spans)
    assert set(costs) == {"boundary", "interior"} and all(v > 0 for v in costs.values())
    assert all(s.attrs["reps"] == 3 for s in spans if s.attrs.get("probe"))
    v = summarize(spans)["overlap"]
    assert v == {"verdict": "unavailable", "reason": "no exchange probe span recorded",
                 "launches": 2}


def _issued_ops(fn):
    """The aten operations ``fn()`` issues, in order."""

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Log() as log:
        fn()
    return log.ops


@pytest.mark.parametrize("name,devices,opts", [
    ("pallas_step", 1, dict(steps_per_launch=2)),
    ("pallas_step", 2, dict(steps_per_launch=2)),
    ("pallas_step", 1, {}),
    ("bsp", 2, {}),
    ("serialized", 1, {}),
])
def test_production_path_records_nothing_and_issues_the_same(name, devices, opts):
    """``trace=True`` leaves ``build``, ``measure`` and
    ``dispatches_per_run`` as they were: the same operations issued, the
    same counts, the same bits, and no span outside ``trace_once``."""
    g = _port_graph(_spec("stencil_1d", "grain1", width=32))
    on = get_runtime(name, devices=["cpu"] * devices, trace=True, **opts)
    off = get_runtime(name, devices=["cpu"] * devices, **opts)
    x = torch.from_numpy(np.random.default_rng(0).random((32, 8), np.float32))
    outs = []
    ops = [_issued_ops(lambda rt=rt: outs.append(rt.build(g)(x.clone()))) for rt in (on, off)]
    assert ops[0] == ops[1]
    assert torch.equal(outs[0], outs[1])
    assert on.dispatches_per_run(g) == off.dispatches_per_run(g)
    _, st_on = on.measure(g, reps=1, warmup=1)
    _, st_off = off.measure(g, reps=1, warmup=1)
    assert (st_on.dispatches, st_on.host_calls) == (st_off.dispatches, st_off.host_calls)
    on.execute(g)
    assert on.tracer.enabled and on.tracer.spans == []


def test_trace_options_known_to_every_backend():
    for name in ("fused", "serialized", "bsp", "bsp_scan", "overlap", "pallas_step"):
        rt = get_runtime(name, device="cpu", trace=True, trace_probe_reps=4)
        assert isinstance(rt.tracer, Tracer)
    with pytest.raises(ValueError, match="unknown options"):
        get_runtime("fused", device="cpu", tracing=True)


# -------------------------------------------- stacking degradation record --

def _ensemble_record(mod_runtime, members, launches, **opts):
    rt = mod_runtime("pallas_step", trace=True, **opts)
    if launches:
        rt.build_ensemble_launches(members)
    else:
        rt.build_ensemble(members)
    return [s.attrs for s in rt.tracer.spans if s.category == CAT_DECISION]


@pytest.mark.parametrize("launches", [False, True], ids=["tuple", "stepwise"])
def test_stacking_degradation_record_matches_reference(launches):
    from repro.core import GraphEnsemble as RefEnsemble
    from repro.core import get_runtime as ref_runtime

    specs = [_spec("stencil_1d", "grain1"), _spec("fft", "grain1"),
             _spec("stencil_1d", "memory", width=32)]
    ens = GraphEnsemble([_port_graph(s) for s in specs])
    ref_ens = RefEnsemble([_ref_graph(s) for s in specs])
    got = _ensemble_record(lambda *a, **k: get_runtime(*a, device="cpu", **k), ens, launches)
    want = _ensemble_record(ref_runtime, ref_ens, launches)
    assert len(got) == 1 and got == want
    assert got[0]["plan"] == ("stepwise" if launches else "tuple")
    assert got[0]["reason"].startswith("ensemble off the stacked fast path: ")
    # a stacked ensemble records nothing
    stacked = GraphEnsemble([_port_graph(_spec("stencil_1d", "grain1", seed=k))
                             for k in range(2)])
    rt = get_runtime("pallas_step", device="cpu", trace=True)
    rt.build_ensemble(stacked)
    rt.build_ensemble_launches(stacked)
    assert rt.tracer.spans == []


# ------------------------------------------------------- OverheadProfiler --

def test_overhead_profiler_category_fractions_match_reference():
    from repro.core.instrumentation import OverheadProfiler as RefProfiler
    from repro_torch.core.instrumentation import OverheadProfiler

    reports = []
    for mod, prof_cls in ((obs, OverheadProfiler), (ref_obs, RefProfiler)):
        tr = mod.Tracer()
        tr.spans.extend(_mixed_spans(mod))
        prof = prof_cls(devices=2, tasks_per_step=4, tracer=tr)
        prof._dispatch = 1e-5  # the dispatch probe is each package's own
        for wall in (0.004, 0.002, 0.003):
            prof.record(wall)
        reports.append(prof.report())
    got, want = reports
    assert got.category_fractions == want.category_fractions
    assert sum(got.category_fractions.values()) == pytest.approx(1.0)
    assert any(line.startswith("wall by category") for line in got.lines())
    assert OverheadProfiler().tracer is None


# -------------------------------------------------- row shards, D = 2, 4 --

#: the reference's traced runs: one JSON list of cases in, every case's
#: initial state and result, its span sequence and its decision records out
REF_TRACE_RUNNER = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import KernelSpec, TaskGraph, get_runtime
from repro.core.task_kernels import initial_state

cases = json.load(open(sys.argv[1]))
arrays, meta = {}, {}
for c in cases:
    spec = dict(c["graph"])
    g = TaskGraph(kernel=KernelSpec(**spec.pop("kernel")), **spec)
    rt = get_runtime(c["runtime"], devices=jax.devices()[:c["D"]], trace=True, **c["options"])
    x = np.asarray(initial_state(g.width, g.payload, g.seed))
    arrays[c["key"] + "/init"] = x
    arrays[c["key"] + "/out"] = np.asarray(rt.trace_once(g, jnp.asarray(x)))
    spans = rt.tracer.spans
    meta[c["key"]] = {
        "real": [[s.name, s.category] for s in spans
                 if s.category != "decision" and not s.attrs.get("probe")],
        "probes": sorted(s.attrs["phase"] for s in spans if s.attrs.get("probe")),
        "decisions": [{k: v for k, v in s.attrs.items()} for s in spans
                      if s.category == "decision"]}
np.savez(sys.argv[2], **arrays)
json.dump(meta, open(sys.argv[3], "w"))
"""

SHARD_CASES = [
    ("pallas_step", "halo-S1", "stencil_1d", {}, {}),
    ("pallas_step", "blocked-serial", "stencil_1d", {},
     dict(steps_per_launch=2, pipeline=False)),
    ("pallas_step", "blocked-pipelined", "stencil_1d", {"width": 32}, dict(steps_per_launch=2)),
    ("pallas_step", "stride", "fft", {}, {}),
    ("pallas_step", "allgather-step", "spread", {}, {}),
    ("pallas_step", "allgather-blocked", "spread", {}, dict(steps_per_launch=2)),
    ("pallas_step", "allgather-period1", "all_to_all", {}, {}),
    ("bsp", "bsp", "stencil_1d", {}, {}),
    ("overlap", "overlap", "stencil_1d", {}, {}),
]
SHARD_FORMS = ("grain1", "memory")
SHARD_MATRIX = [dict(key=f"{label}-{form}-D{D}", runtime=name, D=D, options=opts,
                     graph=_spec(pattern, form, **gkw), form=form)
                for D in (2, 4) for name, label, pattern, gkw, opts in SHARD_CASES
                for form in SHARD_FORMS]


def run_traced_reference(cases, devices, out_dir):
    """The reference's traced runs of ``cases`` on ``devices`` forced host
    devices, in one subprocess: (arrays, meta by case key)."""
    src, npz, meta = (os.path.join(str(out_dir), n)
                      for n in ("cases.json", "ref.npz", "meta.json"))
    with open(src, "w") as f:
        json.dump([{k: v for k, v in c.items() if k != "form"} for c in cases], f)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               REPRO_COST_MODEL="off")
    done = subprocess.run([sys.executable, "-c", REF_TRACE_RUNNER, src, npz, meta],
                          capture_output=True, text=True, timeout=900, env=env)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(npz) as z:
        arrays = dict(z)
    with open(meta) as f:
        return arrays, json.load(f)


@pytest.fixture(scope="module")
def shard_ref(tmp_path_factory):
    return run_traced_reference(SHARD_MATRIX, 4, tmp_path_factory.mktemp("ref"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", SHARD_MATRIX, ids=[c["key"] for c in SHARD_MATRIX])
def test_traced_shards_match_execute_and_reference(case, shard_ref):
    arrays, meta = shard_ref
    key, D = case["key"], case["D"]
    g = _port_graph(case["graph"])
    init = arrays[key + "/init"]
    rt = get_runtime(case["runtime"], devices=["cpu"] * D, trace=True, **case["options"])
    out = rt.trace_once(g, init)
    plain = get_runtime(case["runtime"], devices=["cpu"] * D, **case["options"])
    np.testing.assert_array_equal(out, plain.execute(g, init))
    np.testing.assert_allclose(out, arrays[key + "/out"], **_tol(case["form"]))
    spans = rt.tracer.spans
    s = summarize(spans)
    assert s["span_count"] > 0 and s["wall_us"] > 0
    assert sum(s["fractions"].values()) == pytest.approx(1.0)
    assert s["fractions"]["dispatch"] > 0
    ref = meta[key]
    assert _real(spans) == _expected_sequence([tuple(p) for p in ref["real"]], D)
    if case["runtime"] == "pallas_step":
        assert _decision(spans) == {k: ref["decisions"][0][k] for k in RECORD_KEYS}
    if "pipelined" in key:
        costs = probe_costs(spans)
        assert sorted(costs) == ref["probes"] == ["boundary", "exchange", "interior"]
        assert all(v > 0 for v in costs.values())
        v = s["overlap"]
        assert v["verdict"] in ("hidden", "visible")
        assert 0.0 <= v["hidden_fraction"] <= 1.0
        assert v["launches"] == len([x for x in spans if x.category == CAT_LAUNCH])
        assert v["exchange_per_launch_us"] == costs["exchange"]
