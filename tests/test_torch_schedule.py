"""Parity of the port's scheduler and cost model (``kernels/schedule.py``,
``kernels/probes.py``) and of ``pallas_step(steps_per_launch="auto")`` with
the JAX package's, on the CPU.

The policy functions (covers, pays off, plan ranking, launch walls and
deadlines) equal the reference's exactly (booleans, reason strings; walls
within ``rel=1e-12``) over a grid crossing shapes and analytic, env and
measured models, each model built from one dict through both packages'
codecs. The choosers equal the reference's when handed the reference's own
fit rule (its VMEM working set against a budget, built here), so the policy
is the reference's and only the fit rule differs. The codec, the cache file
and the precedence ladder (explicit > env > cache > analytic) are the
reference's. ``run_probes(device="cpu", smoke=True)`` runs the probes on
the plain path.

The runtime on small graphs (W <= 64, T <= 12) under the analytic model
(``tests/conftest.py`` pins ``REPRO_COST_MODEL=off``): "auto" resolves the
reference's (plan, S, pipelined) and launch count where the fit rules agree
(halo compute; the all-gather plan, whose launch fits when it takes K4's
resident form), and the port's documented answer where they do not
(memory_bound: S = 1, its reason naming the rule);
every "auto" output is within ``rtol=1e-5, atol=1e-6`` (compute) or
``atol=1e-5`` (memory_bound) of the reference's run and of ``fused``, and
equal bit for bit to the explicit run of the depth and schedule it resolved
to. Ensembles resolve the most conservative member's depth, and their launch
plans carry the reference's ``expected_launch_us`` under one measured model.
"""
import dataclasses
import json

import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

from repro.core import GraphEnsemble as RefEnsemble
from repro.core import KernelSpec as RefSpec
from repro.core import TaskGraph as RefGraph
from repro.core import get_runtime as ref_runtime
from repro.core.task_kernels import initial_state as ref_initial_state
from repro.kernels import probes as ref_probes
from repro.kernels import schedule as ref_schedule
from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import pallas_step as ps
from repro_torch.kernels import probes, schedule
from repro_torch.resilience.detect import DeadlineDetector

COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=0, atol=1e-5)
HALO = ("trivial", "no_comm", "stencil_1d", "stencil_1d_periodic", "dom",
        "nearest", "random_nearest")

#: The models of the grid, as dicts both codecs read: the analytic fallback,
#: an env constant, a one-device card calibration (X = 1) and a reference-
#: style multi-device one (X = 512, every transport priced).
MODELS = {
    "analytic": {"source": "analytic", "exchange_row_steps": 512.0},
    "env": {"source": "env", "exchange_row_steps": 64.0},
    "measured-card": dict(
        source="measured", exchange_row_steps=1.0, launch_us=2.1,
        row_step_us=1.7e-4, halo_exchange_us={"self": 0.0},
        gather_us={"64": 0.0, "256": 0.0, "512": 0.0},
        platform="NVIDIA H100 80GB HBM3", devices=1, payload=64),
    "measured-mesh": dict(
        source="measured", exchange_row_steps=512.0, launch_us=50.0,
        row_step_us=0.1, halo_exchange_us={"xla": 51.2},
        stride_exchange_us={"xla": 40.0}, gather_us={"64": 30.0, "512": 90.0},
        platform="cpu", devices=4, payload=8),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(name):
    """(port model, reference model) from one dict."""
    d = MODELS[name]
    return probes.CostModel.from_dict(d), ref_probes.CostModel.from_dict(d)


# --------------------------------------------------- the policy functions


@pytest.mark.parametrize("name", MODELS)
def test_pipeline_covers_equals_the_reference(name):
    ours, ref = _models(name)
    for block in (1, 8, 16, 64, 256, 2112, 8448):
        for radius in (0, 1, 2, 3):
            for S in (1, 2, 4, 8, 16):
                assert schedule.pipeline_interior_covers_exchange(block, radius, S, ours) \
                    == ref_schedule.pipeline_interior_covers_exchange(block, radius, S, ref)


@pytest.mark.parametrize("name", MODELS)
def test_gathered_pays_off_equals_the_reference(name):
    ours, ref = _models(name)
    for width in (1, 16, 128, 512, 2048):
        for block in sorted({1, width // 4 or 1, width // 2 or 1, width}):
            for S in (0, 1, 2, 8, 16):
                assert schedule.gathered_pays_off(width, block, S, ours) == \
                    ref_schedule.gathered_pays_off(width, block, S, ref)


@pytest.mark.parametrize("name", MODELS)
def test_gathered_beats_strides_equals_the_reference(name):
    """Verdict and reason string alike, for every impl, stride count and
    period (the analytic and env models decline with the same reason)."""
    ours, ref = _models(name)
    for width, block in ((16, 16), (128, 32), (512, 512), (2048, 256)):
        for S in (1, 2, 8, 16):
            for off, period in ((0, 4), (2, 4), (4, 4), (1, 7)):
                for impl in ("xla", "ppermute", "self"):
                    kw = dict(width=width, block=block, steps_per_launch=S,
                              off_block_strides=off, period=period, impl=impl)
                    assert schedule.gathered_beats_strides(model=ours, **kw) == \
                        ref_schedule.gathered_beats_strides(model=ref, **kw)


@pytest.mark.parametrize("name", MODELS)
def test_launch_walls_and_deadlines_equal_the_reference(name):
    ours, ref = _models(name)
    for rows in (8, 2112, 8448):
        for S in (0, 1, 8, 16):
            for gw in (None, 64, 300, 4096):
                for impl in ("xla", "self"):
                    kw = dict(rows=rows, steps_per_launch=S, impl=impl, gather_width=gw)
                    for fn, ref_fn in ((schedule.expected_launch_wall_us,
                                        ref_schedule.expected_launch_wall_us),
                                       (schedule.launch_deadline_us,
                                        ref_schedule.launch_deadline_us)):
                        got, want = fn(model=ours, **kw), ref_fn(model=ref, **kw)
                        assert (got is None) == (want is None) == (ours.launch_us is None)
                        if got is not None:
                            assert got == pytest.approx(want, rel=1e-12)
    assert schedule.DEADLINE_FACTOR == ref_schedule.DEADLINE_FACTOR
    assert schedule.CANDIDATES == ref_schedule.CANDIDATES
    assert schedule.PIPELINE_EXCHANGE_ROW_STEPS == ref_schedule.PIPELINE_EXCHANGE_ROW_STEPS
    assert schedule._EXCHANGE_ROW_STEPS_ENV == ref_schedule._EXCHANGE_ROW_STEPS_ENV


# ------------------------------------------------------------ the choosers

BUDGETS = (ref_schedule.DEFAULT_VMEM_BUDGET, 2 ** 20, 2 ** 17)


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_halo_chooser_equals_the_reference_under_its_fit_rule(name, pipeline):
    """Handed ``fits`` built from the reference's VMEM working set and a
    budget, the port's chooser returns the reference's S for that budget."""
    ours, ref = _models(name)
    for block in (8, 64, 512, 2112):
        for radius in (0, 1, 2):
            for payload, combine in ((8, "window"), (64, "gather"), (256, "onehot")):
                for budget in BUDGETS:
                    def fits(s, pipelined, block=block, radius=radius, payload=payload,
                             combine=combine, budget=budget):
                        return ref_schedule.blocked_working_set_bytes(
                            block, radius, s, payload, combine=combine,
                            pipeline=pipelined) <= budget

                    for total in (None, 1, 2, 7, 1000):
                        got = schedule.choose_steps_per_launch(
                            block=block, radius=radius, fits=fits, total_steps=total,
                            pipeline=pipeline, model=ours)
                        want = ref_schedule.choose_steps_per_launch(
                            block=block, radius=radius, payload=payload,
                            total_steps=total, vmem_budget=budget, combine=combine,
                            pipeline=pipeline, model=ref)
                        assert got == want, (block, radius, payload, budget, total)
                        assert schedule.resolve_steps_per_launch(
                            "auto", block=block, radius=radius, fits=fits,
                            total_steps=total, pipeline=pipeline, model=ours) == want


@pytest.mark.parametrize("time_varying", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_gathered_chooser_equals_the_reference_under_its_fit_rule(name, time_varying):
    ours, ref = _models(name)
    for width, block in ((16, 16), (128, 32), (512, 512), (512, 128)):
        for max_deps, combine in ((2, "onehot"), (3, "gather"), (width, "gather")):
            for payload in (8, 64):
                for budget in BUDGETS:
                    def fits(s, width=width, max_deps=max_deps, payload=payload,
                             combine=combine, budget=budget):
                        return ref_schedule.gathered_working_set_bytes(
                            width, max_deps, s, payload, combine=combine,
                            time_varying=time_varying) <= budget

                    for total in (None, 1, 2, 7, 1000):
                        got = schedule.choose_steps_per_launch_gathered(
                            width=width, block=block, fits=fits, total_steps=total,
                            model=ours)
                        want = ref_schedule.choose_steps_per_launch_gathered(
                            width=width, block=block, max_deps=max_deps, payload=payload,
                            total_steps=total, vmem_budget=budget, combine=combine,
                            time_varying=time_varying, model=ref)
                        assert got == want, (width, block, max_deps, payload, budget, total)


# ---------------------------------------------------------------- the codec


@pytest.mark.parametrize("name", MODELS)
def test_codec_round_trips_the_reference_model(name):
    ref = ref_probes.CostModel.from_dict(MODELS[name])
    d = ref.to_dict()
    ours = probes.CostModel.from_dict(d)
    assert ours.to_dict() == d
    assert ref_probes.CostModel.from_dict(ours.to_dict()) == ref
    assert ours.describe(64) == ref.describe(64) and ours.cache_key() == ref.cache_key()
    assert (ours.is_measured, ours.can_rank_plans) == (ref.is_measured, ref.can_rank_plans)
    assert probes.SCHEMA_VERSION == ref_probes.SCHEMA_VERSION


def test_cache_files_cross_between_the_packages(tmp_path):
    """A cache the reference writes loads into the port unchanged, and one
    the port writes loads into the reference; saves merge by key."""
    models = [ref_probes.CostModel.from_dict(d) for d in MODELS.values()
              if d["source"] == "measured"]
    path = tmp_path / "ref.json"
    for m in models:
        ref_probes.save_cost_model(m, path)
    ours = probes.load_cost_model(path)
    assert {k: m.to_dict() for k, m in ours.items()} == \
        {m.cache_key(): m.to_dict() for m in models}
    back = tmp_path / "port.json"
    for m in ours.values():
        probes.save_cost_model(m, back)
    assert ref_probes.load_cost_model(back) == {m.cache_key(): m for m in models}
    assert json.loads(back.read_text()) == json.loads(path.read_text())
    assert probes.DEFAULT_CACHE_PATH.parts[-2:] == ("bench_torch", "cost_model.json")


def test_cache_rejects_corruption_loudly(tmp_path):
    path = tmp_path / "cm.json"
    path.write_text("{ not json")
    with pytest.raises(ValueError, match="corrupt"):
        probes.load_cost_model(path)
    path.write_text(json.dumps({"schema": 999, "entries": {}}))
    with pytest.raises(ValueError, match="schema"):
        probes.load_cost_model(path)
    path.write_text(json.dumps([1, 2]))
    with pytest.raises(ValueError, match="schema"):
        probes.load_cost_model(path)
    entry = dict(MODELS["measured-card"], mystery_field=1)
    path.write_text(json.dumps({"schema": probes.SCHEMA_VERSION, "entries": {"k": entry}}))
    with pytest.raises(ValueError, match="corrupt"):
        probes.load_cost_model(path)


# ----------------------------------------------------- the precedence ladder


def _measured(**kw):
    """A measured model on this machine's platform (rankable)."""
    base = dict(MODELS["measured-mesh"], platform=probes._platform(), devices=1)
    base.update(kw)
    return probes.CostModel.from_dict(base)


def test_precedence_cached_beats_analytic(tmp_path, monkeypatch):
    path = tmp_path / "cm.json"
    probes.save_cost_model(_measured(exchange_row_steps=777.0), path)
    monkeypatch.setenv(probes.COST_MODEL_ENV, str(path))
    m = probes.default_cost_model(devices=1, payload=8)
    assert m.source == "measured" and m.exchange_row_steps == 777.0
    assert schedule.exchange_row_steps() == 777.0
    # a cache with no entry for this platform falls through to analytic
    monkeypatch.setattr(probes, "_platform", lambda device=None: "NVIDIA other")
    assert probes.default_cost_model(devices=1, payload=8).source == "analytic"


def test_precedence_env_beats_cache(tmp_path, monkeypatch):
    path = tmp_path / "cm.json"
    probes.save_cost_model(_measured(exchange_row_steps=777.0), path)
    monkeypatch.setenv(probes.COST_MODEL_ENV, str(path))
    monkeypatch.setenv(schedule._EXCHANGE_ROW_STEPS_ENV, "99")
    m = probes.default_cost_model(devices=1, payload=8)
    assert m.source == "env" and m.exchange_row_steps == 99.0
    assert not m.can_rank_plans


def test_precedence_explicit_beats_env(monkeypatch):
    monkeypatch.setenv(schedule._EXCHANGE_ROW_STEPS_ENV, "99")
    explicit = _measured(exchange_row_steps=321.0)
    assert schedule.exchange_row_steps(explicit) == 321.0
    assert schedule.gathered_pays_off(16, 16, 4, model=explicit)
    # ... and the runtime's cost_model option is that tier
    rt = get_runtime("pallas_step", device="cpu", cost_model=explicit.to_dict())
    assert rt._cost_model(8) == explicit


def test_precedence_off_pins_analytic(monkeypatch, tmp_path):
    path = tmp_path / "cm.json"
    probes.save_cost_model(_measured(), path)
    for off in ("off", "0", "none", "disabled"):
        monkeypatch.setenv(probes.COST_MODEL_ENV, off)
        m = probes.default_cost_model()
        assert m == probes.analytic_cost_model() == probes.CostModel.from_dict(
            ref_probes.analytic_cost_model().to_dict())
        assert not m.can_rank_plans


def test_invalid_env_and_corrupt_cache_raise(tmp_path, monkeypatch):
    """No fallback: an unreadable env value or cache raises, also through
    the runtime's "auto" resolution."""
    g = TaskGraph(steps=6, width=16, pattern="stencil_1d", payload=8,
                  kernel=KernelSpec("compute_bound", 1))
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch="auto")
    for bad in ("-3", "0"):
        monkeypatch.setenv(schedule._EXCHANGE_ROW_STEPS_ENV, bad)
        with pytest.raises(ValueError, match="positive"):
            schedule.exchange_row_steps()
        with pytest.raises(ValueError, match="positive"):
            rt._schedule_for_graph(g)
    monkeypatch.setenv(schedule._EXCHANGE_ROW_STEPS_ENV, "lots")
    with pytest.raises(ValueError):
        schedule.exchange_row_steps()
    monkeypatch.delenv(schedule._EXCHANGE_ROW_STEPS_ENV)
    path = tmp_path / "cm.json"
    path.write_text("{ not json")
    monkeypatch.setenv(probes.COST_MODEL_ENV, str(path))
    with pytest.raises(ValueError, match="corrupt"):
        rt._schedule_for_graph(g)
    # an explicit depth never consults the model
    assert get_runtime("pallas_step", device="cpu", steps_per_launch=3) \
        ._schedule_for_graph(g)[:2] == ("halo", 3)


def test_match_entry_platform_devices_payload():
    a = _measured(devices=2, payload=8)
    b = _measured(devices=2, payload=128)
    other = _measured(devices=4, payload=8)
    alien = _measured(platform="NVIDIA A100-SXM4-80GB", devices=2, payload=8)
    entries = {m.cache_key(): m for m in (a, b, other, alien)}
    ref_entries = {k: ref_probes.CostModel.from_dict(m.to_dict()) for k, m in entries.items()}
    plat = probes._platform()
    for devices, payload, want in ((2, 8, a), (2, 100, b), (4, 999, other), (8, 8, None),
                                   (2, None, a)):
        assert probes._match_entry(entries, plat, devices, payload) == want
        got = ref_probes._match_entry(ref_entries, plat, devices, payload)
        assert (got and got.to_dict()) == (want and want.to_dict())
    assert probes._match_entry(entries, "NVIDIA A100-SXM4-80GB", 2, 8) == alien
    assert probes._match_entry(entries, "rocm", 2, 8) is None


def test_coerce_cost_model_forms(tmp_path):
    m = _measured()
    assert probes.coerce_cost_model(m) is m
    assert probes.coerce_cost_model(m.to_dict()) == m
    path = tmp_path / "cm.json"
    probes.save_cost_model(m, path)
    assert probes.coerce_cost_model(str(path), devices=1, payload=8) == m
    assert probes.coerce_cost_model(path, devices=1, payload=8, platform="cpu") == m
    with pytest.raises(ValueError, match="no entry"):
        probes.coerce_cost_model(str(path), devices=64)
    with pytest.raises(ValueError, match="no entry"):
        probes.coerce_cost_model(str(path), devices=1, platform="NVIDIA H100 80GB HBM3")
    with pytest.raises(TypeError):
        probes.coerce_cost_model(3.14)


def test_gather_us_at_interpolates_as_the_reference():
    for curve in ({64: 30.0, 512: 90.0}, {64: 30.0}, {}, {16: 5.0, 64: 2.0, 512: 9.0}):
        d = dict(MODELS["measured-mesh"], gather_us={str(k): v for k, v in curve.items()})
        ours, ref = probes.CostModel.from_dict(d), ref_probes.CostModel.from_dict(d)
        for width in (1, 16, 40, 64, 288, 512, 1024):
            assert ours.gather_us_at(width) == ref.gather_us_at(width)
        assert ours.stride_us_for("shmem") == ref.stride_us_for("shmem")


# ----------------------------------------------------------------- the probes


def test_falsy_zero_exchange_gives_one_row_step(monkeypatch):
    """The repair of the reference's X derivation. The reference writes
    ``x = (exch / row_step) if exch else PIPELINE_EXCHANGE_ROW_STEPS``, so
    a measured exchange of 0.0 (one device: the exchange launches nothing)
    is taken for no measurement and turns into the analytic 512; the port
    tests ``exch is not None``, so X = max(1, 0) = 1, no depth's pipelined
    split pays off, and "auto" runs the serial schedule. Both run_probes
    are given the same probe results."""
    for mod, halo in ((probes, {"self": 0.0}), (ref_probes, {"xla": 0.0})):
        monkeypatch.setattr(mod, "probe_launch_us", lambda *a, **k: 2.0)
        monkeypatch.setattr(mod, "probe_row_step_us", lambda *a, **k: 1.7e-4)
        monkeypatch.setattr(mod, "probe_halo_exchange_us", lambda *a, h=halo, **k: dict(h))
        monkeypatch.setattr(mod, "probe_stride_exchange_us", lambda *a, **k: {})
        monkeypatch.setattr(mod, "probe_gather_us", lambda *a, **k: {64: 0.0})
    ours = probes.run_probes(device="cpu")
    ref = ref_probes.run_probes(devices=1)
    assert ours.exchange_row_steps == 1.0
    assert ref.exchange_row_steps == ref_schedule.PIPELINE_EXCHANGE_ROW_STEPS == 512
    for S in (2, 4, 8, 16):
        assert not schedule.pipeline_interior_covers_exchange(2112, 1, S, ours)
    assert schedule.pipeline_interior_covers_exchange(2112, 1, 8, probes.CostModel.from_dict(
        ref.to_dict()))
    g = TaskGraph(steps=1000, width=2112, pattern="stencil_1d", payload=64,
                  kernel=KernelSpec("compute_bound", 64))
    for model, want in ((ours, (16, False)), (ref.to_dict(), (8, True))):
        rt = get_runtime("pallas_step", device="cpu", steps_per_launch="auto",
                         cost_model=model)
        S = rt._schedule_for_graph(g).steps_per_launch
        assert (S, rt._pipeline_active(2112, S, 1, 64)) == want


def test_run_probes_on_the_plain_path(tmp_path):
    m = probes.run_probes(device="cpu", smoke=True)
    assert (m.source, m.platform, m.devices, m.payload) == ("measured", "cpu", 1, 64)
    assert m.launch_us > 0 and m.row_step_us >= probes.row_step_floor_us(64)
    assert m.halo_exchange_us == {probes.SELF_EXCHANGE: 0.0}
    assert m.stride_exchange_us == {} and m.gather_impl_us == {}
    assert m.gather_us == {w: 0.0 for w in probes.GATHER_WIDTHS}
    assert m.exchange_row_steps == 1.0 and m.can_rank_plans
    path = probes.save_cost_model(m, tmp_path / "cm.json")
    assert probes.load_cost_model(path) == {m.cache_key(): m}
    assert m.cache_key() == "cpu|d1|p64"
    assert probes.row_step_floor_us(64) == pytest.approx(0.1 * 512 / 3.35e12 * 1e6)


def test_probes_cli_and_no_fallback(tmp_path, capsys):
    out = tmp_path / "cm.json"
    assert probes.main(["--smoke", "--device", "cpu", "--payload", "8", "--out", str(out),
                        "--json"]) == 0
    text = capsys.readouterr().out
    assert "cpu|d1|p8" in text and "measured on cpu x1" in text
    (entry,) = probes.load_cost_model(out).values()
    assert entry.payload == 8 and json.loads(text[text.index("{"):]) == entry.to_dict()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probes.run_probes(smoke=True)
    # across row shards the probes price a real exchange (no longer refused)
    m4 = probes.run_probes(devices=4, device="cpu", smoke=True, payload=8)
    assert m4.devices == 4 and sorted(m4.halo_exchange_us) == ["ppermute", "xla"]
    assert probes.probe_stride_exchange_us(1) == {}
    assert probes.probe_halo_exchange_us(1) == {"self": 0.0}


# ------------------------------------------------------------- the runtime


def _pair(pattern, kind="compute_bound", iters=1, width=32, steps=12, payload=8, **kw):
    kw = dict(dict(radius=2, seed=3), **kw)
    spec = dict(kind=kind, iterations=iters, scratch=30)
    g = TaskGraph(steps=steps, width=width, pattern=pattern, payload=payload,
                  kernel=KernelSpec(**spec), **kw)
    r = RefGraph(steps=steps, width=width, pattern=pattern, payload=payload,
                 kernel=RefSpec(**spec), **kw)
    return g, r, np.asarray(ref_initial_state(width, payload, r.seed))


def _explicit_twin(rt, g):
    """The explicit run ``rt``'s "auto" resolved to: its plan's depth, and
    its pipeline verdict."""
    S = rt._schedule_for_graph(g).steps_per_launch
    piped = rt._pipeline_active(g.width, S, max(0, ps._patterns.halo_radius(g)), g.payload)
    opts = {k: v for k, v in rt.options.items() if k != "steps_per_launch"}
    opts.update(steps_per_launch=S, pipeline=piped)
    return get_runtime("pallas_step", device="cpu", **opts)


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("pattern", HALO)
def test_auto_halo_compute_equals_the_reference(pattern, combine):
    """Where the fit rules agree (halo compute at small widths), "auto" is
    the reference's (plan, S, pipelined) and launch count; its output is the
    reference's and fused's within tolerance, and its explicit twin's bit
    for bit."""
    for width, steps, pipeline in ((32, 12, True), (64, 7, False), (16, 2, True)):
        g, r, init = _pair(pattern, width=width, steps=steps)
        opts = dict(steps_per_launch="auto", combine=combine, pipeline=pipeline)
        rt, ref = get_runtime("pallas_step", device="cpu", **opts), ref_runtime(
            "pallas_step", **opts)
        got, want = rt._schedule_for_graph(g), ref._schedule_for_graph(r)
        H = ps._patterns.halo_radius(g)
        case = f"W={width} T={steps} pipeline={pipeline}"
        assert (got.kind, got.steps_per_launch) == (want.kind, want.steps_per_launch), case
        assert got.reason.startswith(f"auto -> S={got.steps_per_launch}"), got.reason
        assert rt._pipeline_active(width, got.steps_per_launch, H, g.payload) == \
            ref._pipeline_active(width, want.steps_per_launch, H, r.payload), case
        assert rt.dispatches_per_run(g) == ref.dispatches_per_run(r), case
        out = rt.execute(g, init)
        np.testing.assert_allclose(out, np.asarray(ref.execute(r, init)), **COMPUTE_TOL)
        np.testing.assert_allclose(
            out, get_runtime("fused", device="cpu").execute(g, init), **COMPUTE_TOL)
        np.testing.assert_array_equal(out, _explicit_twin(rt, g).execute(g, init))


@pytest.mark.parametrize("combine", ["window", "gather"])
@pytest.mark.parametrize("pattern", ["stencil_1d", "nearest", "random_nearest"])
def test_auto_pipelines_where_the_env_model_says_it_covers(pattern, combine, monkeypatch):
    """Under ``REPRO_PIPELINE_EXCHANGE_ROW_STEPS=64`` (both packages read it)
    a W = 64 block's interior covers the exchange at S = 2: "auto" runs the
    pipelined schedule there, as the reference's does, bit for bit its
    explicit pipelined twin."""
    monkeypatch.setenv(schedule._EXCHANGE_ROW_STEPS_ENV, "64")
    g, r, init = _pair(pattern, width=64, steps=12)
    opts = dict(steps_per_launch="auto", combine=combine)
    rt, ref = get_runtime("pallas_step", device="cpu", **opts), ref_runtime(
        "pallas_step", **opts)
    got, want = rt._schedule_for_graph(g), ref._schedule_for_graph(r)
    H = ps._patterns.halo_radius(g)
    assert (got.kind, got.steps_per_launch) == (want.kind, want.steps_per_launch) == ("halo", 2)
    assert rt._pipeline_active(64, 2, H, 8) and ref._pipeline_active(64, 2, H, 8)
    assert "pipelined" in got.reason and "env override" in got.reason
    assert rt.dispatches_per_run(g) == ref.dispatches_per_run(r) == 1 + 2 * 6
    out = rt.execute(g, init)
    np.testing.assert_allclose(out, np.asarray(ref.execute(r, init)), **COMPUTE_TOL)
    np.testing.assert_array_equal(out, _explicit_twin(rt, g).execute(g, init))


def test_auto_resolves_memory_bound_to_one_step():
    """The memory body has no tiled form, so on the card "auto" resolves it
    to S = 1, where the reference (its VMEM rule) blocks it deeper."""
    g, r, init = _pair("stencil_1d", "memory_bound", 3)
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch="auto")
    ref = ref_runtime("pallas_step", steps_per_launch="auto")
    got = rt._schedule_for_graph(g)
    assert (got.kind, got.steps_per_launch) == ("halo", 1)
    assert "memory body" in got.reason and "tiled form" in got.reason
    assert ref._schedule_for_graph(r).steps_per_launch > 1
    assert rt.dispatches_per_run(g) == g.steps
    out = rt.execute(g, init)
    np.testing.assert_allclose(out, np.asarray(ref.execute(r, init)), **MEMORY_TOL)
    np.testing.assert_allclose(out, get_runtime("fused", device="cpu").execute(g, init),
                               **MEMORY_TOL)
    np.testing.assert_array_equal(out, _explicit_twin(rt, g).execute(g, init))


@pytest.mark.parametrize("pattern,width,want_ref", [
    ("spread", 32, "allgather"), ("all_to_all", 32, "allgather"),
    ("fft", 1, "allgather"), ("fft", 32, "stride"), ("tree", 16, "stride")])
def test_auto_on_the_other_plans(pattern, width, want_ref):
    """The all-gather plan's K4 launch fits when it takes the resident form
    (a cluster a column slice holds the whole buffer), the card's
    counterpart of the reference's VMEM fit, so "auto" resolves the
    reference's (plan, S) there, its reason naming the rule; a butterfly
    keeps the stride plan under the analytic model, as the reference's
    does. Outputs within tolerance of the reference and of fused, and bit
    for bit their explicit twins."""
    g, r, init = _pair(pattern, width=width)
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch="auto")
    ref = ref_runtime("pallas_step", steps_per_launch="auto")
    got, want = rt._schedule_for_graph(g), ref._schedule_for_graph(r)
    assert want.kind == want_ref
    assert (got.kind, got.steps_per_launch) == (want.kind, want.steps_per_launch)
    if want_ref == "allgather":
        assert got.steps_per_launch > 1
        assert "resident form" in got.reason and "VMEM fit" in got.reason
    else:
        assert got.reason == want.reason
    assert rt.dispatches_per_run(g) == ref.dispatches_per_run(r)
    out = rt.execute(g, init)
    np.testing.assert_allclose(out, np.asarray(ref.execute(r, init)), **COMPUTE_TOL)
    fused = get_runtime("fused", device="cpu").execute(g, init)
    np.testing.assert_allclose(out, fused, **COMPUTE_TOL)
    np.testing.assert_array_equal(out, _explicit_twin(rt, g).execute(g, init))


def test_auto_on_the_all_gather_plan_keeps_the_memory_body_per_step():
    """The memory body takes only K4's cooperative form, so "auto" on the
    all-gather plan resolves it to S = 1, the reason naming the rule."""
    g, _, init = _pair("spread", "memory_bound", 3)
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch="auto")
    got = rt._schedule_for_graph(g)
    assert (got.kind, got.steps_per_launch) == ("allgather", 1)
    assert "memory body" in got.reason and "resident form" in got.reason
    assert rt.dispatches_per_run(g) == g.steps
    np.testing.assert_array_equal(rt.execute(g, init),
                                  _explicit_twin(rt, g).execute(g, init))


def test_auto_under_a_measured_card_model_runs_serial():
    """A one-device card model (X = 1) resolves every halo compute run to
    the deepest tiled depth, serial; the butterfly's ranking sees the
    all-gather plan's depth fit (K4's resident form) and re-routes as the
    reference's does under the same model."""
    model = MODELS["measured-card"]
    for pattern in HALO:
        g, _, init = _pair(pattern, width=64, steps=12)
        rt = get_runtime("pallas_step", device="cpu", steps_per_launch="auto",
                         cost_model=model)
        got = rt._schedule_for_graph(g)
        H = ps._patterns.halo_radius(g)
        assert got.steps_per_launch == 8 and not rt._pipeline_active(64, 8, H, 8), pattern
        assert "serial" in got.reason and "measured on NVIDIA" in got.reason
        assert rt.dispatches_per_run(g) == 1 + 2  # ceil(11 / 8)
        np.testing.assert_array_equal(rt.execute(g, init),
                                      _explicit_twin(rt, g).execute(g, init))
    g, r, init = _pair("fft", width=64)
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=0, cost_model=model)
    ref = ref_runtime("pallas_step", steps_per_launch=0,
                      cost_model=ref_probes.CostModel.from_dict(model))
    got, want = rt._schedule_for_graph(g), ref._schedule_for_graph(r)
    assert got[:2] == want[:2] == ("allgather", 8)
    assert got.reason == want.reason
    np.testing.assert_array_equal(rt.execute(g, init),
                                  _explicit_twin(rt, g).execute(g, init))


def test_fit_rule_is_the_tiled_form():
    """The halo plan's fit rule holds a depth exactly when every K4 launch
    the runtime makes at it takes the tiled form; at the main path's shapes
    (W = 2112, payload 64) every candidate fits at radius 1 and 2."""
    from repro_torch.kernels.taskbench_step import blocked_plan

    rt = get_runtime("pallas_step", device="cpu")
    spec = KernelSpec("compute_bound", 64)
    for H in (1, 2):
        fits = rt._halo_fit(1, 2112, 64, H, 2 * H + 1, spec)
        for S in (2, 4, 8, 16):
            assert fits(S, False) and fits(S, True)
            assert blocked_plan((1, 2112 + 2 * S * H, 64), (1, 2112 + 2 * S * H, 2 * H + 1),
                                S, "window", False, H) is not None
    mem = rt._halo_fit(1, 2112, 64, 1, 3, KernelSpec("memory_bound", 4, 2048))
    assert not any(mem(S, p) for S in (2, 16) for p in (False, True))
    # a radius so deep that a tile's S*r halo rows outgrow shared memory past
    # S = 2: "auto" takes the deepest depth that still tiles
    deep = rt._halo_fit(1, 4096, 64, 64, 129, spec)
    assert deep(2, False) and not any(deep(S, False) for S in (4, 8, 16))
    g = TaskGraph(steps=1000, width=4096, pattern="nearest", payload=64, radius=64,
                  kernel=KernelSpec("compute_bound", 1))
    auto = get_runtime("pallas_step", device="cpu", steps_per_launch="auto",
                       cost_model=MODELS["measured-card"])
    assert auto._schedule_for_graph(g)[:2] == ("halo", 2)


# ---------------------------------------------------------------- ensembles


def _ens(specs):
    """Both packages' ensembles of (steps, width, pattern, kind, iters, radius)."""
    ours, refs = [], []
    for k, (t, w, p, kind, it, rad) in enumerate(specs):
        kw = dict(steps=t, width=w, pattern=p, payload=8, radius=rad, seed=k)
        ours.append(TaskGraph(kernel=KernelSpec(kind, it, 30), **kw))
        refs.append(RefGraph(kernel=RefSpec(kind, it, 30), **kw))
    inits = [np.asarray(ref_initial_state(g.width, g.payload, g.seed)) for g in refs]
    return GraphEnsemble(ours), RefEnsemble(refs), inits


ENSEMBLES = {
    "stacked": [(12, 32, "stencil_1d", "compute_bound", 1, 1),
                (9, 32, "nearest", "compute_bound", 1, 2),
                (12, 32, "random_nearest", "compute_bound", 1, 1)],
    "tuple": [(12, 32, "stencil_1d", "compute_bound", 1, 1),
              (12, 64, "nearest", "compute_bound", 4, 3),
              (7, 16, "dom", "compute_bound", 2, 1)],
}


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("kind", ENSEMBLES)
def test_auto_ensembles_take_the_most_conservative_depth(kind, pipeline):
    ens, ref_ens, inits = _ens(ENSEMBLES[kind])
    opts = dict(steps_per_launch="auto", pipeline=pipeline)
    rt, ref = get_runtime("pallas_step", device="cpu", **opts), ref_runtime(
        "pallas_step", **opts)
    assert rt._is_stacked(ens) == (kind == "stacked")
    S = rt._ensemble_steps_per_launch(ens)
    assert S == ref._ensemble_steps_per_launch(ref_ens) > 1
    assert rt.ensemble_dispatches_per_run(ens) == ref.ensemble_dispatches_per_run(ref_ens)
    outs = rt.execute_ensemble(ens, inits)
    for out, want in zip(outs, ref.execute_ensemble(ref_ens, inits)):
        np.testing.assert_allclose(out, np.asarray(want), **COMPUTE_TOL)
    twin = get_runtime("pallas_step", device="cpu", steps_per_launch=S, pipeline=pipeline)
    for out, want in zip(outs, twin.execute_ensemble(ens, inits)):
        np.testing.assert_array_equal(out, want)


def test_auto_ensemble_with_a_memory_member_runs_per_step():
    """A memory_bound member has no tiled form, so the tuple's most
    conservative depth is 1 (the reference's VMEM rule blocks it)."""
    specs = ENSEMBLES["tuple"][:2] + [(12, 32, "no_comm", "memory_bound", 3, 1)]
    ens, ref_ens, inits = _ens(specs)
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch="auto")
    assert rt._ensemble_steps_per_launch(ens) == 1
    assert ref_runtime("pallas_step", steps_per_launch="auto") \
        ._ensemble_steps_per_launch(ref_ens) > 1
    twin = get_runtime("pallas_step", device="cpu", steps_per_launch=1)
    for out, want in zip(rt.execute_ensemble(ens, inits), twin.execute_ensemble(ens, inits)):
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("name", ["analytic", "measured-card", "measured-mesh"])
@pytest.mark.parametrize("kind", ENSEMBLES)
def test_launch_plans_carry_the_reference_expected_wall(kind, name):
    """``expected_launch_us`` is the reference's under the same model: a
    number under a measured one, None under the analytic one."""
    ens, ref_ens, _ = _ens(ENSEMBLES[kind])
    model = dict(MODELS[name], payload=8) if name != "analytic" else MODELS[name]
    opts = dict(steps_per_launch="auto", cost_model=model)
    plan = get_runtime("pallas_step", device="cpu", **opts).build_ensemble_launches(ens)
    ref_plan = ref_runtime("pallas_step", **opts).build_ensemble_launches(ref_ens)
    assert (plan.kind, plan.steps_per_launch) == (ref_plan.kind, ref_plan.steps_per_launch)
    if name == "analytic":
        assert plan.expected_launch_us is None and ref_plan.expected_launch_us is None
    else:
        assert plan.expected_launch_us == pytest.approx(ref_plan.expected_launch_us,
                                                        rel=1e-12)
        det = DeadlineDetector(expected_us=plan.expected_launch_us)
        assert det.source == "measured"
        assert det.deadline_us() == max(schedule.DEADLINE_FACTOR * plan.expected_launch_us,
                                        det.min_deadline_us)


def test_analytic_fallback_is_the_suite_default():
    """The suite's pin (``REPRO_COST_MODEL=off`` in tests/conftest.py)
    keeps "auto" on the analytic model here."""
    m = get_runtime("pallas_step", device="cpu", steps_per_launch="auto")._cost_model(8)
    assert m.source == "analytic" and dataclasses.asdict(m) == dataclasses.asdict(
        probes.analytic_cost_model())


# ------------------------------------------- the gather choosers and probes

#: Models with the devices-dimension gather probes: at D = 4 (one grouping,
#: so no grouping rows), at D = 8 (groupings 2 and 4; chunked ahead), and a
#: D = 8 table with one grouping row only (too few to rank) where xla leads.
SHARD_MODELS = {
    "d4": dict(MODELS["measured-mesh"], gather_impl_us={
        "xla": {"4": {"64": 12.0, "512": 30.0}, "2": {"64": 8.0, "512": 9.0}},
        "chunked": {"4": {"64": 14.0, "512": 22.0}}}),
    "d8": dict(MODELS["measured-mesh"], devices=8, gather_impl_us={
        "xla": {"8": {"64": 40.0, "256": 44.0, "512": 60.0}},
        "chunked": {"8": {"64": 35.0, "256": 41.0, "512": 45.0}},
        "chunked:g2": {"8": {"64": 36.0, "512": 50.0}},
        "chunked:g4": {"8": {"64": 33.0, "512": 52.0}}}),
    "d8-one-group": dict(MODELS["measured-mesh"], devices=8, gather_impl_us={
        "xla": {"8": {"64": 20.0, "512": 25.0}},
        "chunked": {"8": {"64": 30.0, "512": 35.0}},
        "chunked:g4": {"8": {"64": 10.0, "512": 10.0}}}),
}
CHOOSER_MODELS = ["analytic", "measured-mesh", *SHARD_MODELS]


def _shard_models(name):
    d = SHARD_MODELS.get(name) or MODELS[name]
    return probes.CostModel.from_dict(d), ref_probes.CostModel.from_dict(d)


def _same_outcome(ours, theirs):
    """Both calls' results, or both calls' ValueErrors with one message."""
    try:
        want = theirs()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ours()
        assert str(got.value) == str(e)
        return None
    assert ours() == want
    return want


@pytest.mark.parametrize("name", CHOOSER_MODELS)
def test_choose_gather_impl_equals_the_reference(name):
    """Transport and reason alike over device counts and widths: the
    measured walls at exactly (D, W) (grouping rows left out), else the
    structural rule."""
    ours, ref = _shard_models(name)
    seen = set()
    for D in (1, 2, 3, 4, 8, 16, 32):
        for W in (32, 64, 100, 256, 512, 1024):
            got = schedule.choose_gather_impl(width=W, devices=D, model=ours)
            assert got == ref_schedule.choose_gather_impl(width=W, devices=D, model=ref)
            seen.add(got[0])
    assert seen == ({"xla", "chunked"})
    assert schedule.DEFAULT_CHUNKED_GATHER_MIN_DEVICES == \
        ref_schedule.DEFAULT_CHUNKED_GATHER_MIN_DEVICES


@pytest.mark.parametrize("name", CHOOSER_MODELS)
def test_choose_gather_chunk_group_equals_the_reference(name, monkeypatch):
    """Group and reason alike: explicit > env > measured grouping walls (two
    candidates at least) > the divisor nearest sqrt(D); a G that does not
    divide D, or is no integer, refused with the reference's message at the
    explicit and the env tier; a blank env ignored."""
    ours, ref = _shard_models(name)
    env = schedule._GATHER_CHUNK_GROUP_ENV
    assert env == ref_schedule._GATHER_CHUNK_GROUP_ENV
    measured = []
    for raw in (None, "4", " 2 ", "3", "x", "  "):
        if raw is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, raw)
        for D in (1, 2, 4, 6, 8, 9, 16, 32):
            for W in (None, 64, 512):
                for explicit in (None, 2, 3, 4, "8", "y"):
                    kw = dict(devices=D, width=W, explicit=explicit)
                    got = _same_outcome(
                        lambda: schedule.choose_gather_chunk_group(model=ours, **kw),
                        lambda: ref_schedule.choose_gather_chunk_group(model=ref, **kw))
                    if got and got[1].startswith("measured"):
                        measured.append((D, W, got[0]))
    if name == "d8":
        assert (8, 64, 4) in measured and (8, 512, 2) in measured
    else:
        assert not measured


@pytest.mark.parametrize("name", CHOOSER_MODELS)
def test_choose_member_shards_equals_the_reference(name):
    """Dk and reason alike over (D, K, W, S, r): the common divisors of D
    and K that keep a row ring and divide W, priced under a measured model
    by hops x the cheapest exchange + (K/Dk) x 2*S*r row-steps; Dk = 1
    under the analytic model."""
    ours, ref = _shard_models(name)
    seen = set()
    for D in (1, 2, 4, 8):
        for K in (1, 2, 3, 4, 8):
            for W in (16, 24, 2112):
                for S in (1, 3, 16):
                    for r in (0, 1, 2):
                        kw = dict(devices=D, num_members=K, width=W, steps_per_launch=S,
                                  radius=r)
                        got = schedule.choose_member_shards(model=ours, **kw)
                        assert got == ref_schedule.choose_member_shards(model=ref, **kw), kw
                        seen.add(got[0])
    assert seen == ({1} if name == "analytic" else {1, 2, 4})


@pytest.mark.parametrize("name", CHOOSER_MODELS)
def test_gather_walls_and_the_codec_cross_both_packages(name):
    ours, ref = _shard_models(name)
    assert ours.to_dict() == ref.to_dict()
    assert ref_probes.CostModel.from_dict(ours.to_dict()) == ref
    for D in (None, 2, 4, 8, 16):
        for W in (16, 64, 100, 512, 4096):
            assert ours.gather_walls_at(W, D) == pytest.approx(
                ref.gather_walls_at(W, D), rel=1e-12)
    if name == "d8":
        assert sorted(ours.gather_walls_at(256)) == ["chunked", "chunked:g2", "chunked:g4",
                                                    "xla"]
        assert ours.gather_walls_at(256, 4) == {}


def test_probe_grids_equal_the_reference():
    for D in range(1, 33):
        assert probes._gather_probe_device_counts(D) == ref_probes._gather_probe_device_counts(D)
        assert probes._chunk_group_candidates(D) == ref_probes._chunk_group_candidates(D)


@pytest.mark.parametrize("D", [4, 8])
def test_run_probes_across_shards_fills_the_transport_tables(D, tmp_path):
    """``run_probes(devices=D)`` on the plain path times the stride
    exchange per transport, the gather per width and the gather per
    (transport, D, width), the grouping rows where D has two groupings;
    the choosers then read measured walls."""
    m = probes.run_probes(devices=D, payload=8, device="cpu", smoke=True)
    assert sorted(m.stride_exchange_us) == ["ppermute", "xla"]
    assert sorted(m.gather_us) == list(probes.GATHER_WIDTHS)
    groups = [f"chunked:g{g}" for g in probes._chunk_group_candidates(D)] if D == 8 else []
    assert sorted(m.gather_impl_us) == sorted(["chunked", "xla", *groups])
    assert all(sorted(by_d) == [D] and sorted(by_d[D]) == list(probes.GATHER_WIDTHS)
               for by_d in m.gather_impl_us.values())
    assert all(v > 0 for v in list(m.stride_exchange_us.values()) + list(m.gather_us.values()))
    assert schedule.choose_gather_impl(width=64, devices=D, model=m)[1].startswith(
        "measured gather walls")
    g, why = schedule.choose_gather_chunk_group(devices=D, width=64, model=m)
    assert why.startswith("measured" if D == 8 else "analytic") and D % g == 0
    assert m.can_rank_plans and m.stride_us_for("xla") == m.stride_exchange_us["xla"]
    path = probes.save_cost_model(m, tmp_path / "cm.json")
    assert probes.load_cost_model(path)[f"cpu|d{D}|p8"] == m
    # the reference's contract: nothing at D = 1 or a D not a power of two
    assert probes.probe_stride_exchange_us(1) == probes.probe_stride_exchange_us(
        3, device="cpu") == {}
    assert probes.probe_gather_us(4, 8, widths=(6, 64), reps=1, device="cpu",
                                  nodes=1).keys() == {64}


def test_probes_cli_calibrates_shards(tmp_path, capsys):
    out = tmp_path / "cm.json"
    assert probes.main(["--smoke", "--device", "cpu", "--devices", "4", "--payload", "8",
                        "--out", str(out)]) == 0
    assert "cpu|d4|p8" in capsys.readouterr().out
    (entry,) = probes.load_cost_model(out).values()
    assert entry.devices == 4 and entry.gather_impl_us and entry.stride_exchange_us


#: "auto" on a butterfly at D = 4 under a measured model: the reference
#: re-routes to the blocked all-gather plan where ``gathered_beats_strides``
#: says so ("reroute": cheap launches, cheap replication), and keeps the
#: stride plan where replication costs more than the strides ("keep").
AUTO_MODELS = {
    "keep": dict(MODELS["measured-mesh"], row_step_us=5.0, stride_exchange_us={
        "xla": 4.0, "ppermute": 3.0}),
    "reroute": dict(MODELS["measured-mesh"], stride_exchange_us={"xla": 400.0}),
}
AUTO_CASES = [dict(key=f"auto-{p}-{m}-W{w}", runtime="pallas_step", D=4, reason=True,
                   options=dict(steps_per_launch="auto", cost_model=AUTO_MODELS[m]),
                   graph=dict(steps=12, width=w, pattern=p, payload=8, radius=2, seed=3,
                              kernel=dict(kind="compute_bound", iterations=1, scratch=30)))
              for p in ("fft", "tree") for m in AUTO_MODELS for w in (32, 64)]


@pytest.fixture(scope="module")
def ref_auto(tmp_path_factory):
    from test_torch_shards_rungs import run_reference

    return run_reference(AUTO_CASES, 4, tmp_path_factory.mktemp("ref_auto"))


@pytest.mark.parametrize("case", AUTO_CASES, ids=[c["key"] for c in AUTO_CASES])
def test_auto_on_a_butterfly_across_shards(case, ref_auto):
    """At D = 4 the port's "auto" sees the measured stride and gather walls
    through `gathered_beats_strides`, whose verdict on the shards' shape
    (B = W / 4, the off-block strides) equals the reference's on the same
    model. The port resolves the reference's (plan, S) either way: where
    the reference keeps the stride plan, and where it re-routes to the
    blocked all-gather plan, whose K4 launch fits when it takes the
    resident form (planned for a quarter of the card, the four shards'
    grids running at once). Either way the run is within tolerance of the
    reference's and bit for bit its explicit twin."""
    arrays, meta = ref_auto
    key = case["key"]
    g = TaskGraph(kernel=KernelSpec("compute_bound", 1, 30),
                  **{k: v for k, v in case["graph"].items() if k != "kernel"})
    rt = get_runtime("pallas_step", devices=["cpu"] * 4, **case["options"])
    got = rt._schedule_for_graph(g)
    want_kind, want_S, _ = meta[key]["plan"]
    model = probes.CostModel.from_dict(case["options"]["cost_model"])
    strides = ps._patterns.butterfly_slot_strides(g)
    B = g.width // 4
    kw = dict(width=g.width, block=B, steps_per_launch=max(want_S, 8), period=len(strides),
              off_block_strides=sum(1 for s in strides if s >= B), impl="xla")
    verdict = schedule.gathered_beats_strides(model=model, **kw)
    assert verdict == ref_schedule.gathered_beats_strides(
        model=ref_probes.CostModel.from_dict(model.to_dict()), **kw)
    if "keep" in key:
        assert (got.kind, got.steps_per_launch) == (want_kind, want_S) == ("stride", 1)
        assert not verdict[0]
    else:
        assert want_kind == "allgather" and want_S == 8 and verdict[0]
        assert (got.kind, got.steps_per_launch) == ("allgather", 8)
        assert got.reason == verdict[1]
    S = got.steps_per_launch
    assert rt.dispatches_per_run(g) == (g.steps if S == 1 else 1 + -(-(g.steps - 1) // S))
    init = arrays[f"{key}/init"]
    out = rt.execute(g, init)
    np.testing.assert_allclose(out, arrays[f"{key}/out"], **COMPUTE_TOL)
    twin = get_runtime("pallas_step", devices=["cpu"] * 4, steps_per_launch=S)
    assert twin._schedule_for_graph(g)[:2] == got[:2]
    np.testing.assert_array_equal(out, twin.execute(g, init))
