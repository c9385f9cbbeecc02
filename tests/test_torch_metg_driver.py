"""The port's METG sweep (``benchmarks/torch_metg.py``) on the CPU: its
``--smoke`` sweep runs with ``--device cpu`` and writes one readable JSON
record per line, every schedule and width of the sweep present; its METG
medians and spreads follow from the repeats it records. The script imports
no JAX, no module of the JAX package and not ``benchmarks/common.py``
(``tests/test_torch_isolation.py``).
"""
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("metg") / "metg.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.torch_metg", "--smoke", "--device", "cpu",
         "--out", str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300, check=True)
    return proc.stdout, [json.loads(line) for line in out.read_text().splitlines()]


def test_smoke_writes_one_json_record_per_line(smoke):
    stdout, records = smoke
    assert [json.loads(line) for line in stdout.splitlines()] == records
    assert records[-1]["kind"] == "summary" and records[-1]["device"] == "cpu"
    assert all(r["card"] == "cpu" for r in records)


def test_smoke_sweeps_every_schedule_at_every_width(smoke):
    """The four schedules, ``pallas_step[auto]`` and the three rungs on the
    PAPER protocol at every width."""
    from benchmarks.torch_metg import AUTO_SCHEDULE, RUNG_SCHEDULES, SCHEDULES, SMOKE

    _, records = smoke
    metg = [r for r in records if r["kind"] == "metg" and r["pattern"] == "stencil_1d"]
    refused = [r for r in records if r["kind"] == "refused"]
    assert {(r["runtime"], r["od"]) for r in metg + refused} == {
        (label, od) for label, _, _ in SCHEDULES + (AUTO_SCHEDULE,) + RUNG_SCHEDULES
        for od in SMOKE.overdecomposition}
    # one point a row on the CPU: overlap has no interior at W = 1
    assert [(r["runtime"], r["W"]) for r in refused] == [("overlap[kernels]", 1)]
    assert refused[0]["reason"].startswith("block 1 < 2*radius 1")
    for r in metg:
        assert r["W"] == r["od"]  # one core on the CPU
        assert r["repeats"] == len(r["metg_us"]) == 2
        assert set(r["us_per_step_median"]) == {str(g) for g in SMOKE.grains}
        assert r["capture_s_median"] is None  # the eager loop on the CPU


def test_metg_median_and_spread_follow_from_the_repeats(smoke):
    _, records = smoke
    for r in (r for r in records if r["kind"] == "metg"):
        reached = [m for m in r["metg_us"] if m is not None]
        assert r["unreached"] == len(r["metg_us"]) - len(reached)
        if reached:
            med = statistics.median(reached)
            assert r["metg_us_median"] == pytest.approx(med)
            assert r["spread"] == pytest.approx((max(reached) - min(reached)) / med)


def test_smoke_times_the_depths_and_the_eager_loop_at_grain_1(smoke):
    _, records = smoke
    depths = [r for r in records if r["kind"] == "steps_per_launch"]
    assert {(r["od"], r["S"]) for r in depths} == {(od, S) for od in (1, 8) for S in (1, 2)}
    for r in depths:
        want = {"S=1"} if r["S"] == 1 else {"pipelined", "serial"}
        assert set(r["us_per_step"]) == want and min(r["us_per_step"].values()) > 0
    eager = [r for r in records if r["kind"] == "graph_vs_eager"]
    assert {(r["od"], r["S"], r["schedule"]) for r in eager} == {
        (od, S, sched) for od in (1, 8)
        for S, sched in ((1, "S=1"), (2, "pipelined"), (2, "serial"))}
    assert all(set(r["us_per_step"]) == {"graph", "eager"} for r in eager)


def test_smoke_times_the_butterfly_floor(smoke):
    """The floor's records: fused[kernels] against pallas_step at grain 1
    on each non-halo pattern and width, pallas_step[S=8] beside where it
    blocks the all-gather plan, each schedule's plan named."""
    from benchmarks.torch_metg import FLOOR_S, SMOKE_FLOOR

    _, records = smoke
    floor = [r for r in records if r["kind"] == "floor"]
    assert [(r["pattern"], r["W"]) for r in floor] == [
        (p, w) for p, widths in SMOKE_FLOOR for w in widths]
    blocked = f"pallas_step[S={FLOOR_S}]"
    for r in floor:
        want = {"fused[kernels]", "pallas_step", blocked}
        assert set(r["us_per_step"]) == set(r["launches_per_run"]) == want
        assert min(r["us_per_step"].values()) > 0 and r["grain"] == 1
        stride = r["pattern"] in ("fft", "tree")
        assert r["plans"]["pallas_step"] == ["stride" if stride else "allgather", 1]
        assert r["plans"][blocked] == ["allgather", 5]  # T = 6 clamps S to 5
        assert r["launches_per_run"]["pallas_step"] == r["steps"]
        assert r["launches_per_run"][blocked] == 2
        assert r["pallas_step_strictly_lower"] == (
            r["us_per_step"]["pallas_step"] < r["us_per_step"]["fused[kernels]"])


def test_smoke_sweeps_fft_metg_on_both_backends(smoke):
    from benchmarks.torch_metg import FLOOR_SCHEDULES, SMOKE_FLOOR_METG_W

    _, records = smoke
    fft = [r for r in records if r["kind"] == "metg" and r["pattern"] == "fft"]
    assert [(r["runtime"], r["W"], r["od"]) for r in fft] == [
        (label, SMOKE_FLOOR_METG_W, None) for label, _, _ in FLOOR_SCHEDULES]
    for r in fft:
        assert r["repeats"] == len(r["metg_us"]) == 2
        assert r["dispatches_per_run"] > 0


def test_smoke_sweeps_serialized_with_its_cuts(smoke):
    """serialized[kernels]: one record per od, its own protocol (T, reps,
    sweeps) written in ``cuts``, under a kind the guard does not read; one
    host call a task."""
    from benchmarks.torch_metg import SERIALIZED_REPS, SMOKE

    _, records = smoke
    cut = [r for r in records if r["kind"] == "metg_cut"]
    assert [(r["runtime"], r["od"]) for r in cut] == [("serialized[kernels]", 1),
                                                      ("serialized[kernels]", 8)]
    for r in cut:
        assert r["steps"] == SMOKE.steps and r["reps"] == SERIALIZED_REPS
        assert r["cuts"]["steps"] == [SMOKE.steps, SMOKE.steps]
        assert r["cuts"]["reps"] == [SERIALIZED_REPS, SMOKE.reps]
        assert r["cuts"]["repeats"] == [2, 2] == [r["repeats"], len(r["metg_us"])]
        assert r["host_calls_per_run"] == r["W"] * r["steps"]
        assert r["us_per_task_median"] == {g: us / r["W"]
                                           for g, us in r["us_per_step_median"].items()}
        assert isinstance(r["metg_within_sweep"], bool)
    rungs = [r for r in records if r["kind"] == "metg" and r["runtime"].startswith("bsp[")]
    assert [r["host_calls_per_run"] for r in rungs] == [r["steps"] for r in rungs]


def test_smoke_sweeps_the_ensemble_rows(smoke):
    """The ensemble rows: K graphs a point through ``measure_ensemble``, one
    record per (schedule, od, K), each with K and the card; granularity
    counts every member's tasks."""
    from benchmarks.torch_metg import ENSEMBLE_SCHEDULES, SMOKE

    _, records = smoke
    ens = [r for r in records if r["kind"] == "metg" and r.get("K", 1) > 1]
    assert [(r["runtime"], r["od"], r["K"]) for r in ens] == [
        (label, 1, k) for k in SMOKE.ensemble_sizes if k > 1
        for label, _, _ in ENSEMBLE_SCHEDULES]
    for r in ens:
        assert r["repeats"] == len(r["metg_us"]) == 2 and r["card"] == "cpu"
        assert r["dispatches_per_run"] > 0
    single = [r for r in records if r["kind"] == "metg" and r["pattern"] == "stencil_1d"
              and r["K"] == 1]
    # the four schedules, pallas_step[auto] and the three rungs (but overlap
    # at W = 1)
    assert len(single) == 2 * (4 + 1 + 3) - 1
    assert records[-1]["ensembles"] == [2]


def test_smoke_calibrates_and_times_auto(smoke):
    """The first record is the cost model "auto" runs under (``run_probes``
    on the run's device); ``pallas_step[auto]``'s METG runs under it, and
    the ``Sauto`` row at each width names the depth and schedule it
    resolved to, its reason and the model. Measured on one device, X = 1:
    serial, at the deepest depth under T - 1 = 5 that fits."""
    from benchmarks.torch_metg import SMOKE

    _, records = smoke
    model = records[0]
    assert model["kind"] == "cost_model" and model["source"] == "run_probes"
    assert model["model"]["source"] == "measured" and model["model"]["platform"] == "cpu"
    assert model["model"]["exchange_row_steps"] == 1.0
    assert model["describe"].startswith("measured on cpu x1")
    auto = [r for r in records if r["kind"] == "metg" and r["runtime"] == "pallas_step[auto]"]
    assert all(r["options"] == {"steps_per_launch": "auto", "cost_model": model["model"]}
               for r in auto)
    rows = [r for r in records if r["kind"] == "steps_per_launch_auto"]
    assert [r["od"] for r in rows] == list(SMOKE.overdecomposition)
    for r in rows:
        assert (r["S"], r["resolved_S"], r["pipelined"]) == ("auto", 4, False)
        assert r["reason"].startswith("auto -> S=4") and r["cost_model"] == model["describe"]
        assert r["us_per_step"]["auto"] > 0 and r["launches_per_run"]["auto"] == 1 + 2


def test_cost_model_option_reads_a_cache(tmp_path):
    """``--cost-model PATH`` takes the model from a cache file in place of
    calibrating: its entry for this platform, one device, the payload."""
    from benchmarks.torch_metg import SMOKE, calibrate
    from repro_torch.kernels import probes

    m = probes.CostModel(source="measured", exchange_row_steps=1.0, launch_us=2.0,
                         row_step_us=1e-4, halo_exchange_us={"self": 0.0},
                         platform="cpu", devices=1, payload=SMOKE.payload)
    path = probes.save_cost_model(m, tmp_path / "cm.json")
    got, rec = calibrate(SMOKE, torch.device("cpu"), path, smoke=True)
    assert got == m and rec["source"] == str(path) and rec["model"] == m.to_dict()


@pytest.fixture(scope="module")
def shard_smoke(tmp_path_factory):
    """The records of one ``--smoke --device cpu --devices 4`` run."""
    out = tmp_path_factory.mktemp("shards") / "metg_d4.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    subprocess.run(
        [sys.executable, "-m", "benchmarks.torch_metg", "--smoke", "--device", "cpu",
         "--devices", "4", "--out", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300, check=True)
    return [json.loads(line) for line in out.read_text().splitlines()]


def test_smoke_sweeps_the_row_shard_rows(shard_smoke):
    """``--devices 4``: each shard schedule at D = 1 and over 4 shards
    (labels suffixed ``[D=4]``, keys the guard never meets among its
    cells), and the overlap gain per D and grain: the medians' gain, its
    range over the sweeps (which holds it) and how far on's wall lies under
    off's."""
    records = shard_smoke
    metg = [r for r in records if r["kind"] == "metg" and r["pattern"] == "stencil_1d"]
    from benchmarks.torch_metg import SHARD_SCHEDULES

    want = {label for label, _, _ in SHARD_SCHEDULES}
    assert {r["runtime"] for r in metg if r["devices"] == 1} == want
    assert {r["runtime"] for r in metg if r["devices"] == 4} == {f"{w}[D=4]" for w in want}
    assert all(r["W"] == 8 and r["repeats"] == 2 for r in metg)
    gains = {r["devices"]: r for r in records if r["kind"] == "overlap_gain"}
    assert sorted(gains) == [1, 4]
    for r in gains.values():
        assert sorted(r["gain"]) == ["1", "16"]
        for g, v in r["gain"].items():
            assert v == pytest.approx(r["us_per_step_no_overlap"][g] / r["us_per_step_overlap"][g] - 1)
            lo, hi = r["gain_range"][g]
            assert lo <= v <= hi
            assert r["under"][g] == pytest.approx(v / (1 + v))
    assert records[-1]["kind"] == "summary" and records[-1]["devices"] == 4


def test_smoke_sweeps_the_stride_plan_over_shards(shard_smoke):
    """``--devices 4`` also sweeps ``pallas_step`` S = 1 on fft (the stride
    plan: at W = 16 over 4 shards the strides from 4 on are block
    exchanges) at D = 1 and over 4 shards, the same sweeps as the other
    shard rows, each launching T K3 a shard."""
    from benchmarks.torch_metg import SHARD_PLAN_SCHEDULES, SMOKE_FLOOR_METG_W

    fft = [r for r in shard_smoke if r["kind"] == "metg" and r["pattern"] == "fft"]
    assert [(r["runtime"], r["devices"]) for r in fft] == [
        (label if D == 1 else f"{label}[D=4]", D)
        for label, _, _, _ in SHARD_PLAN_SCHEDULES for D in (1, 4)]
    for r in fft:
        assert r["W"] == SMOKE_FLOOR_METG_W and r["od"] is None and r["repeats"] == 2
        assert r["dispatches_per_run"] == r["steps"] and r["options"] == {}
        assert sorted(r["us_per_step_median"]) == ["1", "16"]
