"""The METG regression guard (``benchmarks/torch_floor_guard.py``) on
synthetic `torch_metg` records: a run within the bounds holds; a median past its
bound, a missing cell, a malformed record, an unreached median and a run on
another card each fail rather than pass. The committed baseline is a
readable `torch_metg` output that holds against itself.
"""
import copy
import json

import pytest

from benchmarks import torch_floor_guard as guard

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _rec(runtime, W, median, pattern="stencil_1d", **kw):
    rec = {"kind": "metg", "runtime": runtime, "W": W, "pattern": pattern,
           "metg_us_median": median, "card": CARD, "steps": 1000, "payload": 64,
           "grains": [1, 4], "reps": 5, "repeats": 5}
    rec.update(kw)
    return rec


BASE = [_rec("fused[kernels]", 132, 25.0), _rec("pallas_step", 132, 4.0),
        _rec("pallas_step[S=8,serial]", 2112, 0.175), _rec("pallas_step", 2048, 0.5, "fft"),
        {"kind": "floor", "pattern": "fft", "W": 128}, {"kind": "summary", "card": CARD}]


def _run(**medians):
    run = copy.deepcopy(BASE)
    for rec in run:
        key = f"{rec.get('runtime')}@{rec.get('W')}"
        if key in medians:
            rec["metg_us_median"] = medians[key]
    return run


def test_a_run_within_the_bounds_holds():
    # +14% on fused (bound 15%), +9% on pallas_step (bound 10%), and faster
    ok, lines = guard.check(_run(**{"fused[kernels]@132": 28.5, "pallas_step@132": 4.36,
                                    "pallas_step@2048": 0.3}), BASE)
    assert ok, lines
    assert sum(line.startswith("ok") for line in lines) == 4


@pytest.mark.parametrize("cell,median", [("pallas_step@132", 4.41),
                                         ("pallas_step[S=8,serial]@2112", 0.2),
                                         ("fused[kernels]@132", 28.8),
                                         ("pallas_step@2048", 0.56)])
def test_a_median_past_its_bound_fails(cell, median):
    ok, lines = guard.check(_run(**{cell: median}), BASE)
    assert not ok
    assert sum(line.startswith("FAIL") for line in lines) == 1


def test_a_missing_or_malformed_or_unreached_cell_fails():
    run = _run()
    del run[2]
    assert not guard.check(run, BASE)[0]
    for bad in (None, "0.2", -1.0, 0.0, float("nan"), True):
        ok, lines = guard.check(_run(**{"pallas_step@132": bad}), BASE)
        assert not ok, bad
    run = _run()
    del run[1]["metg_us_median"]
    assert not guard.check(run, BASE)[0]
    run = _run()
    del run[0]["W"]
    assert not guard.check(run, BASE)[0]
    run = _run()
    run.append(dict(run[0]))  # a duplicate cell
    assert not guard.check(run, BASE)[0]
    assert not guard.check(_run(), [])[0]  # an empty baseline guards nothing


def test_another_card_or_protocol_fails():
    run = _run()
    run[0]["card"] = "NVIDIA H100 80GB HBM3, 500.00 W"
    assert not guard.check(run, BASE)[0]
    run = _run()
    for rec in run:
        if rec["kind"] == "metg":
            rec["steps"] = 100
    assert not guard.check(run, BASE)[0]


def test_an_unreached_baseline_cell_is_not_guarded():
    base = copy.deepcopy(BASE)
    base[0]["metg_us_median"] = None
    ok, lines = guard.check(_run(**{"fused[kernels]@132": 99.0}), base)
    assert ok and any(line.startswith("skip") for line in lines)


def test_cells_are_keyed_by_ensemble_size_and_new_cells_do_not_fail():
    """An ensemble record (K > 1) is its own cell: one the baseline lacks is
    listed as new and does not fail the guard; one the baseline holds is
    guarded like any other; a record without K is K = 1."""
    ens = [_rec("pallas_step", 132, 1.0, K=k) for k in (2, 8)]
    ok, lines = guard.check(_run() + ens, BASE)
    assert ok, lines
    new = [line for line in lines if line.startswith("new")]
    assert len(new) == 2 and all("K=" in line for line in new)
    assert ("stencil_1d", "pallas_step", 132, 1) in guard.metg_cells(BASE)
    base = BASE + [_rec("pallas_step", 132, 1.0, K=2)]
    run = _run() + [_rec("pallas_step", 132, 1.2, K=2)]
    assert not guard.check(run, base)[0]
    assert guard.check(_run() + [_rec("pallas_step", 132, 1.05, K=2)], base)[0]
    assert not guard.check(_run(), base)[0]  # the K = 2 cell is missing


def test_bounds_by_schedule_family():
    assert guard.bound_for("pallas_step[S=8]") == guard.bound_for("pallas_step") == 0.10
    assert guard.bound_for("fused[kernels]") == 0.15
    with pytest.raises(ValueError):
        guard.bound_for("bsp")


def test_the_cli_exit_codes(tmp_path, capsys):
    base, run = tmp_path / "base.json", tmp_path / "run.json"
    base.write_text("\n".join(json.dumps(r) for r in BASE) + "\n")
    run.write_text("\n".join(json.dumps(r) for r in _run()) + "\n")
    assert guard.main([str(run), "--baseline", str(base)]) == 0
    run.write_text("\n".join(json.dumps(r) for r in _run(**{"pallas_step@132": 9.0})))
    assert guard.main([str(run), "--baseline", str(base)]) == 1
    run.write_text("{not json\n")
    assert guard.main([str(run), "--baseline", str(base)]) == 1
    assert guard.main([str(tmp_path / "absent.json"), "--baseline", str(base)]) == 1
    assert "FAILED" in capsys.readouterr().out


def test_the_committed_baseline_holds_against_itself():
    records = guard.read_records(guard.DEFAULT_BASELINE)
    cells = guard.metg_cells(records)
    assert {(p, rt) for p, rt, *_ in cells} >= {
        ("stencil_1d", "fused[kernels]"), ("stencil_1d", "pallas_step"),
        ("stencil_1d", "pallas_step[S=8]"), ("stencil_1d", "pallas_step[S=8,serial]"),
        ("fft", "fused[kernels]"), ("fft", "pallas_step")}
    assert all(r["card"].startswith("NVIDIA H100") for r in cells.values())
    ok, lines = guard.check(records, records)
    assert ok, lines
