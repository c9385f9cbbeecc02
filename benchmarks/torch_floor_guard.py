"""Regression guard over the port's METG sweep: each (pattern, schedule, W,
K) median METG(50%) of a run held to the committed baseline.

    PYTHONPATH=src python -m benchmarks.torch_floor_guard RUN.json \
        [--baseline artifacts/bench_torch/metg_baseline.json]

Both files are ``benchmarks/torch_metg.py``'s output, one JSON record per
line. For every ``"kind": "metg"`` record of the baseline, the run must hold
a record of the same pattern, schedule, W and ensemble size K (a record
without K is a single graph, K = 1) whose median is a positive
number no more than the baseline's median times (1 + bound): +10% for the
``pallas_step`` schedules, +15% for ``fused`` (PERF.md §2's bounds, about
three times the largest move of a median between two runs on one card).
A cell missing from the
run, a malformed record, a median that went unreached, or a run on another
card or preset fails the guard rather than passing it; a cell whose
baseline median is unreached is not guarded and is listed as such. A cell
of the run that the baseline lacks (e.g. the ensemble rows, K > 1) is
listed as new, not guarded and not a failure. Exits 0 when every guarded
cell holds, 1 otherwise, and prints one line per cell.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_BASELINE = ROOT / "artifacts" / "bench_torch" / "metg_baseline.json"
#: allowed rise of a median over the baseline's, by schedule family
BOUNDS = {"pallas_step": 0.10, "fused": 0.15}

Key = Tuple[str, str, int, int]


def bound_for(runtime: str) -> float:
    """The allowed rise for a schedule label ("pallas_step[S=8]" is a
    pallas_step schedule)."""
    family = runtime.split("[", 1)[0]
    if family not in BOUNDS:
        raise ValueError(f"no regression bound for schedule {runtime!r}")
    return BOUNDS[family]


def read_records(path: Path) -> List[dict]:
    """The JSON records of a `torch_metg` output, one a line (blank lines
    skipped); a line that is not a JSON object raises ValueError."""
    records = []
    for n, line in enumerate(path.read_text().splitlines(), 1):
        if not line.strip():
            continue
        rec = json.loads(line)
        if not isinstance(rec, dict):
            raise ValueError(f"{path}:{n}: not a JSON object")
        records.append(rec)
    return records


def _key(rec: dict) -> Key:
    return (str(rec["pattern"]), str(rec["runtime"]), int(rec["W"]), int(rec.get("K", 1)))


def _tag(key: Key) -> str:
    pattern, runtime, width, k = key
    return f"{pattern} {runtime} W={width}" + (f" K={k}" if k != 1 else "")


def _median(rec: dict) -> Optional[float]:
    """A record's median, None where it went unreached; raises ValueError on
    anything else that is not a positive finite number."""
    m = rec["metg_us_median"]
    if m is None:
        return None
    if isinstance(m, bool) or not isinstance(m, (int, float)) or not math.isfinite(m) \
            or m <= 0:
        raise ValueError(f"median {m!r} is not a positive number")
    return float(m)


def metg_cells(records: List[dict]) -> Dict[Key, dict]:
    """The ``metg`` records by (pattern, schedule, W, K); a duplicate cell or
    a record without those fields raises ValueError."""
    cells: Dict[Key, dict] = {}
    for rec in records:
        if rec.get("kind") != "metg":
            continue
        try:
            key = _key(rec)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed metg record {rec!r}: {e}") from None
        if key in cells:
            raise ValueError(f"two records for {key}")
        cells[key] = rec
    return cells


def _context(records: List[dict]) -> Tuple[set, set]:
    """The cards and the (steps, payload, grains, reps, repeats) protocols
    the metg records name."""
    metg = [r for r in records if r.get("kind") == "metg"]
    cards = {r.get("card") for r in metg}
    protocols = {(r.get("steps"), r.get("payload"), tuple(r.get("grains") or ()),
                  r.get("reps"), r.get("repeats")) for r in metg}
    return cards, protocols


def check(run: List[dict], baseline: List[dict]) -> Tuple[bool, List[str]]:
    """(every guarded cell holds, one line per cell and per failure)."""
    lines: List[str] = []
    ok = True
    base = metg_cells(baseline)
    if not base:
        return False, ["FAIL the baseline holds no metg record"]
    try:
        got = metg_cells(run)
    except ValueError as e:
        return False, [f"FAIL {e}"]
    for what, b, r in zip(("card", "protocol"), _context(baseline), _context(run)):
        if r and not r <= b:
            ok = False
            lines.append(f"FAIL the run's {what} {sorted(map(str, r))} is not the "
                         f"baseline's {sorted(map(str, b))}")
    for key in sorted(base):
        runtime, tag = key[1], _tag(key)
        try:
            want = _median(base[key])
            bound = bound_for(runtime)
        except (KeyError, ValueError) as e:
            ok = False
            lines.append(f"FAIL {tag}: baseline record malformed: {e}")
            continue
        if want is None:
            lines.append(f"skip {tag}: the baseline's median is unreached")
            continue
        if key not in got:
            ok = False
            lines.append(f"FAIL {tag}: missing from the run")
            continue
        try:
            have = _median(got[key])
        except (KeyError, ValueError) as e:
            ok = False
            lines.append(f"FAIL {tag}: run record malformed: {e}")
            continue
        limit = want * (1 + bound)
        if have is None:
            ok = False
            lines.append(f"FAIL {tag}: unreached, baseline {want:.6g} us")
            continue
        rise = have / want - 1
        held = have <= limit
        ok &= held
        lines.append(f"{'ok  ' if held else 'FAIL'} {tag}: {have:.6g} us against "
                     f"{want:.6g} ({rise:+.2%}, limit +{bound:.0%})")
    for key in sorted(set(got) - set(base)):
        lines.append(f"new  {_tag(key)}: median {got[key].get('metg_us_median')!r} us, "
                     f"not in the baseline")
    return ok, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", type=Path, help="the torch_metg output to check")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE)
    args = ap.parse_args(argv)
    try:
        ok, lines = check(read_records(args.run), read_records(args.baseline))
    except (OSError, ValueError) as e:
        ok, lines = False, [f"FAIL {e}"]
    for line in lines:
        print(line)
    print(f"torch_floor_guard: {'held' if ok else 'FAILED'} against {args.baseline}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
