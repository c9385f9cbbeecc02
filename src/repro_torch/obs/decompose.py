"""Per-category wall attribution + the overlap verdict, from span evidence.

Attribution contract
--------------------
``category_walls`` unions each category's span intervals (nested or
overlapping spans of one category never double-count) over the real
(non-probe) spans. ``idle`` is derived: the run's extent minus the union
of ALL attributed intervals.

Counterpart of ``repro.obs.decompose``, a copy: both packages' spans
decompose alike.

Composite ``launch`` spans (pipelined pallas_step: boundary + exchange +
interior issued as one unit, the phases running concurrently, so no host
boundary exists between them) are *apportioned* using probe spans — separately measured
amortized per-launch phase costs carried in span attrs::

    attrs = {"probe": True, "phase": "exchange", "per_launch_us": E, ...}

Given phase costs Bd (boundary), E (exchange), I (interior) and a
combined launch wall C, the split charges the phases in data-dependence
order and the *visible* remainder to exchange::

    b       = min(Bd, C)
    i       = min(I,  C - b)
    visible = clamp(C - b - i, 0, E)      # exchange wall NOT hidden
    hidden  = E - visible                  # exchange that rode under compute
    other   = C - b - i - visible          # host/dispatch slack, if any

The **overlap verdict** aggregates hidden/E over the launches: the
fraction of the total exchange wall that was actually hidden under
compute — the paper's latency-hiding question, answered from measured
intervals rather than a pipe/nopipe wall ratio. The launch stays one unit
because phases timed one by one would serialize and destroy the overlap
being measured.

Probe spans are EXCLUDED from interval attribution — they record the
probe measurement's own wall, which is setup, not run.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.tracer import CAT_DECISION, CAT_LAUNCH, CATEGORIES, Span

#: decomposition summary schema (rides inside benchmark rows/artifacts)
DECOMPOSE_SCHEMA_VERSION = 1


def _is_probe(s: Span) -> bool:
    return bool(s.attrs.get("probe"))


def merged_intervals(
    intervals: Iterable[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Sorted, overlap-merged copy of ``intervals``."""
    ivs = sorted((a, b) for a, b in intervals if b > a)
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in merged_intervals(intervals))


def probe_costs(spans: Sequence[Span]) -> Dict[str, float]:
    """phase -> amortized per-launch microseconds, from probe spans."""
    out: Dict[str, float] = {}
    for s in spans:
        if _is_probe(s) and "phase" in s.attrs and "per_launch_us" in s.attrs:
            out[str(s.attrs["phase"])] = float(s.attrs["per_launch_us"])
    return out


def _split_launch(c_us: float, costs: Dict[str, float]) -> Dict[str, float]:
    """Apportion one combined launch wall using the probe costs."""
    bd = costs.get("boundary", 0.0)
    ex = costs.get("exchange", 0.0)
    it = costs.get("interior", 0.0)
    b = min(bd, c_us)
    i = min(it, c_us - b)
    visible = min(max(c_us - b - i, 0.0), ex)
    other = max(c_us - b - i - visible, 0.0)
    return {
        "compute.boundary": b,
        "compute.interior": i,
        "exchange": visible,
        "dispatch": other,
        "hidden_exchange": max(ex - visible, 0.0),
    }


def category_walls(spans: Sequence[Span]) -> Dict[str, float]:
    """Per-category attributed wall (us). Direct categories are interval
    unions; composite launch spans contribute their probe-cost split (a
    launch's phases never overlap another launch, so summing is exact);
    ``idle`` is the run extent minus everything attributed."""
    walls = {c: 0.0 for c in CATEGORIES}
    by_cat: Dict[str, List[Tuple[float, float]]] = {}
    all_ivs: List[Tuple[float, float]] = []
    costs = probe_costs(spans)
    for s in spans:
        if _is_probe(s) or s.category == CAT_DECISION:
            continue
        if s.category == CAT_LAUNCH:
            split = _split_launch(s.duration_us, costs)
            for cat in ("compute.boundary", "compute.interior",
                        "exchange", "dispatch"):
                walls[cat] += split[cat]
            all_ivs.append((s.start_us, s.end_us))
            continue
        by_cat.setdefault(s.category, []).append((s.start_us, s.end_us))
        all_ivs.append((s.start_us, s.end_us))
    for cat, ivs in by_cat.items():
        walls[cat] = walls.get(cat, 0.0) + union_us(ivs)
    extent = wall_extent_us(spans)
    walls["idle"] = walls.get("idle", 0.0) + max(
        extent - union_us(all_ivs), 0.0)
    return walls


def wall_extent_us(spans: Sequence[Span]) -> float:
    """Run extent: earliest start to latest end over real (non-probe,
    non-decision) spans."""
    real = [s for s in spans
            if not _is_probe(s) and s.category != CAT_DECISION]
    if not real:
        return 0.0
    return max(s.end_us for s in real) - min(s.start_us for s in real)


def overlap_verdict(spans: Sequence[Span]) -> Optional[Dict]:
    """How much exchange wall was hidden under compute, from the composite
    launch spans + phase probes. None when the trace has no launch spans
    (nothing was pipelined); a dict with ``verdict: "unavailable"`` when
    launches exist but the probes are missing."""
    launches = [s for s in spans if s.category == CAT_LAUNCH
                and not _is_probe(s)]
    if not launches:
        return None
    costs = probe_costs(spans)
    ex = costs.get("exchange")
    if not ex or ex <= 0.0:
        return {"verdict": "unavailable",
                "reason": "no exchange probe span recorded",
                "launches": len(launches)}
    hidden = 0.0
    visible = 0.0
    for s in launches:
        split = _split_launch(s.duration_us, costs)
        hidden += split["hidden_exchange"]
        visible += split["exchange"]
    total = ex * len(launches)
    frac = hidden / total if total > 0 else 0.0
    return {
        "verdict": "hidden" if frac > 0.5 else "visible",
        "launches": len(launches),
        "exchange_per_launch_us": ex,
        "boundary_per_launch_us": costs.get("boundary", 0.0),
        "interior_per_launch_us": costs.get("interior", 0.0),
        "combined_launch_us": sum(s.duration_us for s in launches),
        "exchange_total_us": total,
        "exchange_hidden_us": hidden,
        "exchange_visible_us": visible,
        "hidden_fraction": frac,
    }


def decision_records(spans: Sequence[Span]) -> List[Dict]:
    return [dict(s.attrs, name=s.name) for s in spans
            if s.category == CAT_DECISION]


def summarize(spans: Sequence[Span]) -> Dict:
    """JSON-safe decomposition of one traced run (what benchmark rows
    carry across the worker subprocess boundary)."""
    walls = category_walls(spans)
    extent = wall_extent_us(spans)
    total = sum(walls.values())
    fractions = {c: (w / total if total > 0 else 0.0)
                 for c, w in walls.items()}
    return {
        "schema": DECOMPOSE_SCHEMA_VERSION,
        "span_count": len(spans),
        "wall_us": extent,
        "categories_us": walls,
        "fractions": fractions,
        "overlap": overlap_verdict(spans),
        "decisions": decision_records(spans),
    }
