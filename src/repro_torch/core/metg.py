"""METG — Minimum Effective Task Granularity (Task Bench's metric).

METG(50%) is the smallest *average task granularity* at which a system still
sustains >= 50% of its peak FLOP/s (paper §4). Protocol, exactly as in the
paper §6.1:

  1. Sweep grain size (kernel iterations per task) over a task graph.
  2. Peak FLOP/s = the maximum rate observed over the sweep (all systems reach
     (near-)peak at large grain — paper Fig 1a).
  3. efficiency(g) = rate(g) / peak.
  4. task granularity(g) = wall_time x cores / num_tasks   (paper §6.1).
  5. METG = granularity at the intersection of the efficiency curve with the
     50% line (log-interpolated between bracketing samples — the paper reads
     it off the plotted intersection, Fig 1b).

A copy of ``repro.core.metg``: the port imports nothing of the JAX
package, and the tests hold the two equal on identical samples. Anything
that yields (grain, wall_time) samples can be scored.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence

DEFAULT_THRESHOLD = 0.5  # the paper's 50% choice


@dataclasses.dataclass(frozen=True)
class GrainSample:
    """One point of a granularity sweep."""

    iterations: int  # grain knob value
    wall_time: float  # seconds for the whole graph execution (best of reps)
    total_flops: float  # useful FLOPs executed by all tasks
    num_tasks: int
    cores: int  # devices participating (paper: cores)

    @property
    def flops_per_second(self) -> float:
        return self.total_flops / self.wall_time if self.wall_time > 0 else 0.0

    @property
    def granularity_us(self) -> float:
        """Average task granularity in microseconds: wall x cores / tasks."""
        return self.wall_time * self.cores / self.num_tasks * 1e6


def combine_grain_samples(
    samples: Sequence[GrainSample], wall_time: Optional[float] = None
) -> GrainSample:
    """Aggregate per-member samples of one concurrently executed ensemble.

    The members of a GraphEnsemble run inside a single measured execution,
    so the aggregate keeps ONE wall time (by default the max across inputs;
    pass ``wall_time`` when the ensemble wall was measured directly) while
    FLOPs and task counts sum. ``iterations`` becomes the task-weighted mean
    grain, so the aggregate lands at the ensemble's *average task
    granularity* — the x-axis Task Bench uses, which is well-defined even
    for mixed-grain ensembles. ``cores`` must agree across members (they
    share the device set).
    """
    if not samples:
        raise ValueError("cannot combine an empty sample list")
    cores = {s.cores for s in samples}
    if len(cores) > 1:
        raise ValueError(f"members ran on different core counts: {sorted(cores)}")
    tasks = sum(s.num_tasks for s in samples)
    mean_iters = sum(s.iterations * s.num_tasks for s in samples) / tasks
    return GrainSample(
        iterations=int(round(mean_iters)),
        wall_time=wall_time if wall_time is not None
        else max(s.wall_time for s in samples),
        total_flops=sum(s.total_flops for s in samples),
        num_tasks=tasks,
        cores=cores.pop(),
    )


@dataclasses.dataclass(frozen=True)
class EfficiencyPoint:
    iterations: int
    granularity_us: float
    flops_per_second: float
    efficiency: float


@dataclasses.dataclass(frozen=True)
class MetgResult:
    metg_us: Optional[float]  # None if the curve never reaches the threshold
    peak_flops_per_second: float
    threshold: float
    curve: List[EfficiencyPoint]

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        m = "unreached" if self.metg_us is None else f"{self.metg_us:.2f} us"
        return (
            f"METG({int(self.threshold * 100)}%) = {m} "
            f"(peak {self.peak_flops_per_second / 1e9:.3f} GFLOP/s, "
            f"{len(self.curve)} samples)"
        )


def efficiency_curve(
    samples: Sequence[GrainSample], peak: Optional[float] = None
) -> List[EfficiencyPoint]:
    """Efficiency vs granularity, sorted by ascending granularity."""
    if not samples:
        return []
    pk = peak if peak is not None else max(s.flops_per_second for s in samples)
    pk = max(pk, 1e-30)
    pts = [
        EfficiencyPoint(
            iterations=s.iterations,
            granularity_us=s.granularity_us,
            flops_per_second=s.flops_per_second,
            efficiency=s.flops_per_second / pk,
        )
        for s in samples
    ]
    pts.sort(key=lambda p: p.granularity_us)
    return pts


def compute_metg(
    samples: Sequence[GrainSample],
    threshold: float = DEFAULT_THRESHOLD,
    peak: Optional[float] = None,
) -> MetgResult:
    """Extract METG from a granularity sweep.

    The efficiency curve (ascending granularity) is scanned for the *first*
    crossing from below-threshold to >=threshold; METG is the log-space
    interpolated granularity at the crossing. If even the smallest granularity
    sample meets the threshold, METG is that sample's granularity (an upper
    bound — the paper reports it the same way when the curve never dips).
    """
    curve = efficiency_curve(samples, peak)
    pk = peak if peak is not None else (
        max((s.flops_per_second for s in samples), default=0.0)
    )
    if not curve:
        return MetgResult(None, pk, threshold, curve)

    if curve[0].efficiency >= threshold:
        return MetgResult(curve[0].granularity_us, pk, threshold, curve)

    for lo, hi in zip(curve, curve[1:]):
        if lo.efficiency < threshold <= hi.efficiency:
            # log-interpolate granularity between the bracketing samples
            g0, g1 = math.log(lo.granularity_us), math.log(hi.granularity_us)
            e0, e1 = lo.efficiency, hi.efficiency
            frac = (threshold - e0) / max(e1 - e0, 1e-12)
            return MetgResult(math.exp(g0 + frac * (g1 - g0)), pk, threshold, curve)

    return MetgResult(None, pk, threshold, curve)


def default_grain_schedule(
    min_iters: int = 1, max_iters: int = 1 << 16, points_per_decade: int = 3
) -> List[int]:
    """Geometric grain-size schedule like the paper's sweeps."""
    grains: List[int] = []
    g = float(min_iters)
    ratio = 10.0 ** (1.0 / points_per_decade)
    while g <= max_iters:
        v = int(round(g))
        if not grains or v > grains[-1]:
            grains.append(v)
        g *= ratio
    return grains
