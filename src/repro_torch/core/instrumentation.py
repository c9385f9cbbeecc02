"""Runtime-overhead instrumentation for production loops.

Counterpart of ``repro.core.instrumentation``: the paper's methodology
applied to the framework itself. A serving loop is a task graph whose
per-step "tasks" are the model steps, and the quantity of interest is how
much of the wall clock the *runtime* (dispatch, the Python loop) adds on
top of the device's work.

``OverheadProfiler`` records step walls and reports:
  * per-step wall times and effective task granularity
    (wall x devices / tasks — Task Bench's granularity formula),
  * dispatch overhead (a trivial device op in a loop, then one
    synchronize),
  * step-METG: the smallest per-step useful work that would keep the fleet
    >= 50% efficient given the measured overhead — the paper's METG applied
    to the production loop,
  * token throughput (``tokens_per_step``; the serving loop's currency),
  * per-category wall fractions when a span ``tracer`` is attached
    (``repro_torch.obs``): the decomposed view of the same wall the records
    sum.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core.metg import DEFAULT_THRESHOLD


@functools.lru_cache(maxsize=None)
def measure_dispatch_overhead(reps: int = 50, device: str = "cuda") -> float:
    """Seconds per dispatch of a trivial device op: ``reps`` adds queued in
    a loop, then one ``torch.cuda.synchronize()`` (none on the CPU).

    Memoized per (reps, device): every profiler in a process asks the same
    question about the same device queue.
    ``measure_dispatch_overhead.cache_clear()`` re-arms it."""
    dev = torch.device(device)
    x = torch.zeros((), device=dev)
    x = x + 1.0  # warm up the op before timing it
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = x + 1.0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps


@dataclasses.dataclass
class StepRecord:
    step: int
    wall: float
    tokens: int = 0
    flops: float = 0.0


@dataclasses.dataclass
class OverheadReport:
    steps: int
    mean_wall: float
    p50_wall: float
    best_wall: float
    dispatch_overhead: float
    overhead_fraction: float  # dispatch / mean_wall
    granularity_us: float  # wall x devices / tasks_per_step
    step_metg_us: Optional[float]
    sustained_flops_per_s: float
    tokens_per_s: float = 0.0
    #: category -> fraction of traced wall (only when a tracer is attached)
    category_fractions: Optional[Dict[str, float]] = None
    #: steps whose wall blew a deadline (resilience.DeadlineDetector)
    flagged_steps: int = 0
    #: steps whose output failed a health check (NaN logits etc.)
    poisoned_steps: int = 0

    def lines(self) -> List[str]:
        out = [
            f"steps measured        : {self.steps}",
            f"mean / p50 / best wall: {self.mean_wall * 1e3:.3f} / "
            f"{self.p50_wall * 1e3:.3f} / {self.best_wall * 1e3:.3f} ms",
            f"dispatch overhead     : {self.dispatch_overhead * 1e6:.1f} us "
            f"({self.overhead_fraction * 100:.2f}% of step)",
            f"effective granularity : {self.granularity_us:.1f} us",
            f"sustained FLOP/s      : {self.sustained_flops_per_s / 1e9:.3f} G",
        ]
        if self.tokens_per_s > 0:
            out.append(f"tokens/s              : {self.tokens_per_s:.1f}")
        if self.step_metg_us is not None:
            out.append(f"step-METG(50%)        : {self.step_metg_us:.1f} us")
        if self.category_fractions:
            cats = "  ".join(
                f"{k}={v * 100:.1f}%"
                for k, v in sorted(self.category_fractions.items()) if v > 0)
            out.append(f"wall by category      : {cats}")
        if self.flagged_steps or self.poisoned_steps:
            out.append(f"faulted steps         : "
                       f"{self.flagged_steps} past deadline, "
                       f"{self.poisoned_steps} poisoned")
        return out


class OverheadProfiler:
    """Records step walls; derives overhead metrics."""

    def __init__(
        self,
        devices: int = 1,
        tasks_per_step: int = 1,
        flops_per_step: float = 0.0,
        tokens_per_step: int = 0,
        threshold: float = DEFAULT_THRESHOLD,
        device: str = "cuda",
        tracer=None,
    ):
        self.devices = max(devices, 1)
        self.tasks_per_step = max(tasks_per_step, 1)
        self.flops_per_step = flops_per_step
        self.tokens_per_step = max(tokens_per_step, 0)
        self.threshold = threshold
        self.records: List[StepRecord] = []
        #: where `dispatch_overhead` is measured
        self.device = str(device)
        #: optional span recorder (``repro_torch.obs.Tracer``); when
        #: attached, the report carries the per-category decomposition of
        #: the same wall
        self.tracer = tracer
        self._dispatch: Optional[float] = None
        #: step indices flagged by a deadline detector / health check
        #: (launch/serve.py feeds these; the report carries the counts)
        self.flagged: List[int] = []
        self.poisoned: List[int] = []

    def record(self, wall: float, tokens: Optional[int] = None) -> None:
        self.records.append(
            StepRecord(
                len(self.records), wall,
                tokens=self.tokens_per_step if tokens is None else tokens,
                flops=self.flops_per_step,
            )
        )

    @property
    def dispatch_overhead(self) -> float:
        if self._dispatch is None:
            self._dispatch = measure_dispatch_overhead(device=self.device)
        return self._dispatch

    def _category_fractions(self) -> Optional[Dict[str, float]]:
        if self.tracer is None or not getattr(self.tracer, "spans", None):
            return None
        from repro_torch.obs import summarize

        return summarize(self.tracer.spans)["fractions"]

    def report(self, skip_warmup: int = 1) -> OverheadReport:
        recs = self.records[skip_warmup:] or self.records
        if not recs:
            raise ValueError("no steps recorded")
        walls = sorted(r.wall for r in recs)
        mean = sum(walls) / len(walls)
        p50 = walls[len(walls) // 2]
        best = walls[0]
        disp = self.dispatch_overhead
        gran_us = mean * self.devices / self.tasks_per_step * 1e6

        # step-METG: per-step useful compute time c such that
        # c / (c + overhead) = threshold  =>  c = overhead * th / (1 - th);
        # expressed as granularity (per device) in microseconds.
        th = self.threshold
        metg_us = (disp * th / (1.0 - th)) / self.tasks_per_step * 1e6 \
            if th < 1.0 else None

        flops = self.flops_per_step / mean if mean > 0 else 0.0
        total_wall = sum(r.wall for r in recs)
        total_tokens = sum(r.tokens for r in recs)
        tps = total_tokens / total_wall if total_wall > 0 else 0.0
        return OverheadReport(
            steps=len(recs),
            mean_wall=mean,
            p50_wall=p50,
            best_wall=best,
            dispatch_overhead=disp,
            overhead_fraction=min(disp / mean, 1.0) if mean > 0 else 0.0,
            granularity_us=gran_us,
            step_metg_us=metg_us,
            sustained_flops_per_s=flops,
            tokens_per_s=tps,
            category_fractions=self._category_fractions(),
            flagged_steps=len(self.flagged),
            poisoned_steps=len(self.poisoned),
        )
