"""Deadline-based straggler detection (no hand-tuned timeouts).

A copy of ``repro.resilience.detect`` (pure Python). The port's serving loop
(``launch.serve``) uses the self-calibrated ("observed") form. The
"measured" form takes a launch plan's expected wall:
``DeadlineDetector(expected_us=plan.expected_launch_us)`` holds a deadline
from the first launch wherever ``pallas_step`` was priced by a measured
cost model (``kernels/probes.py``, ``kernels/schedule.py``).

A launch (or decode step) is flagged when its wall exceeds ``factor`` x
the EXPECTED wall. Two sources for the expectation, in precedence order:

  measured    the CostModel prices the launch
              (kernels.schedule.expected_launch_wall_us, the launch plan's
              ``expected_launch_us``) — the deadline exists from the first
              launch.
  observed    uncalibrated runs self-calibrate: after ``warmup`` clean
              observations the expectation is the running median of the
              walls seen so far. This is the analytic fallback — the
              analytic cost model carries only RATIOS (row-steps per
              exchange), never absolute microseconds, so it cannot price
              a deadline; the run's own walls can (DESIGN.md §11).

Flagged walls are NOT folded into the running median (a straggler must
not drag the baseline toward itself), recompile-boundary walls — marked
via ``note_recompile_boundary()`` before the first launch after a
(re)compile or membership change — are neither folded nor flagged (a
compile wall is expected to be slow; folding it would seed the warmup
median with an outlier), and the detector never *acts* — it reports
overshoot, and the caller decides (the engine records a tracer ``fault``
event; serve.py reports the step in ServeResult).
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional

#: deadline = factor x expected wall. Generous by design: the cost is a
#: false *negative* (a straggler coasts), never a false positive killing
#: healthy work — detection only reports.
DEFAULT_DEADLINE_FACTOR = 8.0


@dataclasses.dataclass
class Detection:
    """One flagged wall: the overshoot is the detection latency — how far
    past the deadline completion arrived."""

    index: int
    wall_us: float
    deadline_us: float

    @property
    def overshoot_us(self) -> float:
        return self.wall_us - self.deadline_us


class DeadlineDetector:
    def __init__(
        self,
        *,
        factor: float = DEFAULT_DEADLINE_FACTOR,
        expected_us: Optional[float] = None,
        warmup: int = 3,
        min_deadline_us: float = 500.0,
    ):
        if factor <= 1.0:
            raise ValueError(f"deadline factor must exceed 1, got {factor}")
        self.factor = float(factor)
        self.expected_us = expected_us
        self.warmup = int(warmup)
        self.min_deadline_us = float(min_deadline_us)
        self._walls: List[float] = []
        self.detections: List[Detection] = []
        self._n = 0
        self._boundary_next = False
        #: boundary walls seen (compile/repack walls excluded from both
        #: the median and the detections) — exposed for tests/telemetry
        self.boundary_skips = 0

    def deadline_us(self) -> Optional[float]:
        """The current deadline, or None while still unpriceable (no
        model and fewer than ``warmup`` clean observations)."""
        if self.expected_us is not None and self.expected_us > 0:
            return max(self.factor * self.expected_us, self.min_deadline_us)
        if len(self._walls) >= self.warmup:
            return max(self.factor * statistics.median(self._walls),
                       self.min_deadline_us)
        return None

    def note_recompile_boundary(self) -> None:
        """Mark the NEXT observed wall as crossing a recompile/repack
        boundary (the cohort's first launch, or the first launch after any
        membership change). That wall carries compilation, not steady-state
        work: folding it into the self-calibration median would let one
        warmup-compile outlier seed the baseline and inflate every later
        deadline, and flagging it would report a healthy repack as a
        straggler — so it is neither folded nor flagged."""
        self._boundary_next = True

    def observe(self, wall_us: float) -> Optional[Detection]:
        """Record one wall; returns a Detection when it blew the deadline."""
        boundary, self._boundary_next = self._boundary_next, False
        deadline = self.deadline_us()
        idx = self._n
        self._n += 1
        if boundary:
            self.boundary_skips += 1
            return None
        if deadline is not None and wall_us > deadline:
            det = Detection(idx, wall_us, deadline)
            self.detections.append(det)
            return det
        self._walls.append(wall_us)
        return None

    @property
    def source(self) -> str:
        return "measured" if self.expected_us else "observed"
