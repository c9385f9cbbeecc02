"""Serving requests: one TaskGraph run with arrival/deadline/priority.

A copy of ``repro.serving.request`` over the port's `TaskGraph`. A request
is the serving unit the fabric admits into an ensemble slot: it names WHAT
to compute (a seeded TaskGraph: pattern, T, W, payload, kernel) and HOW
urgently (arrival time, optional absolute completion deadline, priority).
The graph's seed drives ``initial_state``, so two requests with the same
shape but different seeds are different work: the bit-identity the fabric
asserts is per request, per seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.graph import TaskGraph
from repro_torch.core.task_kernels import KernelSpec


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request.

    ``arrival_s`` / ``deadline_s`` are absolute times on the fabric's
    clock (seconds for the wall clock, launch counts for the virtual
    LaunchClock the deterministic tests use). ``deadline_s=None`` asks
    the fabric to PRICE a deadline off the cost model at admission
    (``ServingFabric._price_deadline``); an explicit value is an SLO the
    fabric enforces as-is. Higher ``priority`` admits first.
    """

    rid: int
    graph: TaskGraph
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        if self.graph.steps < 1:
            raise ValueError(f"request {self.rid}: steps must be >= 1")
        if self.deadline_s is not None and self.deadline_s < self.arrival_s:
            raise ValueError(
                f"request {self.rid}: deadline {self.deadline_s} precedes "
                f"arrival {self.arrival_s}")


def make_request(rid: int, *, steps: int, width: int = 8,
                 pattern: str = "stencil_1d", payload: int = 16,
                 kernel: Optional[KernelSpec] = None, radius: int = 1,
                 fanout: int = 3, seed: int = 0, arrival_s: float = 0.0,
                 deadline_s: Optional[float] = None,
                 priority: int = 0) -> Request:
    """Convenience constructor mirroring TaskGraph's knobs."""
    return Request(
        rid=rid,
        graph=TaskGraph(
            steps=steps, width=width, pattern=pattern, payload=payload,
            kernel=kernel or KernelSpec("compute_bound", 4),
            radius=radius, fanout=fanout, seed=seed),
        arrival_s=arrival_s,
        deadline_s=deadline_s,
        priority=priority,
    )
