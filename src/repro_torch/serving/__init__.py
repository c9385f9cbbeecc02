"""Continuous-batching serving fabric over ``pallas_step``'s launch plans.

The port of ``repro.serving``. The serving analogue of the paper's
per-task-overhead question: decode steps are tasks, ensemble members are
requests, and per-request overhead under continuous arrival is the METG of
a serving system. Requests carry (pattern, T, W, deadline, priority) and a
seed; the plan-aware packer (`packer.py`) groups operand-compatible
requests into stacked cohorts; the fabric (`fabric.py`) runs each cohort
through the runtime's EnsembleLaunchPlan with dynamic membership: retiring
members free their (K, S) act-mask slots (the eviction primitive) and
queued requests are admitted into freed slots mid-run via ``admit_fn``,
with no re-capture and the same bits.
"""
from repro_torch.serving.fabric import (
    CohortReport,
    LaunchClock,
    RequestOutcome,
    ServeReport,
    ServingFabric,
    WallClock,
)
from repro_torch.serving.packer import cohort_key, order_key, pack
from repro_torch.serving.request import Request, make_request

__all__ = [
    "CohortReport",
    "LaunchClock",
    "Request",
    "RequestOutcome",
    "ServeReport",
    "ServingFabric",
    "WallClock",
    "cohort_key",
    "make_request",
    "order_key",
    "pack",
]
