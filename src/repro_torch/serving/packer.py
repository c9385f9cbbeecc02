"""Plan-aware request packing: which requests may share a stacked cohort.

A copy of ``repro.serving.packer`` over the port's ``pallas_step``.
Mixed-plan tuple ensembles pin cadence to per-step dispatch
(``pallas_step.stacking_verdict`` names why), so the packer never builds
one: requests group by ``cohort_key`` (FULL operand-table identity, not
just the stacked path's structural minimum) and incompatible requests form
separate cohorts instead of one degraded tuple.

The key is deliberately stricter than ``stacking_verdict`` requires (which
only needs uniform (width, payload, kernel) and every member on the halo
plan). Same (plan, width, payload, kernel, pattern, radius, fanout), plus
the graph seed for seed-structured patterns, means every cohort member
shares the same operand tables, which is what makes MID-RUN admission
sound: any freed (K, S) act-mask slot can host any queued cohort request,
because the slot's operand slice is already the admitted request's. Only
(steps, seed, deadline, priority) vary within a cohort, and the seed only
feeds ``initial_state``.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.graph import TaskGraph
from repro_torch.serving.request import Request

#: patterns whose graph seed bakes into the dependency tables themselves
#: (not just the initial state): the seed joins the cohort key for them
SEED_STRUCTURED_PATTERNS = frozenset({"random_nearest"})


def cohort_key(runtime, graph: TaskGraph) -> Tuple:
    """The compatibility class of ``graph`` under ``runtime``.

    Two graphs with equal keys resolve the same plan kind, the same block
    shape and the same operand tables, so they may share one stacked
    launch AND one act-mask slot across time. Raises when the runtime
    cannot place the graph on any plan (nothing to pack)."""
    plan, why = runtime.plan_for(graph)
    if plan is None:
        raise ValueError(f"unpackable request graph {graph.describe()}: {why}")
    seed = graph.seed if graph.pattern in SEED_STRUCTURED_PATTERNS else None
    return (plan, graph.width, graph.payload, graph.kernel, graph.pattern,
            graph.radius, graph.fanout, seed)


def order_key(req: Request) -> Tuple:
    """Admission order: priority first (higher wins), then earliest
    deadline, then arrival, then rid as the deterministic tiebreak."""
    deadline = req.deadline_s if req.deadline_s is not None else float("inf")
    return (-req.priority, deadline, req.arrival_s, req.rid)


def pack(runtime, requests: List[Request], max_slots: int) -> List[List[Request]]:
    """Static packing preview: admission-ordered requests greedily split
    into compatibility cohorts of at most ``max_slots``.

    The fabric itself packs DYNAMICALLY (arrivals interleave with
    retirements and freed slots re-admit), but the grouping rule is this
    one; tests and the card's smoke run use it to predict the cohort census
    a request mix should produce."""
    if max_slots < 1:
        raise ValueError(f"max_slots must be >= 1, got {max_slots}")
    cohorts: List[List[Request]] = []
    for req in sorted(requests, key=order_key):
        key = cohort_key(runtime, req.graph)
        placed = False
        for cohort in cohorts:
            if len(cohort) < max_slots and cohort_key(runtime, cohort[0].graph) == key:
                cohort.append(req)
                placed = True
                break
        if not placed:
            cohorts.append([req])
    return cohorts
