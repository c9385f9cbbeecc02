"""Resilient host-stepped ensemble execution.

The port of ``repro.resilience.engine``. ``run_resilient`` drives a
runtime's :class:`EnsembleLaunchPlan` launch by launch on the host. Host
visibility at launch boundaries is what buys fault tolerance (nothing can
be detected, retried or replayed inside one CUDA graph replay) and it is
also the only cost: the clean path runs the same kernels over the same
operands as the plan does, with a host dispatch and a device synchronize
per launch (the host-stepping tax).

Per launch, in order:

  stage     the launch's (K, S) act row, as the plan reads it
            (``EnsembleLaunchPlan.act_rows``: a stacked plan's table staged
            on the runtime's device in one copy, and again after an
            eviction or admission edits it; a stepwise plan's host rows),
            so no host-to-card copy lands inside a timed launch.
  gate      the injection hook: one predicate check against the armed
            FaultPlan (``plan=None`` skips everything: no snapshot, no
            poison scan).
  dispatch  the launch, then ``Runtime._drain()`` (every shard's device at
            D > 1), wall-timed on the host clock. Transient transport
            faults raise here and retry in place with capped exponential
            backoff + jitter; launch faults raise (replay) or poison the
            output.
  verify    member faults evict (zero the member's act slot from this
            launch on, replay from the snapshot: survivors keep their bits,
            the dead member's rows frozen where its mask ends); poisoned
            output replays from the snapshot; deadline overshoot is flagged
            (detection latency recorded), never re-executed. The deadline
            is priced from the plan's ``deadline_expected_us`` where a
            launch is one replay, else self-calibrated from the walls.
  commit    keep the carry; a re-admitted member's t = 0 rows are written
            into the freed slot.

Replays start from the pre-launch bits. On the card a stacked plan's
launch is a CUDA graph replay that returns fresh tensors; on the eager
paths (the CPU, the stepwise plan, row shards across cards) a launch may
write buffers of the carry it is given (the sharded S = 1 step's halo
rows, its ping-pong buffers), and ``admit_fn`` writes the carry in place.
So while a plan is armed the engine keeps a clone of the pre-launch carry
and every retry and replay starts from a fresh clone of it. The poison
scan reads the members' states (``finalize``), not the raw carry, whose
halo rows and spare buffers hold memory no launch has written.

All detection and recovery work lands in tracer ``fault``-category spans
(walls: backoff sleeps) and zero-length ``fault`` records
(detections/verdicts), with the reference's names and attributes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.task_kernels import initial_state
from repro_torch.obs.tracer import CAT_FAULT, coerce_tracer
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.detect import DeadlineDetector
from repro_torch.resilience.faults import (
    FAULT_LAUNCH,
    FAULT_MEMBER,
    FAULT_STRAGGLER,
    FaultPlan,
    FaultState,
    LaunchFault,
    TransientTransportFault,
    UnrecoverableFault,
)

#: seed offset for the fresh member admitted into a freed slot, so the
#: re-admitted run is reproducible from the evicted member's own seed
READMIT_SEED_OFFSET = 7919


@dataclasses.dataclass
class RecoveryPolicy:
    """Recovery budgets and knobs (all deterministic given a plan seed)."""

    #: deadline = factor x expected launch wall (detect.py)
    deadline_factor: float = 8.0
    #: transient transport faults: attempts beyond the first
    max_transport_retries: int = 4
    backoff_base_s: float = 0.005
    backoff_cap_s: float = 0.25
    #: uniform jitter fraction added to each backoff delay
    backoff_jitter: float = 0.25
    #: replays (launch fault / poison / eviction) tolerated per launch
    max_replays_per_launch: int = 4
    #: scan launch output for NaN poison; None = only when a plan is armed
    #: (the no-fault path must not pay a device reduction per launch)
    check_poison: Optional[bool] = None
    #: admit a fresh member into an evicted slot at the next boundary
    readmit: bool = False


@dataclasses.dataclass
class FaultEvent:
    """One detection/recovery, as recorded."""

    kind: str
    launch: int
    action: str  # "retried" | "replayed" | "evicted" | "readmitted" | "flagged"
    member: int = -1
    attempts: int = 0
    mode: str = ""
    #: recovery wall spent on this event (backoff sleeps, wasted launch)
    wall_us: float = 0.0
    #: deadline overshoot for flagged stragglers (detection latency)
    overshoot_us: Optional[float] = None


@dataclasses.dataclass
class ResilientResult:
    """What a resilient run returns: outputs matching execute_ensemble
    plus the full fault/recovery ledger."""

    outputs: Tuple[np.ndarray, ...]
    wall_s: float
    launches: int
    events: List[FaultEvent]
    retries: int = 0
    replays: int = 0
    stragglers: int = 0
    #: member slot -> effective steps its output froze at (masked rows)
    evicted: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: member slot -> {"launch", "steps", "seed"} of the admitted member
    readmitted: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    deadline_us: Optional[float] = None
    deadline_source: str = ""

    @property
    def faults_seen(self) -> int:
        return len(self.events)


def backoff_delay_s(policy: RecoveryPolicy, attempt: int,
                    rng: np.random.Generator) -> float:
    """Capped exponential backoff with uniform jitter: attempt 1 waits
    ~base, each further attempt doubles, never past the cap."""
    base = min(policy.backoff_base_s * (2.0 ** (attempt - 1)), policy.backoff_cap_s)
    return base * (1.0 + policy.backoff_jitter * float(rng.random()))


def _map_tensors(fn, tree):
    """``fn`` over every tensor of a carry: a tensor, or tuples and lists
    of them nested to any depth (the sharded plans' shard lists)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, x) for x in tree)
    return tree


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_tensors(out.append, tree)
    return out


def _clone(carry):
    return _map_tensors(lambda x: x.clone(), carry)


def _is_poisoned(states) -> bool:
    return any(bool(torch.isnan(x).any()) for x in _tensors(states) if x.is_floating_point())


def _poison(carry):
    return _map_tensors(
        lambda x: torch.full_like(x, float("nan")) if x.is_floating_point() else x, carry)


class _Run:
    """One resilient execution (the mutable loop state run_resilient
    drives; split out so each recovery path stays readable)."""

    def __init__(self, runtime, ensemble, plan, policy, tracer):
        self.runtime = runtime
        self.ensemble = ensemble
        self.lp = runtime.build_ensemble_launches(ensemble)
        self.policy = policy
        self.tracer = tracer
        self.state = FaultState(plan) if plan is not None and plan.specs else None
        self.check_poison = (policy.check_poison if policy.check_poison is not None
                             else self.state is not None)
        self.detector = DeadlineDetector(
            factor=policy.deadline_factor, expected_us=self.lp.deadline_expected_us)
        self.acts = np.array(self.lp.acts, dtype=np.float32, copy=True)
        self.rows = self.lp.act_rows(self.acts)
        self.rng = np.random.default_rng(
            plan.seed if plan is not None and plan.seed is not None else 0)
        self.events: List[FaultEvent] = []
        self.retries = 0
        self.replays = 0
        self.stragglers = 0
        self.evicted: Dict[int, int] = {}
        self.readmitted: Dict[int, Dict] = {}
        #: the pre-launch carry while a plan is armed (replays clone it)
        self._snapshot = None

    # ------------------------------------------------------------ pieces

    def _record(self, name: str, **attrs) -> None:
        """Zero-length fault record (the decision-record idiom, under the
        fault category so traces separate recovery from scheduling)."""
        t = self.tracer.now_us()
        self.tracer.add(name, CAT_FAULT, t, t, **attrs)

    def _fresh(self):
        """A copy of the pre-launch carry for a retry or a replay."""
        return _clone(self._snapshot)

    def _dispatch(self, launch: int, carry, act_row):
        """One launch with in-place transport retry. Returns (wall_us,
        new_carry); raises LaunchFault (replay) or UnrecoverableFault
        (budget spent)."""
        lp, st, policy = self.lp, self.state, self.policy
        t0 = lp.launch_t0(launch)
        attempt = 0
        backoff_us = 0.0
        while True:
            t_start = time.perf_counter()
            try:
                if st is not None and st.transport_should_fail(launch):
                    raise TransientTransportFault(
                        f"injected transport fault at launch {launch}")
                lspec = st.peek(FAULT_LAUNCH, launch) if st else None
                if lspec is not None and lspec.mode == "raise":
                    st.take(FAULT_LAUNCH, launch)
                    raise LaunchFault(f"injected launch failure at launch {launch}")
                with _faults.transport_site(launch):
                    out = lp.launch_fn(carry, act_row, t0)
                sspec = st.take(FAULT_STRAGGLER, launch) if st else None
                if sspec is not None:
                    # completion arrives late: the stall is part of the wall
                    time.sleep(sspec.delay_s)
                self.runtime._drain()
                wall_us = (time.perf_counter() - t_start) * 1e6
                if attempt:
                    self.events.append(FaultEvent(
                        "transport", launch, "retried", attempts=attempt,
                        wall_us=backoff_us))
                lspec = st.take(FAULT_LAUNCH, launch) if st else None
                if lspec is not None:  # mode == "poison"
                    out = _poison(out)
                return wall_us, out
            except TransientTransportFault as e:
                attempt += 1
                self.retries += 1
                self._record("transport_fault", launch=launch, attempt=attempt,
                             error=str(e))
                if attempt > policy.max_transport_retries:
                    raise UnrecoverableFault(
                        f"transport at launch {launch} still failing after "
                        f"{attempt} attempts") from e
                delay = backoff_delay_s(policy, attempt, self.rng)
                with self.tracer.span("backoff", CAT_FAULT, launch=launch,
                                      attempt=attempt, delay_s=delay):
                    time.sleep(delay)
                backoff_us += delay * 1e6
                carry = self._fresh()

    def _evict(self, launch: int, member: int) -> None:
        """Freeze the member's act slot from this launch on: its rows
        stay exactly where the pre-launch snapshot left them (the masked
        rows), survivors never notice."""
        s = self.lp.steps_per_launch
        frozen = min(self.lp.member_steps[member], self.lp.launch_t0(launch))
        self.acts[launch:, member, :] = 0.0
        self.rows.edited()
        self.evicted[member] = int(frozen)
        self._record("member_evicted", launch=launch, member=member,
                     frozen_steps=int(frozen), steps_per_launch=s)

    def _readmit(self, member: int, next_launch: int):
        """Admit a fresh member into the freed slot at the next launch
        boundary (the serving fabric's admission primitive): new init rows
        on the runtime's device, a fresh activity schedule starting at ITS
        OWN t = 0."""
        lp = self.lp
        if lp.admit_fn is None or next_launch >= lp.num_launches:
            return None
        g = self.ensemble.members[member]
        seed = g.seed + READMIT_SEED_OFFSET
        init = initial_state(g.width, g.payload, seed, device=self.runtime.device)
        s = lp.steps_per_launch
        rem = lp.num_launches - next_launch
        tloc = 1 + (np.arange(rem)[:, None] * s + np.arange(s)[None, :])
        self.acts[next_launch:, member, :] = (tloc < g.steps).astype(np.float32)
        self.rows.edited()
        eff = int(min(g.steps, rem * s + 1))
        self.readmitted[member] = {"launch": int(next_launch), "steps": eff, "seed": int(seed)}
        self._record("member_readmitted", launch=next_launch, member=member, steps=eff,
                     seed=seed)
        return init

    def run_launch(self, launch: int, carry):
        """Run one launch to a committed carry (retry / replay / evict
        until it lands or the policy budget is spent)."""
        st, policy = self.state, self.policy
        self._snapshot = _clone(carry) if st is not None else None
        replays_here = 0
        admit_member: Optional[int] = None
        act_row = self.rows[launch]
        source = carry
        while True:
            try:
                wall_us, candidate = self._dispatch(launch, source, act_row)
            except LaunchFault as e:
                replays_here += 1
                self.replays += 1
                self._record("launch_fault", launch=launch, mode="raise", error=str(e))
                self.events.append(FaultEvent("launch", launch, "replayed", mode="raise"))
                if replays_here > policy.max_replays_per_launch:
                    raise UnrecoverableFault(f"launch {launch} replay budget spent") from e
                source = self._fresh()
                continue
            mspec = st.take(FAULT_MEMBER, launch) if st else None
            if mspec is not None:
                # the member died during this launch: its slice of the
                # candidate is garbage. Evict and replay from the snapshot
                # with the slot masked: survivors recompute the same bits,
                # the dead member's rows freeze at the snapshot.
                replays_here += 1
                self.replays += 1
                self._evict(launch, mspec.member)
                # membership changed: the next committed wall crosses a
                # repack boundary and must not seed the deadline median
                self.detector.note_recompile_boundary()
                self.events.append(FaultEvent(
                    "member", launch, "evicted", member=mspec.member, wall_us=wall_us))
                if policy.readmit:
                    admit_member = mspec.member
                act_row = self.rows[launch]
                if replays_here > policy.max_replays_per_launch:
                    raise UnrecoverableFault(f"launch {launch} replay budget spent")
                source = self._fresh()
                continue
            if self.check_poison and _is_poisoned(self.lp.finalize(candidate)):
                replays_here += 1
                self.replays += 1
                self._record("launch_poisoned", launch=launch)
                self.events.append(FaultEvent(
                    "launch", launch, "replayed", mode="poison", wall_us=wall_us))
                if replays_here > policy.max_replays_per_launch:
                    raise UnrecoverableFault(
                        f"launch {launch} keeps returning poisoned output")
                source = self._fresh()
                continue
            det = self.detector.observe(wall_us)
            if det is not None:
                self.stragglers += 1
                self._record("straggler", launch=launch, wall_us=wall_us,
                             deadline_us=det.deadline_us, overshoot_us=det.overshoot_us)
                self.events.append(FaultEvent(
                    "straggler", launch, "flagged", wall_us=wall_us,
                    overshoot_us=det.overshoot_us))
            carry = candidate
            break
        self._snapshot = None
        if admit_member is not None:
            init = self._readmit(admit_member, launch + 1)
            if init is not None:
                carry = self.lp.admit_fn(carry, admit_member, init)
                # the first wall after a re-admission is a repack boundary
                self.detector.note_recompile_boundary()
        return carry


def run_resilient(
    runtime,
    ensemble,
    *,
    plan: Optional[FaultPlan] = None,
    policy: Optional[RecoveryPolicy] = None,
    tracer=None,
    inits=None,
) -> ResilientResult:
    """Execute the ensemble with fault injection/detection/recovery.

    ``runtime`` must implement ``build_ensemble_launches`` (pallas_step;
    base.Runtime names the whole-run restart fallback for the rest). With
    ``plan=None`` nothing is armed: the per-launch hook is one ``is not
    None`` check, and no snapshot and no poison scan are taken. ``inits``
    are the members' initial states (tensors or numpy arrays, e.g. the
    reference's), as for ``execute_ensemble``; by default the port's own.
    """
    policy = policy or RecoveryPolicy()
    tracer = coerce_tracer(tracer) if tracer is not None else runtime.tracer
    run = _Run(runtime, ensemble, plan, policy, tracer)
    lp = run.lp
    xs = runtime._ensemble_inits(ensemble, inits)
    runtime._drain()
    t_start = time.perf_counter()
    with _faults.armed(run.state):
        carry = lp.init_fn(xs)
        runtime._drain()
        for launch in range(lp.num_launches):
            carry = run.run_launch(launch, carry)
        outputs = lp.finalize(carry)
        runtime._drain()
    wall_s = time.perf_counter() - t_start
    return ResilientResult(
        outputs=tuple(o.detach().cpu().numpy() for o in outputs),
        wall_s=wall_s,
        launches=lp.num_launches,
        events=run.events,
        retries=run.retries,
        replays=run.replays,
        stragglers=run.stragglers,
        evicted=run.evicted,
        readmitted=run.readmitted,
        deadline_us=run.detector.deadline_us(),
        deadline_source=run.detector.source,
    )
