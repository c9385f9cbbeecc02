"""The continuous-batching fabric: cohort lifecycle over launch plans.

The port of ``repro.serving.fabric``. One cohort = one
``EnsembleLaunchPlan`` whose (K, S) act-mask slots serve MANY requests
over time. At every launch boundary the fabric

  1. retires slots with no remaining active work (copies the member's
     final state to the host, records completion),
  2. evicts slots past their deadline (zeroes the slot's act rows from
     this launch on, the engine's eviction edit, and records the frozen
     step),
  3. admits queued compatible requests into freed slots via the plan's
     ``admit_fn`` (stacked cohorts only: their operand tables are
     time-invariant and shared across slots by the packer's cohort key,
     so a fresh member's t = 0 state is the only thing that changes), and
  4. dispatches the launch (its act row read from the act table staged on
     the runtime's device, then the launch and a device synchronize,
     timed), feeding the wall to a DeadlineDetector whose
     post-membership-change walls are recompile-boundary-skipped.

No re-capture across membership churn: on the card the stacked plan's
launch is one CUDA graph captured when the plan is built, and evicting or
admitting changes only the VALUES it is staged with, which the plan's
``compile_counter`` (``_build.CAPTURES["graphs"]``, one counter for the
whole process) asserts. So nothing may capture between a cohort's first
launch and its end: ``verify=True``'s oracle, ``execute_ensemble``, which
captures, runs only after serving. An admitted request may outlive the
cohort's current schedule; the fabric then appends all-zero act rows, and
a stacked plan ignores ``t0`` (its tables are time-invariant), so the
longer horizon needs no new capture either.

Bit-identity: every request's output must equal "serial execution of the
same seeded request". The exact oracle is the SAME-K uniform ensemble,
``execute_ensemble(GraphEnsemble((graph,) * K))[slot]`` with the request's
effective steps: the same K, the same launch shapes.

Clocks: the fabric is generic over a clock so tests run DETERMINISTICALLY.
``WallClock`` is real time; ``LaunchClock`` is virtual time advancing 1.0
per dispatched launch, making arrival/deadline interleavings a pure
function of the request list.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import GraphEnsemble, TaskGraph
from repro_torch.core.task_kernels import initial_state
from repro_torch.kernels import schedule as _schedule
from repro_torch.resilience.detect import DeadlineDetector
from repro_torch.serving.packer import cohort_key, order_key
from repro_torch.serving.request import Request


class WallClock:
    """Real elapsed seconds since construction. Launches advance it by
    themselves; waiting sleeps."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance_launch(self) -> None:
        pass  # real time already passed during the launch

    def wait_until(self, t: float) -> None:
        delta = t - self.now()
        if delta > 0:
            time.sleep(delta)

    def launch_unit_s(self, lp, detector: DeadlineDetector) -> Optional[float]:
        """Expected seconds per launch: the measured cost model's pricing
        where the plan's launch is one replay (``deadline_expected_us``),
        else the detector's self-calibrated median (deadline / factor),
        else unpriceable."""
        if lp.deadline_expected_us:
            return lp.deadline_expected_us * 1e-6
        d = detector.deadline_us()
        if d is not None:
            return (d / detector.factor) * 1e-6
        return None


class LaunchClock:
    """Virtual clock: time is a launch count. Every dispatched launch
    costs exactly 1.0, so arrival/retire/admit interleavings (and priced
    deadlines) are deterministic functions of the request list."""

    def __init__(self) -> None:
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def advance_launch(self) -> None:
        self._t += 1.0

    def wait_until(self, t: float) -> None:
        self._t = max(self._t, t)

    def launch_unit_s(self, lp, detector: DeadlineDetector) -> Optional[float]:
        del lp, detector
        return 1.0


@dataclasses.dataclass
class RequestOutcome:
    """One request's fate through the fabric."""

    rid: int
    status: str  # "completed" | "deadline_evicted"
    effective_steps: int  # steps actually executed (== T unless evicted)
    arrival_s: float
    admitted_s: float
    finished_s: float
    cohort: int
    slot: int
    admitted_mid_run: bool
    deadline_s: Optional[float]
    graph: Optional[TaskGraph] = None  # what ran (oracle input)
    bit_identical: Optional[bool] = None  # None until verified
    output: Optional[np.ndarray] = None

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.arrival_s


@dataclasses.dataclass
class CohortReport:
    """One cohort's census: what ran, how it churned, whether the
    no-re-capture contract held."""

    index: int
    key: str
    kind: str  # EnsembleLaunchPlan.kind: "stacked" | "stepwise"
    reason: str  # stacking_verdict's reason string
    slots: int
    steps_per_launch: int
    launches_run: int
    requests: int
    admitted_mid_run: int
    deadline_evictions: int
    membership_changes: int  # retire-then-readmit + evictions
    recompiles: Optional[int]  # captures after the 1st launch
    slot_utilization: float  # active-slot-launches / (K * launches_run)


@dataclasses.dataclass
class ServeReport:
    outcomes: List[RequestOutcome]
    cohorts: List[CohortReport]
    wall_s: float

    @property
    def completed(self) -> List[RequestOutcome]:
        return [o for o in self.outcomes if o.status == "completed"]

    @property
    def bit_identical(self) -> Optional[bool]:
        """True when every verified request matched its serial oracle;
        None when verification was off."""
        verdicts = [o.bit_identical for o in self.outcomes if o.bit_identical is not None]
        if not verdicts:
            return None
        return all(verdicts)

    def latency_percentiles_s(self, qs=(50, 95, 99)) -> Dict[str, float]:
        lats = [o.latency_s for o in self.completed]
        if not lats:
            return {f"p{q}": float("nan") for q in qs}
        return {f"p{q}": float(np.percentile(lats, q)) for q in qs}


@dataclasses.dataclass
class _Slot:
    req: Request
    l0: int  # launch index of admission (0 for cohort founders)
    admitted_s: float
    deadline_s: Optional[float]
    mid_run: bool


class ServingFabric:
    """Continuous-batching executor over one runtime.

    ``runtime`` must expose ``build_ensemble_launches`` /
    ``stacking_verdict`` / ``plan_for`` (pallas_step). ``max_slots`` is K
    per cohort; ``deadline_factor`` scales priced deadlines (deadline =
    factor x expected service); ``verify=True`` checks every outcome
    against its serial same-K oracle after serving (a capture per oracle on
    the card: tests and smoke runs only). A request's initial state is
    `initial_state` of its graph's seed, on the runtime's device."""

    def __init__(self, runtime, *, max_slots: int = 4,
                 deadline_factor: float = _schedule.DEADLINE_FACTOR,
                 verify: bool = False, clock=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.runtime = runtime
        self.max_slots = int(max_slots)
        self.deadline_factor = float(deadline_factor)
        self.verify = bool(verify)
        self.clock = clock if clock is not None else WallClock()
        self._oracle_cache: Dict[Tuple, np.ndarray] = {}

    # ------------------------------------------------------------- serving

    def serve(self, requests: List[Request]) -> ServeReport:
        """Run every request to completion (or deadline eviction)."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request rids must be unique")
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        outcomes: List[RequestOutcome] = []
        cohorts: List[CohortReport] = []
        t_start = time.perf_counter()
        while pending:
            now = self.clock.now()
            ready = [r for r in pending if r.arrival_s <= now]
            if not ready:
                self.clock.wait_until(min(r.arrival_s for r in pending))
                continue
            ready.sort(key=order_key)
            key = cohort_key(self.runtime, ready[0].graph)
            batch = [r for r in ready if cohort_key(self.runtime, r.graph) == key]
            batch = batch[: self.max_slots]
            for r in batch:
                pending.remove(r)
            cohorts.append(self._run_cohort(len(cohorts), key, batch, pending, outcomes))
        wall_s = time.perf_counter() - t_start
        if self.verify:
            self._verify(outcomes, cohorts)
        return ServeReport(outcomes=outcomes, cohorts=cohorts, wall_s=wall_s)

    # -------------------------------------------------------------- cohort

    def _run_cohort(self, index: int, key, batch: List[Request],
                    pending: List[Request],
                    outcomes: List[RequestOutcome]) -> CohortReport:
        rt = self.runtime
        ens = GraphEnsemble(tuple(r.graph for r in batch))
        ok, reason = rt.stacking_verdict(ens)
        build_s = self.clock.now()
        lp = rt.build_ensemble_launches(ens)
        xs = rt._ensemble_inits(ens, [self._init(r.graph) for r in batch])
        now = self.clock.now()
        # the plan's build (on the card, its launch's capture) and the
        # founders' initial states are set-up, not service: priced
        # deadlines do not count them
        built = (build_s, now)
        stacked = lp.kind == "stacked"
        K = len(batch)
        S = lp.steps_per_launch
        acts = np.array(lp.acts, copy=True)
        rows = lp.act_rows(acts)
        detector = DeadlineDetector(factor=self.deadline_factor,
                                    expected_us=lp.deadline_expected_us)
        # the cohort's first launch carries its warm-up
        detector.note_recompile_boundary()
        slots: List[Optional[_Slot]] = [
            _Slot(req=r, l0=0, admitted_s=now,
                  deadline_s=self._price_deadline(r, lp, detector, S, built), mid_run=False)
            for r in batch
        ]
        carry = lp.init_fn(xs)
        rt._drain()
        membership_changes = 0
        admitted_mid_run = 0
        deadline_evictions = 0
        launches_run = 0
        util_active = 0
        compile_base: Optional[int] = None
        served = len(batch)

        def snapshot(slot: int) -> np.ndarray:
            # a copy: on the CPU the member's state is a view of the carry,
            # which the next admission overwrites in place
            return lp.finalize(carry)[slot].detach().to("cpu", copy=True).numpy()

        def close(slot: int, status: str, eff: int) -> None:
            st = slots[slot]
            outcomes.append(RequestOutcome(
                rid=st.req.rid, status=status, effective_steps=eff,
                arrival_s=st.req.arrival_s, admitted_s=st.admitted_s,
                finished_s=self.clock.now(), cohort=index, slot=slot,
                admitted_mid_run=st.mid_run, deadline_s=st.deadline_s,
                graph=st.req.graph, output=snapshot(slot)))
            slots[slot] = None

        l = 0
        while l < acts.shape[0]:
            now = self.clock.now()
            # 1. retire slots whose remaining schedule is empty
            for slot in range(K):
                st = slots[slot]
                if st is not None and not acts[l:, slot, :].any():
                    close(slot, "completed", st.req.graph.steps)
            # 2. deadline-miss evictions (the act-mask freeze: zero the
            # slot's rows from this launch on; state stays at the frozen
            # step, exactly the engine's _evict edit)
            for slot in range(K):
                st = slots[slot]
                if st is not None and st.deadline_s is not None and now > st.deadline_s:
                    frozen = int(min(st.req.graph.steps, 1 + (l - st.l0) * S))
                    acts[l:, slot, :] = 0.0
                    rows.edited()
                    deadline_evictions += 1
                    membership_changes += 1
                    detector.note_recompile_boundary()
                    close(slot, "deadline_evicted", frozen)
            # 3. admit queued compatible requests into freed slots. Stacked
            # plans only: their tables are time-invariant and slot-uniform,
            # so admit_fn's fresh t = 0 rows are sound at any boundary;
            # stepwise plans are time-indexed: fixed membership.
            if stacked and lp.admit_fn is not None:
                free = [k for k in range(K) if slots[k] is None]
                if free:
                    queue = sorted(
                        (r for r in pending
                         if r.arrival_s <= now and cohort_key(rt, r.graph) == key),
                        key=order_key)
                    for r, slot in zip(queue, free):
                        acts = self._admit_acts(acts, l, slot, r.graph, S)
                        rows.edited(acts)
                        init = rt._init(r.graph, self._init(r.graph))
                        carry = lp.admit_fn(carry, slot, init)
                        rt._drain()
                        pending.remove(r)
                        slots[slot] = _Slot(
                            req=r, l0=l, admitted_s=now,
                            deadline_s=self._price_deadline(r, lp, detector, S, built),
                            mid_run=True)
                        served += 1
                        admitted_mid_run += 1
                        membership_changes += 1
                        detector.note_recompile_boundary()
            # 4. done? (all remaining act rows dead and nothing admitted)
            if not acts[l:].any():
                break
            # 5. dispatch (an all-zero act row is a semantic no-op, the mask
            # freezes every slot, so skip it without dispatching)
            if acts[l].any():
                row = rows[l]
                t1 = time.perf_counter()
                carry = lp.launch_fn(carry, row, lp.launch_t0(l))
                rt._drain()
                detector.observe((time.perf_counter() - t1) * 1e6)
                launches_run += 1
                util_active += int((acts[l] > 0).any(axis=-1).sum())
                if compile_base is None and lp.compile_counter is not None:
                    compile_base = int(lp.compile_counter())
                self.clock.advance_launch()
            l += 1
        for slot in range(K):
            if slots[slot] is not None:
                close(slot, "completed", slots[slot].req.graph.steps)
        recompiles: Optional[int] = None
        if compile_base is not None:
            recompiles = int(lp.compile_counter()) - compile_base
            if recompiles:
                raise RuntimeError(
                    f"cohort {index}: the launch was re-captured {recompiles}x across "
                    f"membership churn: the no-re-capture contract of act-mask "
                    f"evict/admit is broken (shapes must be membership-invariant)")
        return CohortReport(
            index=index, key=repr(key), kind=lp.kind, reason=reason,
            slots=K, steps_per_launch=S, launches_run=launches_run,
            requests=served, admitted_mid_run=admitted_mid_run,
            deadline_evictions=deadline_evictions,
            membership_changes=membership_changes,
            recompiles=recompiles,
            slot_utilization=(util_active / (K * launches_run) if launches_run else 1.0),
        )

    # ------------------------------------------------------------- pricing

    def _init(self, graph: TaskGraph):
        return initial_state(graph.width, graph.payload, graph.seed,
                             device=self.runtime.device)

    def _price_deadline(self, req: Request, lp, detector: DeadlineDetector,
                        S: int, built: Tuple[float, float]) -> Optional[float]:
        """Per-request completion deadline: the explicit SLO when the
        request carries one, else factor x the priced service time
        (launches to completion x the expected launch wall: the cost
        model's via the plan's deadline_expected_us, else the detector's
        median), counted from arrival, with the part of the cohort's
        set-up (``built``: the start of its plan build and the end of its
        founders' initial states, on the clock) that the request waited
        through added. Unpriceable (analytic model, uncalibrated
        detector) means best-effort: no deadline."""
        if req.deadline_s is not None:
            return req.deadline_s
        unit = self.clock.launch_unit_s(lp, detector)
        if unit is None:
            return None
        launches = 1 + -(-(req.graph.steps - 1) // S) if req.graph.steps > 1 else 1
        setup = max(0.0, built[1] - max(req.arrival_s, built[0]))
        return req.arrival_s + setup + self.deadline_factor * launches * unit

    # ----------------------------------------------------------- admission

    @staticmethod
    def _admit_acts(acts: np.ndarray, l: int, slot: int, graph: TaskGraph,
                    S: int) -> np.ndarray:
        """Write the admitted member's local act schedule into its slot
        from launch ``l`` on, extending the horizon with all-zero launch
        rows when the request outlives the cohort's current schedule
        (all-zero rows freeze every slot, so earlier schedules are
        unchanged)."""
        need = -(-(graph.steps - 1) // S) if graph.steps > 1 else 0
        rem = acts.shape[0] - l
        if need > rem:
            pad = np.zeros((need - rem,) + acts.shape[1:], acts.dtype)
            acts = np.concatenate([acts, pad], axis=0)
            rem = need
        tloc = 1 + (np.arange(rem)[:, None] * S + np.arange(S)[None, :])
        acts[l:, slot, :] = (tloc < graph.steps).astype(acts.dtype)
        return acts

    # -------------------------------------------------------- verification

    def _oracle(self, graph: TaskGraph, eff: int, K: int, slot: int) -> np.ndarray:
        """Serial same-K oracle: the request alone, truncated to its
        effective steps, through the production ensemble executor at the
        cohort's K (see the module docstring for why same-K is the exact
        comparison)."""
        g = dataclasses.replace(graph, steps=eff)
        ck = (g, K, slot)
        if ck not in self._oracle_cache:
            out = self.runtime.execute_ensemble(GraphEnsemble((g,) * K),
                                                [self._init(g)] * K)
            self._oracle_cache[ck] = out[slot]
        return self._oracle_cache[ck]

    def _verify(self, outcomes: List[RequestOutcome], cohorts: List[CohortReport]) -> None:
        slots_of = {c.index: c.slots for c in cohorts}
        for o in outcomes:
            ref = self._oracle(o.graph, o.effective_steps, slots_of[o.cohort], o.slot)
            o.bit_identical = bool(np.array_equal(o.output, ref))
