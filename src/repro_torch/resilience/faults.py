"""Seeded, declarative fault injection for the ensemble runtime.

A copy of ``repro.resilience.faults`` over the port's transports
(``repro_torch.core.runtimes._halo``). A :class:`FaultPlan` is a frozen list
of :class:`FaultSpec` records naming WHERE a fault fires (launch index,
member slot) and WHAT it does; nothing mutable lives in the plan, so one
plan drives any number of runs and can cross a subprocess boundary as JSON.
Per-run consumption counters live in :class:`FaultState`.
``FaultPlan.random`` draws from ``numpy.random.default_rng`` exactly as the
reference does, so a seed gives the reference's plan.

Fault classes:

  transport   a halo/stride exchange fails ``times`` consecutive attempts
              at its launch site, then succeeds (the transient network
              fault). Recovered in place: capped exponential backoff +
              jitter, then retry (engine.py).
  launch      a launch raises (``mode="raise"``) or completes with poisoned
              output (``mode="poison"``, NaN-filled carry). Recovered by
              replaying the launch from the pre-launch snapshot: the same
              bits, since a launch is a deterministic function of (carry,
              act row).
  member      one ensemble member dies during a launch. Recovered by
              act-mask eviction: the launch replays from the snapshot with
              the member's (K, S) activity slot zeroed, so survivors keep
              their bits and the dead member's rows freeze at the
              pre-launch state.
  straggler   the launch completes but only after ``delay_s`` of injected
              stall: exercises the deadline detector without corrupting
              anything (detection, not recovery).

Arming: the engine runs inside ``with armed(FaultState(plan))``. The
module-level stack is what the ``chaos+<base>`` transport wrappers
(:func:`install_chaos_impls`, registered in ``_halo.TRANSPORT_REGISTRIES``)
consult when they are called: a wrapper raises
:class:`TransientTransportFault` only while a plan is armed and schedules
failures for the current site (``transport_site``). When that call happens
differs from the reference, where a wrapper runs once, at trace time: in
the port a transport runs once at capture where a run is one CUDA graph
(on the card; a replay calls no Python), and at every call on the eager
paths (the CPU, and row shards across distinct cards). The engine itself
gates each launch through :meth:`FaultState.transport_should_fail`
directly, so run-time transient faults fire at the host boundary on every
path alike.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.runtimes import _halo


class InjectedFault(RuntimeError):
    """Base class for every injected failure."""


class TransientTransportFault(InjectedFault):
    """A halo/stride exchange failed this attempt (retryable)."""


class LaunchFault(InjectedFault):
    """A launch raised at dispatch (replay from snapshot)."""


class MemberFault(InjectedFault):
    """An ensemble member died during a launch (evict its act slot)."""


class UnrecoverableFault(RuntimeError):
    """Recovery gave up: retries/replays exhausted (NOT an injected type:
    raising it means the policy's budget was genuinely spent)."""


FAULT_TRANSPORT = "transport"
FAULT_LAUNCH = "launch"
FAULT_MEMBER = "member"
FAULT_STRAGGLER = "straggler"
FAULT_KINDS = (FAULT_TRANSPORT, FAULT_LAUNCH, FAULT_MEMBER, FAULT_STRAGGLER)

LAUNCH_MODES = ("raise", "poison")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. ``launch`` indexes the launch loop (0-based,
    the t = 0 init launch excluded); ``member`` only matters for member
    faults; ``times`` only for transport (consecutive failures before the
    site heals); ``mode`` only for launch faults; ``delay_s`` only for
    stragglers."""

    kind: str
    launch: int
    member: int = 0
    times: int = 1
    mode: str = "raise"
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known {FAULT_KINDS}")
        if self.launch < 0:
            raise ValueError(f"launch index must be >= 0, got {self.launch}")
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")
        if self.kind == FAULT_LAUNCH and self.mode not in LAUNCH_MODES:
            raise ValueError(
                f"unknown launch fault mode {self.mode!r}; known {LAUNCH_MODES}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, reusable fault schedule (see module docstring)."""

    specs: Tuple[FaultSpec, ...] = ()
    #: provenance when generated by :meth:`random`
    seed: Optional[int] = None
    note: str = ""

    def __post_init__(self):
        # one fault per (kind, launch) site and one death per member:
        # overlapping schedules have no defined recovery order
        sites = [(s.kind, s.launch) for s in self.specs]
        if len(sites) != len(set(sites)):
            raise ValueError(f"duplicate fault site in plan: {sites}")
        deaths = [s.member for s in self.specs if s.kind == FAULT_MEMBER]
        if len(deaths) != len(set(deaths)):
            raise ValueError(f"member scheduled to die twice: {deaths}")

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        num_launches: int,
        num_members: int = 1,
        rate: float = 0.2,
        kinds: Sequence[str] = (FAULT_TRANSPORT, FAULT_LAUNCH, FAULT_MEMBER),
        transport_times: Sequence[int] = (1, 2),
        straggler_delay_s: float = 0.02,
    ) -> "FaultPlan":
        """Bernoulli(rate) per (launch, kind): the seeded generator the
        property tests share. At most one fault per launch site and one
        death per member (plan invariants)."""
        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        dead: set = set()
        for launch in range(max(0, num_launches)):
            for kind in kinds:
                if rng.random() >= rate:
                    continue
                if kind == FAULT_MEMBER:
                    alive = [k for k in range(num_members) if k not in dead]
                    if not alive:
                        continue
                    member = int(alive[rng.integers(len(alive))])
                    dead.add(member)
                    specs.append(FaultSpec(kind, launch, member=member))
                elif kind == FAULT_TRANSPORT:
                    times = int(transport_times[rng.integers(len(transport_times))])
                    specs.append(FaultSpec(kind, launch, times=times))
                elif kind == FAULT_LAUNCH:
                    mode = LAUNCH_MODES[int(rng.integers(len(LAUNCH_MODES)))]
                    specs.append(FaultSpec(kind, launch, mode=mode))
                else:
                    specs.append(FaultSpec(kind, launch, delay_s=straggler_delay_s))
        return cls(specs=tuple(specs), seed=seed)

    def describe(self) -> str:
        if not self.specs:
            return "no faults"
        return ", ".join(
            f"{s.kind}@L{s.launch}"
            + (f"/m{s.member}" if s.kind == FAULT_MEMBER else "")
            + (f" x{s.times}" if s.kind == FAULT_TRANSPORT else "")
            + (f" [{s.mode}]" if s.kind == FAULT_LAUNCH else "")
            for s in self.specs)

    # JSON round-trip (a subprocess boundary)

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "note": self.note,
            "specs": [dataclasses.asdict(s) for s in self.specs],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(
            specs=tuple(FaultSpec(**s) for s in d.get("specs", ())),
            seed=d.get("seed"),
            note=d.get("note", ""),
        )


class FaultState:
    """Mutable per-run consumption state for one FaultPlan: transport
    sites count down their remaining failures, one-shot faults are
    consumed exactly once (so a replayed launch reruns clean)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._transport_left: Dict[int, int] = {
            s.launch: s.times for s in plan.specs if s.kind == FAULT_TRANSPORT}
        self._pending: Dict[Tuple[str, int], FaultSpec] = {
            (s.kind, s.launch): s for s in plan.specs if s.kind != FAULT_TRANSPORT}

    def transport_should_fail(self, launch: int) -> bool:
        """Consume one scheduled transport failure at this site (True
        while the site is still failing; heals after ``times`` calls)."""
        left = self._transport_left.get(launch, 0)
        if left <= 0:
            return False
        self._transport_left[launch] = left - 1
        return True

    def take(self, kind: str, launch: int) -> Optional[FaultSpec]:
        """Consume the one-shot fault at (kind, launch), if scheduled."""
        return self._pending.pop((kind, launch), None)

    def peek(self, kind: str, launch: int) -> Optional[FaultSpec]:
        return self._pending.get((kind, launch))


# --------------------------------------------------------------- arming

#: armed FaultState stack (a stack so nested engines cannot clobber each
#: other; the top is what the chaos transport wrappers consult)
_ARMED: List[FaultState] = []

#: launch site the chaos wrappers attribute their calls to
_SITE: List[int] = [0]


def armed_state() -> Optional[FaultState]:
    return _ARMED[-1] if _ARMED else None


@contextlib.contextmanager
def armed(state: Optional[FaultState]):
    """Arm a FaultState for the dynamic extent (None = no-op, so callers
    don't branch)."""
    if state is None:
        yield None
        return
    _ARMED.append(state)
    try:
        yield state
    finally:
        _ARMED.pop()


@contextlib.contextmanager
def transport_site(launch: int):
    """Attribute chaos-wrapper transport calls inside the block to
    ``launch`` (a transport call has no launch index of its own)."""
    _SITE.append(int(launch))
    try:
        yield
    finally:
        _SITE.pop()


CHAOS_IMPL_PREFIX = "chaos+"


def _make_chaos_start(kind: str, base: str):
    def start(*args, **kw):
        st = armed_state()
        if st is not None and st.transport_should_fail(_SITE[-1]):
            raise TransientTransportFault(
                f"injected {kind} transport fault (impl chaos+{base}, "
                f"site launch {_SITE[-1]})")
        return _halo.TRANSPORT_REGISTRIES[kind][base](*args, **kw)

    start.__name__ = f"_chaos_{kind}_{base}_start"
    return start


def install_chaos_impls() -> Tuple[str, ...]:
    """Register ``chaos+<base>`` wrappers for every production transport in
    each registry (idempotent). A wrapper delegates to its base impl after
    consulting the armed plan: selecting ``halo_impl="chaos+xla"`` (or
    ``gather_impl=``) on a runtime injects transport faults without
    touching any call site. Returns the wrapper names now registered."""
    names: List[str] = []
    for kind, registry in _halo.TRANSPORT_REGISTRIES.items():
        for base in [n for n in list(registry) if not n.startswith(CHAOS_IMPL_PREFIX)]:
            name = CHAOS_IMPL_PREFIX + base
            if name not in registry:
                _halo.register_transport_impl(kind, name, _make_chaos_start(kind, base))
            names.append(name)
    return tuple(sorted(set(names)))
