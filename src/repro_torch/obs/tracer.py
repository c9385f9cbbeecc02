"""Low-overhead span recorder for runtime telemetry.

Counterpart of ``repro.obs.tracer``, a copy: the module uses no framework,
and the port keeps its own. The paper's contribution is *quantifying* where a runtime spends time;
this module is the in-process evidence source. A :class:`Tracer` records
nested :class:`Span` intervals with monotonic microsecond timestamps and
a category tag from the fixed taxonomy:

  dispatch           host work issuing device programs (per launch / step /
                     task — the quantity `serialized` maximizes)
  exchange           halo / stride transport walls (tagged with impl+depth)
  compute.boundary   the pipelined boundary phase (2*S*r edge rows)
  compute.interior   interior / whole-block kernel walls
  gather             full-state all-gather walls (the allgather plan)
  fault              fault handling: detection, retry/backoff sleeps, launch
                     replays, evictions (the resilience engine) — the recovery
                     tax, attributed like any other wall so a faulted run's
                     decomposition shows exactly where recovery spent time
  idle               wall not covered by any recorded span (derived by
                     decompose.py, but recordable explicitly too)

Two non-wall categories exist for structured records:

  launch             a COMPOSITE interval — one pipelined launch whose
                     boundary/exchange/interior phases ran concurrently
                     (on the card: the boundary K4 on the shard's stream,
                     the edge exchange on the transfer streams, the
                     interior K4 beside them; timing each phase alone
                     would serialize the very overlap being measured).
                     decompose.py apportions these using probe spans.
  decision           zero-length records (scheduler verdicts etc.); their
                     attrs are the payload, they carry no wall.

Tracing is OFF by default: runtimes hold the shared :data:`NULL_TRACER`,
whose ``span()`` returns one reusable no-op context (no allocation, no
timestamp); ``tests/test_torch_obs.py`` checks that structure.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple, Union

#: The attribution taxonomy (every microsecond of wall lands in one).
CATEGORIES = (
    "dispatch",
    "exchange",
    "compute.boundary",
    "compute.interior",
    "gather",
    "fault",
    "idle",
)

#: Wall category for fault detection/recovery work (the resilience engine).
CAT_FAULT = "fault"

#: Composite interval: one pipelined launch, phases fused in-program.
CAT_LAUNCH = "launch"
#: Zero-length structured record (scheduler decisions etc.).
CAT_DECISION = "decision"

_KNOWN = set(CATEGORIES) | {CAT_LAUNCH, CAT_DECISION}


@dataclasses.dataclass
class Span:
    """One recorded interval. Timestamps are microseconds on the
    ``time.perf_counter`` monotonic clock (comparable within a process,
    meaningless across processes)."""

    name: str
    category: str
    start_us: float
    end_us: float
    depth: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_us(self) -> float:
        return self.end_us - self.start_us


class _SpanCtx:
    """Context manager for one enabled span (kept tiny: two clock reads
    plus one list append per span)."""

    __slots__ = ("_tr", "_name", "_category", "_attrs", "_start")

    def __init__(self, tr: "Tracer", name: str, category: str, attrs):
        self._tr = tr
        self._name = name
        self._category = category
        self._attrs = attrs

    def __enter__(self) -> "_SpanCtx":
        self._tr._depth += 1
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        tr = self._tr
        tr._depth -= 1
        tr.spans.append(Span(self._name, self._category,
                             self._start * 1e6, end * 1e6,
                             tr._depth, self._attrs))
        return False


class Tracer:
    """Records spans. One instance per traced runtime / run."""

    enabled = True

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._depth = 0

    @staticmethod
    def now_us() -> float:
        return time.perf_counter() * 1e6

    def span(self, name: str, category: str, **attrs) -> _SpanCtx:
        """Context manager recording [enter, exit] under ``category``."""
        if category not in _KNOWN:
            raise ValueError(
                f"unknown span category {category!r}; known: {sorted(_KNOWN)}")
        return _SpanCtx(self, name, category, attrs)

    def add(self, name: str, category: str, start_us: float, end_us: float,
            **attrs) -> None:
        """Record an interval with explicit timestamps (e.g. a probe wall
        measured around someone else's timing loop)."""
        if category not in _KNOWN:
            raise ValueError(
                f"unknown span category {category!r}; known: {sorted(_KNOWN)}")
        self.spans.append(Span(name, category, start_us, end_us,
                               self._depth, attrs))

    def instant(self, name: str, **attrs) -> None:
        """Zero-length decision record; ``attrs`` are the payload."""
        t = self.now_us()
        self.spans.append(Span(name, CAT_DECISION, t, t, self._depth, attrs))

    def clear(self) -> None:
        self.spans.clear()
        self._depth = 0


class _NullSpanCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CTX = _NullSpanCtx()


class NullTracer:
    """The disabled fast path: every call is a no-op and ``span()`` returns
    ONE preallocated context — no allocation, no clock read. ``__slots__``
    is empty so the instance cannot even grow state by accident."""

    __slots__ = ()
    enabled = False
    spans: Tuple[Span, ...] = ()

    def span(self, name: str, category: str, **attrs) -> _NullSpanCtx:
        return _NULL_CTX

    def add(self, *a, **k) -> None:
        return None

    def instant(self, *a, **k) -> None:
        return None

    def clear(self) -> None:
        return None

    @staticmethod
    def now_us() -> float:
        return 0.0


#: The shared disabled tracer (runtimes default to this).
NULL_TRACER = NullTracer()

TracerLike = Union[Tracer, NullTracer]


def coerce_tracer(opt) -> TracerLike:
    """The ``trace=`` runtime option -> a tracer.

    None/False (default)  -> NULL_TRACER (provably near-zero cost)
    True / "on" / 1       -> a fresh Tracer
    a Tracer/NullTracer   -> itself (callers share one recorder)
    """
    if opt is None or opt is False:
        return NULL_TRACER
    if isinstance(opt, (Tracer, NullTracer)):
        return opt
    if opt is True or opt == 1 or (isinstance(opt, str)
                                   and opt.lower() in ("on", "true", "1")):
        return Tracer()
    raise ValueError(f"cannot interpret trace option {opt!r}: use "
                     f"True/False, 'on', or a Tracer instance")
