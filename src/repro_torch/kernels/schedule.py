"""Launch-depth policy for ``pallas_step``: the ``steps_per_launch`` option,
the "auto" depth tuner, plan ranking and launch deadlines.

Counterpart of ``repro.kernels.schedule``. Temporal blocking (K4,
``steps_per_launch=S``) trades residency for launch amortization: a serial
blocked launch works on ``block + 2*S*radius`` rows, a pipelined one on an
interior program (``block`` rows) and a boundary program (``6*S*radius``
rows). The right S is a function of the shape, so this module owns that
policy, and the runtime, the benchmarks and the tests agree on one rule.

``steps_per_launch`` runtime option values:

  1 / None        single-step launches (the default)
  "auto" / 0      the deepest candidate whose launch fits (and, when
                  pipelining, whose interior covers the exchange)
  any int > 1     explicit depth, clamped to the graph's combine-step count

The policy is the reference's, line for line: `CANDIDATES`, the covers
and pays-off rules (`pipeline_interior_covers_exchange`,
`gathered_pays_off`), the plan ranking (`gathered_beats_strides`), the
choosers' deepest-first walk, the gather transport and chunk-group
choosers (`choose_gather_impl`, `choose_gather_chunk_group`), the
(row, member) split (`choose_member_shards`) and the deadlines
(`expected_launch_wall_us`, `launch_deadline_us`); the reason strings are
the reference's too, and so is the decision record a traced run carries
(`record_resolution`). Every rule is priced against a cost model
(``kernels/probes.py``'s `CostModel`): resolvers take ``model=``, and None
resolves the default (env constant > cached probe calibration > analytic
fallback). The model decides which
schedule runs, never what it computes.

What differs is the fit rule. The reference sizes a depth against a TPU
core's VMEM budget, with payloads padded to 128 lanes; those are facts of
the TPU. Here the choosers take a ``fits`` predicate instead, and the
runtime passes the card's rules. Whether a launch can run says nothing,
since K4's cooperative form runs at any size; what matters is the form's
cost per depth. The halo plan: a depth fits when every K4 launch the
runtime would make at it takes K4's tiled form
(``taskbench_step.blocked_plan`` finds a cut under ``bodies.SMEM_LIMIT``),
so the memory body never fits there and "auto" resolves it to one step a
launch. The all-gather plan: a depth fits when its K4 launch takes the
tiled or the resident form (``taskbench_step.blocked_form``: one cluster a
column slice holds the whole gathered buffer in shared memory for all S
depths, the card's counterpart of "the buffer fits VMEM"), so its
time-varying tables and its radius-less launch fit, and the memory body
does not.

``DEFAULT_GATHER_WIDTH_CAP`` is the reference's: the widest state the
all-gather plan takes by default. Its value comes from a TPU core's VMEM;
it is kept for parity with the reference's plan dispatch, and the
``gather_width_cap`` runtime option overrides it.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple, Union

#: Depths the auto-tuner considers (deepest first), the reference's.
CANDIDATES = (16, 8, 4, 2, 1)

#: The analytic model's exchange cost: one deep exchange costs about as
#: much wall as this many row-steps (a row-step = one working row advanced
#: one depth). The reference's hand calibration, kept as the analytic
#: fallback; a measured model (``python -m repro_torch.kernels.probes``)
#: replaces it, and so does ``REPRO_PIPELINE_EXCHANGE_ROW_STEPS``. Used
#: only to rank "auto" candidates, never to forbid an explicit S.
PIPELINE_EXCHANGE_ROW_STEPS = 512

_EXCHANGE_ROW_STEPS_ENV = "REPRO_PIPELINE_EXCHANGE_ROW_STEPS"

#: Widths at or below this run the all-gather plan by default (the
#: ``gather_width_cap`` runtime option overrides it per run). A TPU-derived
#: value, kept for parity; see the module docstring.
DEFAULT_GATHER_WIDTH_CAP = 512

#: The halo chooser's fit rule: ``fits(S, pipelined)``, whether the launch
#: of depth S on the serial (False) or pipelined (True) schedule fits.
HaloFit = Callable[[int, bool], bool]
#: The all-gather chooser's fit rule: ``fits(S)``.
GatherFit = Callable[[int], bool]


def is_auto(value: Union[int, str, None]) -> bool:
    """Whether a ``steps_per_launch`` value delegates the depth choice to
    the tuner (the reference's spellings: "auto", 0, "0")."""
    return value in ("auto", 0, "0")


def _resolve_model(model):
    """``model=None`` -> the default CostModel (env > cached probes >
    analytic; see probes.default_cost_model)."""
    if model is None:
        from repro_torch.kernels import probes

        return probes.default_cost_model()
    return model


def record_resolution(tracer, *, plan: str, steps_per_launch: int,
                      pipeline: bool, model=None, reason: str = "",
                      **attrs) -> None:
    """Emit one decision record for a completed schedule resolution: the
    ``schedule.resolve`` instant span (the reference's record, key for key)
    with the plan kind, the chosen S, whether the pipelined form runs,
    which cost model backed the ranking (its description, source and
    exchange constant) and the resolver's reason. A null or absent tracer
    makes it a no-op, so the resolvers cost nothing with tracing off."""
    if tracer is None or not getattr(tracer, "enabled", False):
        return
    m = _resolve_model(model)
    tracer.instant(
        "schedule.resolve",
        plan=plan,
        steps_per_launch=int(steps_per_launch),
        pipeline=bool(pipeline),
        cost_model=m.describe(),
        cost_model_source=m.source,
        exchange_row_steps=float(m.exchange_row_steps),
        reason=reason or "structural",
        **attrs,
    )


def exchange_row_steps(model=None):
    """The exchange cost in row-steps under ``model``; with no model the
    default is re-resolved per call, and an invalid env value raises."""
    return _resolve_model(model).exchange_row_steps


def pipeline_interior_covers_exchange(
    block: int, radius: int, steps_per_launch: int, model=None
) -> bool:
    """Whether the pipelined split pays for itself at this (block, S).

    Two conditions, both in row-steps against the model's exchange cost
    X = exchange_row_steps(model):

      covers:   ``S * (block - 2*S*r) >= X + 2*S*r`` — the interior phase
                must be long enough to hide one deep exchange. An empty
                interior can cover nothing.
      pays off: ``6 * S**2 * r <= X`` — the boundary phase's extra work per
                launch (a 6*S*r-row buffer advanced S depths) must not
                exceed the exchange it helps hide.

    A measured one-device model has X = 1 (its exchange is free), so no
    depth pays off and "auto" runs the serial schedule.
    """
    depth = steps_per_launch * radius
    interior_rows = block - 2 * depth
    if interior_rows <= 0:
        return False
    X = exchange_row_steps(model)
    covers = steps_per_launch * interior_rows >= X + 2 * depth
    pays_off = 6 * steps_per_launch * depth <= X
    return covers and pays_off


def choose_steps_per_launch(
    *,
    block: int,
    radius: int,
    fits: HaloFit,
    total_steps: Optional[int] = None,
    candidates: Sequence[int] = CANDIDATES,
    pipeline: bool = False,
    model=None,
) -> int:
    """Deepest candidate S whose blocked launch fits (``fits(S, pipelined)``).

    S is capped at the graph's combine-step count (``total_steps - 1``).
    With ``pipeline`` the deepest candidate whose interior covers the
    exchange AND whose pipelined launch fits wins; if none covers, the
    runtime runs the SERIAL schedule at whatever depth is returned, so the
    fallback is the deepest candidate that fits serially: each candidate is
    held to the schedule it would execute. No candidate fits -> 1.
    """
    model = _resolve_model(model)  # once per choice, not per candidate
    cap = max(1, total_steps - 1) if total_steps and total_steps > 1 else None
    best_fit = None
    for s in sorted(set(int(c) for c in candidates), reverse=True):
        if s < 1:
            continue
        if cap is not None and s > cap:
            continue
        if pipeline and pipeline_interior_covers_exchange(
                block, radius, s, model):
            if fits(s, True):
                return s
            continue  # pipelined at this depth would not fit; go shallower
        if best_fit is None and fits(s, False):
            if not pipeline:
                return s
            best_fit = s
    return best_fit if best_fit is not None else 1


def _resolve_depth(value, chooser: Callable[[], int],
                   total_steps: Optional[int]) -> int:
    """THE ``steps_per_launch`` option shell, shared by every plan: None/1
    -> per-step, "auto" -> the plan's chooser, explicit ints validated and
    clamped to the combine-step count (deeper than the run is all masked
    tail)."""
    if value in (None, 1):
        return 1
    if is_auto(value):
        return chooser()
    s = int(value)
    if s < 1:
        raise ValueError(f"steps_per_launch must be >= 1 or 'auto', got {value!r}")
    if total_steps and total_steps > 1:
        s = min(s, total_steps - 1)
    return s


def resolve_steps_per_launch(
    value: Union[int, str, None],
    *,
    block: int,
    radius: int,
    fits: HaloFit,
    total_steps: Optional[int] = None,
    pipeline: bool = False,
    model=None,
) -> int:
    """Turn the ``steps_per_launch`` runtime option into a concrete S for
    the halo plan."""
    return _resolve_depth(
        value,
        lambda: choose_steps_per_launch(
            block=block, radius=radius, fits=fits, total_steps=total_steps,
            pipeline=pipeline, model=model),
        total_steps,
    )


# ---------------------------------------------------------------------------
# Stride / all-gather plans
#
#   stride     per-step XOR exchanges (butterfly); per step by construction,
#              blocked requests route to the all-gather plan instead.
#   allgather  one full-state gather per launch; every row of the gathered
#              buffer advances exactly; blocking trades replicated compute
#              for 1/S as many gathers (``gathered_pays_off``).


def gathered_pays_off(width: int, block: int, steps_per_launch: int,
                      model=None) -> bool:
    """Whether a blocked gathered launch beats per-step gathers at this S.

    Per launch the plan saves S - 1 collectives, worth ``(S-1) * X``
    row-steps; it pays ``S * (W - B)`` replicated row-steps. On one device
    W == B: replication is free and any depth pays (blocking is then pure
    launch amortization).
    """
    if steps_per_launch <= 1:
        return False
    return (steps_per_launch * (width - block)
            <= (steps_per_launch - 1) * exchange_row_steps(model))


def choose_steps_per_launch_gathered(
    *,
    width: int,
    block: int,
    fits: GatherFit,
    total_steps: Optional[int] = None,
    candidates: Sequence[int] = CANDIDATES,
    model=None,
) -> int:
    """Deepest candidate S that pays off AND fits (``fits(S)``) for the
    gathered plan, capped at the graph's combine-step count. No candidate
    clearing both -> 1 (the per-step schedule; for butterfly that is the
    stride plan)."""
    model = _resolve_model(model)
    cap = max(1, total_steps - 1) if total_steps and total_steps > 1 else None
    for s in sorted(set(int(c) for c in candidates), reverse=True):
        if s <= 1:
            continue
        if cap is not None and s > cap:
            continue
        if not gathered_pays_off(width, block, s, model):
            continue
        if fits(s):
            return s
    return 1


def resolve_steps_per_launch_gathered(
    value: Union[int, str, None],
    *,
    width: int,
    block: int,
    fits: GatherFit,
    total_steps: Optional[int] = None,
    model=None,
) -> int:
    """``steps_per_launch`` -> concrete S for the all-gather plan: explicit
    depths through the shared shell; "auto" delegates to
    ``choose_steps_per_launch_gathered``."""
    return _resolve_depth(
        value,
        lambda: choose_steps_per_launch_gathered(
            width=width, block=block, fits=fits, total_steps=total_steps,
            model=model),
        total_steps,
    )


def gathered_beats_strides(
    *,
    width: int,
    block: int,
    steps_per_launch: int,
    off_block_strides: int,
    period: int,
    model,
    impl: str = "xla",
) -> Tuple[bool, str]:
    """Rank the butterfly plans: blocked ALLGATHER vs per-step STRIDE.

    Ranking two plans needs ABSOLUTE walls, which only a measured model
    carries; the analytic fallback always answers (False, why). Per-timestep
    amortized walls, in microseconds:

      stride:    ``launch + (off/period) * stride_us``
      allgather: ``(launch + gather_us(W)) / S + (W - B) * row_step_us``

    Returns (verdict, reason) with the reason naming the measured numbers.
    """
    model = _resolve_model(model)
    if not getattr(model, "can_rank_plans", False):
        return False, (
            f"plan ranking needs a measured model; verdict source: "
            f"{model.describe()}")
    stride_us = model.stride_us_for(impl)
    if off_block_strides > 0 and stride_us is None:
        return False, (
            f"no measured stride-exchange cost for impl {impl!r}; "
            f"verdict source: {model.describe(width)}")
    S = max(1, int(steps_per_launch))
    gather_us = model.gather_us_at(width)
    stride_cost = model.launch_us + (
        (off_block_strides / max(1, period)) * (stride_us or 0.0))
    gather_cost = ((model.launch_us + gather_us) / S
                   + (width - block) * model.row_step_us)
    verdict = gather_cost < stride_cost
    reason = (
        f"measured: stride-plan step {stride_cost:.1f}us vs gathered "
        f"step {gather_cost:.1f}us at S={S} "
        f"(launch={model.launch_us:.1f}us, "
        f"stride={0.0 if stride_us is None else stride_us:.1f}us x "
        f"{off_block_strides}/{max(1, period)} slots, "
        f"gather={gather_us:.1f}us@w{width}, "
        f"replication={width - block} rows x "
        f"{model.row_step_us:.3f}us)")
    return verdict, reason


#: below this device count a single rendezvous is already minimal and the
#: chunked gather's second stage is pure overhead; at or above it the two
#: ~sqrt(D)-party segment gathers win structurally (the reference's rule)
DEFAULT_CHUNKED_GATHER_MIN_DEVICES = 16


def choose_gather_impl(*, width: int, devices: int,
                       model=None) -> Tuple[str, str]:
    """Rank the gather_global transports at (devices, width).

    Every gather transport moves exact row copies, so the choice is one of
    cost alone. A measured model with the devices-dimension gather probes
    (``gather_impl_us``) ranks by the interpolated walls at this exact (D,
    W), the "chunked:gG" grouping keys left out (they rank the chunk group,
    `choose_gather_chunk_group`); otherwise the structural rule applies:
    "chunked" at D >= DEFAULT_CHUNKED_GATHER_MIN_DEVICES, "xla" below.
    Returns (impl, reason), the reason naming the numbers."""
    if devices <= 2:
        return "xla", (f"{devices} device(s): one rendezvous is already "
                       f"minimal, nothing to chunk")
    model = _resolve_model(model)
    walls = {}
    if getattr(model, "gather_walls_at", None) is not None:
        walls = model.gather_walls_at(width, devices) or {}
    walls = {k: v for k, v in walls.items() if ":" not in k}
    if len(walls) >= 2:
        impl = min(walls, key=walls.get)
        detail = ", ".join(
            f"{k}={v:.1f}us" for k, v in sorted(walls.items()))
        return impl, (f"measured gather walls at D={devices}, "
                      f"W={width}: {detail}")
    if devices >= DEFAULT_CHUNKED_GATHER_MIN_DEVICES:
        return "chunked", (
            f"structural: D={devices} >= "
            f"{DEFAULT_CHUNKED_GATHER_MIN_DEVICES}, two ~sqrt(D)-party "
            f"segment gathers beat one {devices}-wide rendezvous "
            f"(no measured devices-dimension probes to overrule)")
    return "xla", (
        f"structural: D={devices} < "
        f"{DEFAULT_CHUNKED_GATHER_MIN_DEVICES}, monolithic all-gather "
        f"(no measured devices-dimension probes to overrule)")


_GATHER_CHUNK_GROUP_ENV = "REPRO_GATHER_CHUNK_GROUP"


def choose_gather_chunk_group(*, devices: int, width: Optional[int] = None,
                              model=None,
                              explicit: Optional[int] = None
                              ) -> Tuple[int, str]:
    """The chunked gather's segment size G at (devices, width).

    The two-stage gather splits D shards into D/G segments of G; every G
    that divides D gives the same bits, so G is a choice of cost alone.
    Precedence: ``explicit`` > the ``REPRO_GATHER_CHUNK_GROUP`` env > the
    measured grouping walls at this exact (D, W) (``gather_impl_us`` keys
    "chunked:g{G}", at least two candidates to rank) > the analytic rule,
    the divisor of D nearest sqrt(D) (``_halo.gather_chunk_group``). An
    explicit or env G that does not divide D is refused loudly. Returns
    (group, reason)."""
    def _validated(value, origin: str) -> int:
        try:
            g = int(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"{origin} chunk group {value!r} is not an integer")
        if g < 1 or devices % g:
            raise ValueError(
                f"{origin} chunk group {g} does not divide D={devices} "
                f"(the two-stage segment gather needs G | D)")
        return g

    if explicit is not None:
        g = _validated(explicit, "explicit")
        return g, f"explicit chunk group G={g}"
    raw = os.environ.get(_GATHER_CHUNK_GROUP_ENV)
    if raw is not None and raw.strip():
        g = _validated(raw.strip(), f"env {_GATHER_CHUNK_GROUP_ENV}")
        return g, f"env {_GATHER_CHUNK_GROUP_ENV}={g}"
    model = _resolve_model(model)
    if width is not None and getattr(model, "gather_walls_at", None):
        walls = model.gather_walls_at(width, devices) or {}
        grouped = {}
        for impl, us in walls.items():
            if not impl.startswith("chunked:g"):
                continue
            try:
                g = int(impl.split(":g", 1)[1])
            except ValueError:
                continue
            if 1 < g < devices and devices % g == 0:
                grouped[g] = us
        if len(grouped) >= 2:
            best = min(grouped, key=lambda g: (grouped[g], g))
            detail = ", ".join(
                f"g{g}={us:.1f}us" for g, us in sorted(grouped.items()))
            return best, (f"measured chunked-gather grouping walls at "
                          f"D={devices}, W={width}: {detail}")
    from repro_torch.core.runtimes import _halo

    g = _halo.gather_chunk_group(devices)
    return g, (f"analytic: divisor of D={devices} nearest sqrt(D) -> G={g} "
               f"(no measured grouping probes at this D, W to overrule)")


def choose_member_shards(*, devices: int, num_members: int, width: int,
                         steps_per_launch: int = 1, radius: int = 1,
                         model=None) -> Tuple[int, str]:
    """Price the (Dr, Dk) split of the 2D (row, member) mesh
    (``launch/mesh.py``) for a stacked ensemble of ``num_members`` members.

    A shard's compute does not depend on the split, (K/Dk) members x (W/Dr)
    rows = K*W/D rows whatever it is, so the split is priced on its
    exchanges alone: sharding K divides every deep-halo exchange's rows by
    Dk, and the longer blocks W/Dr cut the hops ceil(S*r / B). Candidates
    are the common divisors Dk of (devices, num_members) that keep a row
    ring (Dr = devices/Dk >= 2) and W % Dr == 0. A measured model prices
    each as

      hops(Dk) * min(halo_exchange_us) + (K/Dk) * 2*S*r * row_step_us

    and the cheapest wins; under the analytic model Dk = 1 is kept (the
    replicated 1D row mesh). Returns (Dk, reason), the reference's."""
    depth = max(1, int(steps_per_launch)) * max(0, int(radius))
    candidates = []
    for dk in range(1, min(devices, num_members) + 1):
        if devices % dk or num_members % dk:
            continue
        dr = devices // dk
        if dr < 2 and devices > 1:
            continue
        if width % dr:
            continue
        candidates.append(dk)
    if not candidates or candidates == [1]:
        return 1, (f"no viable (Dr, Dk) split: D={devices}, K={num_members} "
                   f"share no divisor keeping Dr >= 2 and W % Dr == 0")
    model = _resolve_model(model)
    halo_us = getattr(model, "halo_exchange_us", None) or {}
    row_step_us = getattr(model, "row_step_us", None)
    launch_us = getattr(model, "launch_us", None)
    if not halo_us or row_step_us is None or launch_us is None:
        return 1, ("member-shard pricing needs a measured model; "
                   f"verdict source: {model.describe()} — keeping the "
                   "replicated 1D row mesh")
    ex_us = min(halo_us.values())

    def price(dk: int) -> float:
        block = width // (devices // dk)
        hops = max(1, -(-depth // max(1, block)))
        return hops * ex_us + (num_members / dk) * 2 * depth * row_step_us

    best = min(candidates, key=price)
    return best, (
        f"measured: Dk={best} prices {price(best):.1f}us/launch vs "
        f"Dk=1 at {price(1):.1f}us "
        f"(exchange={ex_us:.1f}us, row-step={row_step_us:.3f}us, "
        f"depth={depth}, K={num_members}, D={devices})")


# --------------------------------------------------------------- deadlines

#: deadline = DEADLINE_FACTOR x the model's expected launch wall. Generous on
#: purpose: a missed straggler costs one late launch, a false positive
#: flags healthy work, and detection only reports.
DEADLINE_FACTOR = 8.0


def expected_launch_wall_us(
    *,
    rows: int,
    steps_per_launch: int,
    model=None,
    impl: str = "xla",
    gather_width: Optional[int] = None,
) -> Optional[float]:
    """The cost model's expected wall of ONE blocked launch, in us.

    ``rows`` is the working-row count (K x block for a stacked ensemble).
    Priced as launch dispatch + rows x S row-steps + one transport (a deep
    halo exchange, or a full-state gather when ``gather_width`` names the
    all-gather plan's width). Only a MEASURED model carries absolute walls;
    analytic/env models return None and the caller self-calibrates from
    observed walls instead (``resilience.detect.DeadlineDetector``)."""
    model = _resolve_model(model)
    launch_us = getattr(model, "launch_us", None)
    row_step_us = getattr(model, "row_step_us", None)
    if launch_us is None or row_step_us is None:
        return None
    us = launch_us + rows * max(1, steps_per_launch) * row_step_us
    if gather_width is not None:
        g = model.gather_us_at(gather_width)
        if g is not None:
            us += g
    elif model.halo_exchange_us:
        us += model.halo_exchange_us.get(
            impl, min(model.halo_exchange_us.values()))
    return us


def launch_deadline_us(
    *,
    rows: int,
    steps_per_launch: int,
    model=None,
    impl: str = "xla",
    gather_width: Optional[int] = None,
    factor: float = DEADLINE_FACTOR,
) -> Optional[float]:
    """``factor`` x the expected launch wall (the straggler deadline), or
    None when the model cannot price one (see expected_launch_wall_us)."""
    expected = expected_launch_wall_us(
        rows=rows, steps_per_launch=steps_per_launch, model=model,
        impl=impl, gather_width=gather_width)
    return None if expected is None else factor * expected
