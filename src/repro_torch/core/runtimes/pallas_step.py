"""`pallas_step` runtime — fused megakernel launches, temporally blockable,
on one GPU.

Counterpart of ``repro.core.runtimes.pallas_step`` for the halo plan on one
device. At the default schedule (``steps_per_launch`` unset or 1) each
timestep is one launch of the single-step megakernel K3
(``kernels/taskbench_step.py``): gather the dependency rows of the
previous state, take their masked mean and run the grain body, in one
kernel. The loop is an eager Python loop on the device.

Dataflow: with one device the whole width is one block, and the reference's
ring halo exchange becomes a wrap of the state onto itself: the extended
source holds global rows [-H, W + H) mod W (H = the pattern's halo
radius), which also keeps ``nearest`` with W <= 2r (dependencies more than
one ring away) exact. The megakernel combines from that extended source
through host-built (idx, wgt) operands, weights pre-normalized to 1 / live
count and zero-dependency rows self-padded.

Temporal blocking (``steps_per_launch=S > 1``, an int): after the t = 0
body-only K3 launch, the loop makes ceil((T-1)/S) launches of the blocked
megakernel K4, each S timesteps on a buffer wrapped S*H rows deep per side,
whose valid span shrinks by H rows per side per depth; the owned rows are
sliced out after each launch. Per-row weight tables (and, for gather /
onehot, signed offsets rebased onto the buffer) are wrapped once per run.
The final launch carries a masked tail (the (L, S) act schedule). S is
clamped to T - 1, as the reference clamps an explicit depth.

Pipelined schedule (``pipeline=True``, the default, when the block keeps
an interior: W > 2*S*H): each blocked launch splits into a boundary phase
(both 3*S*H-row edge buffers stacked into one K4 launch) and an interior
phase (the owned block, one K4 launch). On one device the next launch's
edge exchange is a self-wrap of the boundary outputs, so what can overlap
is the two phases themselves: the interior runs on a second CUDA stream,
ordered by events. ``pipeline=False`` is the serial ablation; both give the
same bits.

Options: ``combine`` = "window" (default; shifted-row sums, no gather),
"gather" or "onehot" (the ablations); ``steps_per_launch`` = 1 or an int
> 1 ("auto" raises NotImplementedError until the scheduler is ported,
ROADMAP Queue 1 item 7); ``pipeline`` = True or False. The stride plan
(fft, tree) and the all-gather plan (all_to_all, spread) are ROADMAP
Queue 1 item 5; those patterns run on the ``fused`` backend meanwhile.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import patterns as _patterns
from repro_torch.core.graph import TaskGraph
from repro_torch.core.runtimes.base import Runtime, register
from repro_torch.kernels import ops as _kops
from repro_torch.kernels.taskbench_step import (
    WEIGHT_ACCUM_DTYPE,
    finalize_weights,
    prepare_step_operands,
)

PLAN_HALO = "halo"
COMBINE_OPTIONS = ("window", "gather", "onehot")
AUTO_NOT_PORTED = (
    "steps_per_launch='auto' needs the scheduler and cost model "
    "(kernels/schedule.py, kernels/probes.py), which are not ported yet: "
    "ROADMAP.md, Queue 1 item 7; pass an int depth")


def _ext_dep_operands(
    graph: TaskGraph, block: int, halo: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(W, D) idx/wgt into the halo-extended local block, for one timestep.

    Local row i of a block starting at global row p0 gathers from an
    extended buffer ext = [p0-halo .. p0+B-1+halo] (mod W), so dependency q
    of global row p maps to extended position (p mod B) + halo + o where o
    is q's signed window offset from p. Halo patterns have period 1, so ONE
    slice serves every timestep t >= 1.
    """
    r = _patterns.halo_radius(graph)
    if r < 0:
        raise ValueError(f"{graph.pattern} is not halo-expressible")
    if graph.period != 1:
        raise ValueError(f"halo pattern {graph.pattern} must have period 1")
    W = graph.width

    def to_ext(p: int, q: int) -> int:
        for o in range(-r, r + 1):
            if (p + o) % W == q:
                return p % block + halo + o
        raise ValueError(f"dep {q} of point {p} outside halo radius {r}")

    ext_lists: List[List[int]] = [
        [to_ext(p, q) for q in graph.dependencies(1, p)] for p in range(W)
    ]
    selfs = [p % block + halo for p in range(W)]
    return prepare_step_operands(ext_lists, W, selfs)


def _rel_dep_operands(graph: TaskGraph) -> Tuple[np.ndarray, np.ndarray]:
    """(W, D) SIGNED-offset operands for the temporal-blocked gather modes.

    Row p's dependency q is stored as its window offset o (q == (p+o) mod
    W), not an absolute buffer position: offsets are a property of the
    global row alone, so the tables wrap like state and convert to absolute
    working-buffer rows with one ``+ arange(M)`` (`_rebase_rows`). Zero-dep
    rows self-pad at offset 0.
    """
    r = _patterns.halo_radius(graph)
    if r < 0 or graph.period != 1:
        raise ValueError(f"{graph.pattern} is not halo-expressible")
    W = graph.width
    rel_lists: List[List[int]] = []
    for p in range(W):
        offs: List[int] = []
        for q in graph.dependencies(1, p):
            for o in range(-r, r + 1):
                if (p + o) % W == q:
                    offs.append(o)
                    break
            else:
                raise ValueError(f"dep {q} of point {p} outside halo {r}")
        rel_lists.append(offs)
    return prepare_step_operands(rel_lists, W, [0] * W)


def _self_operands(width: int, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """(W, 1) identity operands (t=0: body only, src = raw local block)."""
    selfs = [p % block for p in range(width)]
    return prepare_step_operands([[] for _ in range(width)], width, selfs)


def _window_operands(
    graph: TaskGraph, halo: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(W, 2*halo+1) per-offset combine weights for the window kernel mode.

    Column halo + o carries the (pre-normalized) weight of the dependency
    at window offset o. Edge clipping (stencil_1d, dom), the per-row keep
    set (random_nearest), duplicate window wraps (nearest with W <= 2r)
    and the zero-dep self-keep rule are all encoded in the weights; idx is
    unused in this mode (returned as a (W, 1) column of zeros).
    """
    r = _patterns.halo_radius(graph)
    if r < 0 or graph.period != 1:
        raise ValueError(f"{graph.pattern} is not window-expressible")
    W = graph.width
    D = 2 * halo + 1
    idx = np.zeros((W, 1), dtype=np.int32)
    wgt = np.zeros((W, D), dtype=WEIGHT_ACCUM_DTYPE)
    for p in range(W):
        deps = graph.dependencies(1, p)
        if not deps:
            wgt[p, halo] = 1.0  # zero deps: keep own state (self weight 1)
            continue
        share = 1.0 / len(deps)
        for q in deps:
            for o in range(-r, r + 1):
                if (p + o) % W == q:
                    wgt[p, halo + o] += share
                    break
            else:
                raise ValueError(f"dep {q} of point {p} outside halo {r}")
    return idx, finalize_weights(wgt)


def _extend_rows(width: int, halo: int) -> np.ndarray:
    """Global rows of the halo-extended source, [-halo, width + halo) mod
    width: the one-device ring exchange, exact at any depth."""
    return np.arange(-halo, width + halo) % width


def _extend_state(s: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    """Halo-extend a stacked (K, W, payload) state; identity at halo 0."""
    return s if rows is None else s.index_select(1, rows)


def _wrap(x: torch.Tensor, depth: int, row_axis: int) -> torch.Tensor:
    """x extended by ``depth`` rows per side along ``row_axis``, wrapped
    (the one-device ring exchange, multi-hop included)."""
    rows = torch.from_numpy(_extend_rows(x.shape[row_axis], depth))
    return x.index_select(row_axis, rows.to(x.device))


def _rebase_rows(rel: torch.Tensor, *, row_axis: int = 0) -> torch.Tensor:
    """Signed window offsets -> absolute rows of THIS working buffer
    (``+ arange(M)``, clipped; the clip only ever binds on edge-garbage
    rows, which are never consumed by valid rows)."""
    m = rel.shape[row_axis]
    shape = [1] * rel.ndim
    shape[row_axis] = m
    rows = torch.arange(m, dtype=torch.int32, device=rel.device).reshape(shape)
    return (rel + rows).clamp(0, m - 1)


def _extend_tables(idx: torch.Tensor, wgt: torch.Tensor, depth: int,
                   mode: str, *, row_axis: int = 0):
    """Wrap the per-row operand tables ONCE for a serial blocked run.

    Weights (per global row, depth-invariant) extend exactly like state.
    Gather/onehot offset tables additionally rebase from signed offsets to
    absolute working-buffer rows (`_rebase_rows`). Window mode returns idx
    untouched (the kernel reads no idx).
    """
    wext = _wrap(wgt, depth, row_axis)
    if mode == "window":
        return idx, wext
    return _rebase_rows(_wrap(idx, depth, row_axis), row_axis=row_axis), wext


class _PhaseTables(NamedTuple):
    """Per-phase operand tables for one pipelined run (leading K axis).

    ``i_int``/``w_int`` cover the interior working buffer (the owned B
    rows); ``i_bnd``/``w_bnd`` cover the stacked (K, 6*depth) boundary
    working buffer, rows [left buffer..., right buffer...], matching
    ``taskbench_step_boundary``'s layout.
    """

    i_int: torch.Tensor
    w_int: torch.Tensor
    i_bnd: torch.Tensor
    w_bnd: torch.Tensor


def _phase_tables(idx: torch.Tensor, wgt: torch.Tensor, depth: int,
                  mode: str) -> _PhaseTables:
    """Wrap the tables once and slice them per pipeline phase.

    All tensors carry a leading K axis; rows live on axis 1. The extended
    table has B + 2*depth rows covering global rows [-depth, B + depth):
    the interior buffer is ext[depth : depth + B], the left boundary buffer
    ext[:3*depth], the right one ext[B - depth:]. Gather/onehot offsets are
    rebased per buffer AFTER slicing: each phase's idx addresses its own
    working buffer.
    """
    K, B = wgt.shape[0], wgt.shape[1]

    def phases(ext):
        interior = ext[:, depth:depth + B]
        boundary = torch.cat([ext[:, :3 * depth], ext[:, B - depth:B + 2 * depth]],
                             dim=1)
        return interior.contiguous(), boundary

    w_int, w_bnd = phases(_wrap(wgt, depth, 1))
    if mode == "window":  # the kernel reads no idx
        i_int = torch.zeros((K, 1, 1), dtype=torch.int32, device=wgt.device)
        i_bnd = i_int
    else:
        rel_int, rel_bnd = phases(_wrap(idx, depth, 1))
        i_int = _rebase_rows(rel_int, row_axis=1)
        i_bnd = _rebase_rows(rel_bnd, row_axis=1)
    return _PhaseTables(i_int, w_int, i_bnd, w_bnd)


def _pipelined_launch(s, hl, hr, a, ph: _PhaseTables, depth: int, kwb: dict,
                      side: Optional["torch.cuda.Stream"] = None):
    """One software-pipelined blocked launch on stacked (K, B, payload)
    state: the boundary phase on the halo received for THIS launch
    (``hl``/``hr``), then the interior phase, which depends on neither the
    halo nor the boundary launch. On one device the next launch's exchange
    is a self-wrap: the left halo is the right boundary output and the
    right halo the left one. With ``side`` (a CUDA stream) the interior
    runs there, ordered after the state it reads and before the
    concatenation that reads it; without, both phases run in order.

    Returns (s_next, hl_next, hr_next).
    """
    B = s.shape[1]
    bl = torch.cat([hl, s[:, :2 * depth]], dim=1)
    br = torch.cat([s[:, B - 2 * depth:], hr], dim=1)
    if side is not None:
        main = torch.cuda.current_stream(s.device)
        side.wait_stream(main)
    bl_out, br_out = _kops.taskbench_boundary(
        bl, br, ph.i_bnd, ph.w_bnd, a, depth=depth, **kwb)
    with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
        mid = _kops.taskbench_interior(s, ph.i_int, ph.w_int, a, depth=depth, **kwb)
    if side is not None:
        main.wait_stream(side)
        # the caching allocator must not hand these blocks to another
        # stream's work before the other stream is done with them
        s.record_stream(side)
        mid.record_stream(main)
    return torch.cat([bl_out, mid, br_out], dim=1), br_out, bl_out


def _prologue_exchange(state: torch.Tensor, depth: int):
    """The first blocked launch's halo (hl, hr) from the t = 0 state's edges:
    on one device the ring exchange wraps the state onto itself."""
    B = state.shape[1]
    return state[:, B - depth:], state[:, :depth]


def _act_schedule(
    member_steps: Sequence[int], lockstep_steps: int, s: int
) -> np.ndarray:
    """(L, K, S) per-depth activity masks for the blocked launch loop.

    Launch l's inner step d executes lockstep timestep t = 1 + l*S + d;
    member k is active iff t < T_k (its own horizon). The final launch of
    any run carries the masked tail ((T-1) mod S trailing zeros).
    """
    L = max(1, -(-(lockstep_steps - 1) // s)) if lockstep_steps > 1 else 0
    t = 1 + (np.arange(L)[:, None, None] * s + np.arange(s)[None, None, :])
    msteps = np.asarray(member_steps, np.int64)[None, :, None]
    return (t < msteps).astype(np.float32)


@register
class PallasStepRuntime(Runtime):
    name = "pallas_step"
    known_options = ("combine", "steps_per_launch", "pipeline")

    def __init__(self, device="cuda", **options):
        super().__init__(device, **options)
        s = self.options.get("steps_per_launch")
        if s == "auto":
            raise NotImplementedError(AUTO_NOT_PORTED)
        if s is not None and int(s) < 1:
            raise ValueError(f"steps_per_launch must be >= 1 or 'auto', got {s!r}")
        self._combine_mode()

    def plan_for(self, graph: TaskGraph) -> Tuple[Optional[str], str]:
        """pattern -> execution plan kind, or (None, reason)."""
        if _patterns.halo_radius(graph) >= 0 and graph.period == 1:
            return PLAN_HALO, ""
        return None, (
            f"pattern {graph.pattern} needs the stride plan (fft, tree) or "
            f"the all-gather plan (all_to_all, spread), which are not ported "
            f"yet (ROADMAP Queue 1 item 5); the port's pallas_step runs "
            f"the halo plan only — fall back to the `fused` backend, which "
            f"runs every pattern")

    def supports(self, graph: TaskGraph):
        plan, why = self.plan_for(graph)
        return (True, "") if plan is not None else (False, why)

    def _combine_mode(self) -> str:
        mode = str(self.options.get("combine", "window"))
        if mode not in COMBINE_OPTIONS:
            raise ValueError(
                f"unknown combine option {mode!r}: choose window, gather, "
                f"or onehot ('pair' is the stride plan's internal "
                f"lowering, selected automatically)")
        return mode

    def _steps_per_launch(self, total_steps: int) -> int:
        """The explicit depth, clamped to the combine-step count (deeper
        than the run is all masked tail), as the reference resolves it."""
        s = self.options.get("steps_per_launch")
        if s in (None, 1):
            return 1
        s = int(s)
        return min(s, total_steps - 1) if total_steps > 1 else s

    def _pipeline_requested(self) -> bool:
        """``pipeline=False`` is the serial ablation; default on."""
        return bool(self.options.get("pipeline", True))

    def _pipeline_active(self, block: int, s: int, halo: int) -> bool:
        """The pipelined schedule applies when blocking is on AND the owned
        block keeps a nonempty interior once 2*S*r edge rows belong to the
        boundary phase; otherwise the serial schedule runs."""
        return (s > 1 and halo > 0 and self._pipeline_requested()
                and block > 2 * s * halo)

    @staticmethod
    def _launches(total_steps: int, s: int) -> int:
        """Kernel launches for one run: the t=0 body-only launch plus
        ceil((T-1)/S) blocked combine launches."""
        if total_steps <= 1:
            return 1
        return 1 + -(-(total_steps - 1) // s)

    def _operands(self, graph: TaskGraph, halo: int):
        """Host-built (idx, wgt, idx0, wgt0) for one graph: the t >= 1
        operands in the selected combine mode, and the t = 0 (body only)
        1-column self operands."""
        B = graph.width  # one device: the block is the whole width
        if self._combine_mode() == "window":
            idx, wgt = _window_operands(graph, halo)
        else:
            idx, wgt = _ext_dep_operands(graph, B, halo)
        idx0, wgt0 = _self_operands(graph.width, B)
        return idx, wgt, idx0, wgt0

    def _blocked_operands(self, graph: TaskGraph, halo: int):
        """Host-built (idx, wgt, idx0, wgt0) for the blocked path: window
        mode reuses the per-global-row weight table; gather/onehot switch
        to SIGNED offsets (`_rel_dep_operands`), which wrap like state and
        are rebased onto each working buffer."""
        if self._combine_mode() == "window":
            idx, wgt = _window_operands(graph, halo)
        else:
            idx, wgt = _rel_dep_operands(graph)
        idx0, wgt0 = _self_operands(graph.width, graph.width)
        return idx, wgt, idx0, wgt0

    def _kernel_kw(self, graph: TaskGraph) -> dict:
        spec = graph.kernel
        return dict(kind=spec.kind, iterations=spec.iterations,
                    scratch=spec.scratch, combine=self._combine_mode())

    def build(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        self._require_support(graph)
        S = self._steps_per_launch(graph.steps)
        if S > 1:
            return self._build_blocked(graph, S)
        H = _patterns.halo_radius(graph)
        kw = self._kernel_kw(graph)
        idx, wgt, idx0, wgt0 = (
            torch.from_numpy(a)[None].to(self.device)
            for a in self._operands(graph, H))
        rows = (torch.from_numpy(_extend_rows(graph.width, H)).to(self.device)
                if H else None)
        steps = graph.steps

        def run(init):
            state = _kops.taskbench_step(init[None], idx0, wgt0, **kw)  # t=0
            for _ in range(steps - 1):
                state = _kops.taskbench_step(
                    _extend_state(state, rows), idx, wgt, **kw)
            return state[0]

        return run

    def _build_blocked(self, graph: TaskGraph, S: int) -> Callable:
        """ceil((T-1)/S) launches of K4 after the t = 0 K3 launch. When the
        pipeline applies, each launch splits into boundary + interior
        phases (two K4 launches); otherwise one deep wrap and one K4 launch
        on the wrapped state."""
        H = _patterns.halo_radius(graph)
        depth = S * H
        B, T = graph.width, graph.steps
        mode = self._combine_mode()
        kw0 = self._kernel_kw(graph)
        kwb = dict(kw0, steps_per_launch=S)
        idx, wgt, idx0, wgt0 = (
            torch.from_numpy(a)[None].to(self.device)
            for a in self._blocked_operands(graph, H))
        acts = torch.from_numpy(
            _act_schedule((T,), T, S)[:, 0]).to(self.device)  # (L, S)
        pipelined = self._pipeline_active(B, S, H)
        if pipelined:
            ph = _phase_tables(idx, wgt, depth, mode)
            side = (torch.cuda.Stream(self.device)
                    if self.device.type == "cuda" else None)
        else:
            iext, wext = _extend_tables(idx, wgt, depth, mode, row_axis=1)
            rows = (torch.from_numpy(_extend_rows(B, depth)).to(self.device)
                    if depth else None)

        def run(init):
            state = _kops.taskbench_step(init[None], idx0, wgt0, **kw0)  # t=0
            if T == 1:
                return state[0]
            if pipelined:
                hl, hr = _prologue_exchange(state, depth)
                for a in acts:
                    state, hl, hr = _pipelined_launch(
                        state, hl, hr, a[None], ph, depth, kwb, side)
                return state[0]
            for a in acts:
                nf = _kops.taskbench_step(_extend_state(state, rows), iext, wext,
                                          a[None], **kwb)
                state = nf[:, depth:depth + B]
            return state[0]

        return run

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Kernel launches: the t=0 body-only launch plus ceil((T-1)/S)
        blocked launches (S=1: T in all). The pipelined schedule splits
        every blocked launch into a boundary and an interior launch. (At
        halo > 0 each serial launch after t=0 also issues the one-device
        halo wrap, a row gather of the state, and each pipelined launch
        three concatenations.)"""
        S = self._steps_per_launch(graph.steps)
        L = self._launches(graph.steps, S)
        if self._pipeline_active(graph.width, S, _patterns.halo_radius(graph)):
            return 1 + 2 * (L - 1)
        return L
