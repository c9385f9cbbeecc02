"""`pallas_step` runtime — one megakernel launch per timestep, on one GPU.

Counterpart of ``repro.core.runtimes.pallas_step`` for the halo plan at its
default schedule (``steps_per_launch`` unset, S = 1) on one device. Each
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

Options: ``combine`` = "window" (default; shifted-row sums, no gather),
"gather" or "onehot" (the ablations). ``steps_per_launch`` may be unset or
1; "auto" and depths > 1 (the temporal-blocked kernel and its pipelined
schedule) raise NotImplementedError until port slice 2. The stride plan
(fft, tree) and the all-gather plan (all_to_all, spread) come in port
slice 3; those patterns run on the ``fused`` backend meanwhile.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import patterns as _patterns
from repro_torch.core.graph import TaskGraph
from repro_torch.core.runtimes.base import Runtime, register
from repro_torch.kernels import ops as _kops
from repro_torch.kernels.taskbench_step import (
    BLOCKED_NOT_PORTED,
    WEIGHT_ACCUM_DTYPE,
    finalize_weights,
    prepare_step_operands,
)

PLAN_HALO = "halo"
COMBINE_OPTIONS = ("window", "gather", "onehot")


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


@register
class PallasStepRuntime(Runtime):
    name = "pallas_step"
    known_options = ("combine", "steps_per_launch")

    def __init__(self, device="cuda", **options):
        super().__init__(device, **options)
        s = self.options.get("steps_per_launch")
        if s not in (None, 1):
            if not isinstance(s, str) and int(s) < 1:
                raise ValueError(f"steps_per_launch must be >= 1 or 'auto', got {s!r}")
            raise NotImplementedError(BLOCKED_NOT_PORTED)
        self._combine_mode()

    def plan_for(self, graph: TaskGraph) -> Tuple[Optional[str], str]:
        """pattern -> execution plan kind, or (None, reason)."""
        if _patterns.halo_radius(graph) >= 0 and graph.period == 1:
            return PLAN_HALO, ""
        return None, (
            f"pattern {graph.pattern} needs the stride plan (fft, tree) or "
            f"the all-gather plan (all_to_all, spread), which are not ported "
            f"yet (port slice 3 in ROADMAP.md); the port's pallas_step runs "
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

    def build(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        self._require_support(graph)
        H = _patterns.halo_radius(graph)
        spec = graph.kernel
        kw = dict(kind=spec.kind, iterations=spec.iterations,
                  scratch=spec.scratch, combine=self._combine_mode())
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

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Megakernel launches: one per timestep, T in all. (At halo > 0
        each step after t=0 also issues the one-device halo wrap, a row
        gather of the state.)"""
        return graph.steps
