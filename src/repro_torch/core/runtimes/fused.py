"""`fused` runtime — the whole graph as one program on one device.

Counterpart of ``repro.core.runtimes.fused`` for single graphs. The
reference lowers the T-step loop into one jitted ``lax.scan``; here the
loop is written eagerly (`_build_eager`: the t=0 body, then T-1 steps of
combine + body) and, on the card, captured as one CUDA graph, the analogue
of "one jit" (``Runtime.build``). Ensembles are a later port slice
(ROADMAP.md).

Option: ``use_kernels`` (the reference's ``use_pallas``) runs the body
through the CUDA kernels K1 (compute_bound) / K2 (memory_bound) instead of
their plain PyTorch versions.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.graph import TaskGraph
from repro_torch.core.runtimes.base import Runtime, register
from repro_torch.core.task_kernels import (
    KernelSpec,
    apply_kernel,
    combine_all_to_all,
    combine_dependencies,
)

#: refuse dependency-array materializations beyond this many cells
_MAX_DEP_CELLS = 64 << 20

#: Device operations one combine issues: `combine_dependencies` (live
#: count, gather, weight, sum, clamp, divide, compare, select) and
#: `combine_all_to_all` (mean, materialized broadcast). A test counts them.
_COMBINE_OPS = 8
_ALL_TO_ALL_OPS = 2


def _body_ops(spec: KernelSpec, use_kernels: bool) -> int:
    """Device operations one body application issues (see apply_kernel):
    one kernel launch with ``use_kernels``; else the plain versions' ops."""
    if spec.kind == "empty" or spec.iterations == 0:
        return 0
    if use_kernels:
        return 1
    if spec.kind == "compute_bound":
        return 2 * spec.iterations  # multiply, add
    return 3 + 2 * spec.iterations  # tile, (roll, add) per pass, pad, mean


@register
class FusedRuntime(Runtime):
    name = "fused"
    known_options = ("use_kernels",)

    def supports(self, graph: TaskGraph):
        if graph.pattern == "all_to_all":
            return True, ""
        cells = graph.period * graph.width * graph.max_deps
        if cells > _MAX_DEP_CELLS:
            return False, f"dependency array too large ({cells} cells)"
        return True, ""

    def _use_kernels(self) -> bool:
        return bool(self.options.get("use_kernels", False))

    def _make_combine(self, graph: TaskGraph) -> Callable:
        """combine(state, t) -> per-point kernel inputs for timestep t."""
        if graph.pattern == "all_to_all":
            return lambda state, t: combine_all_to_all(state).contiguous()
        idx_np, mask_np = graph.dependency_arrays()
        idx = torch.from_numpy(idx_np).long().to(self.device)
        mask = torch.from_numpy(mask_np).to(self.device)
        slots = [(idx[s], mask[s]) for s in range(graph.period)]
        period = graph.period

        def combine(state, t):
            return combine_dependencies(state, *slots[(t - 1) % period])

        return combine

    def _build_eager(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        spec = graph.kernel
        use_kernels = self._use_kernels()
        combine = self._make_combine(graph)
        steps = graph.steps

        def run(init):
            state = apply_kernel(init, spec, use_kernels=use_kernels)  # t=0 tasks
            for t in range(1, steps):
                state = apply_kernel(combine(state, t), spec, use_kernels=use_kernels)
            return state

        return run

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Device operations one run issues: T bodies and T-1 combines.

        Unlike the reference's single jitted program, whose compiler fuses
        them, every operation of the loop is its own kernel (a node of the
        captured graph), so this counts them all.
        """
        combine = _ALL_TO_ALL_OPS if graph.pattern == "all_to_all" else _COMBINE_OPS
        body = _body_ops(graph.kernel, self._use_kernels())
        return graph.steps * body + (graph.steps - 1) * combine
