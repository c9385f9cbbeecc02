"""`serialized` runtime: one host call per task.

Counterpart of ``repro.core.runtimes.serialized``. Every task (t, p) is its
own host call, driven by a Python loop: its combine over its live
dependencies (stack, sum, divide), then the body on the point's one row
(with ``use_kernels``, one K1 or K2 launch on a (1, payload) view). No
launch, graph or batched operation spans two tasks, so every task pays the
full host-to-device issue cost: the port's analogue of an AMT runtime's
per-task spawn and schedule cost (the quantity the paper isolates with
fine-grain sweeps; cf. HPX-local's threading overhead, paper §3.3/§6.1).

At large grain that cost amortizes and this backend reaches ``fused``'s
peak FLOP/s; at small grain its efficiency collapses first, giving it the
largest METG. The run stays eager on the card: there is nothing to capture,
since the point of the rung is the host call per task. Each task call is
counted in ``_build.HOST_CALLS``.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from repro_torch.core.graph import GraphEnsemble, TaskGraph
from repro_torch.core.runtimes.base import Runtime, register
from repro_torch.core.runtimes.fused import _body_ops
from repro_torch.core.task_kernels import apply_kernel
from repro_torch.kernels import _build

#: Device operations of a task's combine (stack, sum, divide) and of the
#: run's final stack of the point states (a test counts them)
_COMBINE_OPS, _STACK_OPS = 3, 1


class _TaskDispatcher:
    """One graph's per-task calls and its host-side dependency lists.

    The dependency lists are built once, outside the timed run (Task Bench
    likewise keeps graph construction out of its timing). One dispatcher per
    ensemble member.
    """

    def __init__(self, graph: TaskGraph, use_kernels: bool):
        spec = graph.kernel
        self.graph = graph
        self.body = lambda x: apply_kernel(x, spec, use_kernels=use_kernels)
        self.dep_ids: List[List[Tuple[int, ...]]] = [
            [graph.dependencies(t, p) for p in range(graph.width)]
            for t in range(graph.steps)]

    def task(self, state: List[torch.Tensor], deps: Tuple[int, ...],
             own: torch.Tensor) -> torch.Tensor:
        """One task, one host call: the mean of its live dependencies'
        outputs, then the body; a task without dependencies runs the body
        on its own previous output ``own``."""
        _build.task_called()
        if not deps:
            return self.body(own)
        return self.body(torch.stack([state[d] for d in deps]).sum(dim=0) / len(deps))

    def initial(self, init: torch.Tensor) -> List[torch.Tensor]:
        return [self.task([], (), init[p]) for p in range(self.graph.width)]

    def advance(self, state: List[torch.Tensor], t: int) -> List[torch.Tensor]:
        """Every point of timestep t, one host call per task."""
        return [self.task(state, deps, state[p]) for p, deps in enumerate(self.dep_ids[t])]


@register
class SerializedRuntime(Runtime):
    name = "serialized"
    known_options = ("use_kernels",)

    MAX_TASKS = 200_000  # refuse graphs whose python loop would take forever

    def _use_kernels(self) -> bool:
        return bool(self.options.get("use_kernels", False))

    def supports(self, graph: TaskGraph):
        if graph.num_tasks > self.MAX_TASKS:
            return False, f"too many tasks for per-task dispatch ({graph.num_tasks})"
        if graph.pattern == "all_to_all" and graph.width > 1024:
            return False, "all_to_all fan-in too wide for per-task gather"
        return True, ""

    def supports_ensemble(self, ensemble: GraphEnsemble):
        ok, why = super().supports_ensemble(ensemble)
        if not ok:
            return ok, why
        if ensemble.num_tasks > self.MAX_TASKS:
            return False, (
                f"too many total tasks for per-task dispatch ({ensemble.num_tasks})"
            )
        return True, ""

    def _build_eager(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        disp = _TaskDispatcher(graph, self._use_kernels())

        def run(init):
            state = disp.initial(init)
            for t in range(1, graph.steps):
                state = disp.advance(state, t)
            return torch.stack(state)

        return run

    def _build_ensemble_eager(self, ensemble: GraphEnsemble) -> Callable:
        """Round-robin per timestep: member 0's tasks, then member 1's, ...;
        every task its own host call, none for a member past its own T."""
        dispatchers = [_TaskDispatcher(g, self._use_kernels()) for g in ensemble.members]

        def run(inits):
            states = [d.initial(x) for d, x in zip(dispatchers, inits)]
            for t in range(1, ensemble.steps):
                states = [d.advance(s, t) if t < d.graph.steps else s
                          for d, s in zip(dispatchers, states)]
            return tuple(torch.stack(s) for s in states)

        return run

    def _build_traced(self, graph: TaskGraph) -> Callable:
        """Spans a timestep (spans a task would record W x T entries of
        recorder noise; the ``tasks`` attribute keeps the count): the
        ``dispatch`` span covers the host loop issuing the timestep's W task
        calls, the quantity this backend exists to show, and the
        ``compute.interior`` span the drain of what the device still holds
        (``t0_dispatch``/``t0_compute``, then ``task_dispatch``/
        ``task_drain``), through the run's own `_TaskDispatcher`."""
        disp = _TaskDispatcher(graph, self._use_kernels())
        tr, W = self.tracer, graph.width

        def run(init):
            with tr.span("t0_dispatch", "dispatch", step=0, tasks=W):
                state = disp.initial(init)
            with tr.span("t0_compute", "compute.interior", step=0):
                self._drain()
            for t in range(1, graph.steps):
                with tr.span("task_dispatch", "dispatch", step=t, tasks=W):
                    state = disp.advance(state, t)
                with tr.span("task_drain", "compute.interior", step=t):
                    self._drain()
            return torch.stack(state)

        return run

    def build(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        """The eager per-task loop, on either device: no graph may span two
        tasks."""
        self._require_support(graph)
        return self._build_eager(graph)

    def build_ensemble(self, ensemble: GraphEnsemble) -> Callable:
        self._require_ensemble_support(ensemble)
        return self._build_ensemble_eager(ensemble)

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Device operations one run issues: each task's body, each task
        with dependencies its combine, and the final stack."""
        _, mask = graph.dependency_arrays()
        live = (mask.sum(-1) > 0).sum(-1)  # tasks with dependencies, per period slot
        with_deps = sum(int(live[(t - 1) % graph.period]) for t in range(1, graph.steps))
        body = _body_ops(graph.kernel, self._use_kernels())
        return graph.num_tasks * body + with_deps * _COMBINE_OPS + _STACK_OPS

    def body_launches_per_run(self, work) -> int:
        """K1/K2 launches of one run with ``use_kernels``: one a task (none
        for the empty body), summed over an ensemble's members."""
        members = work.members if isinstance(work, GraphEnsemble) else (work,)
        return sum(0 if g.kernel.kind == "empty" or g.kernel.iterations == 0
                   else g.num_tasks for g in members)

    def host_calls_per_run(self, work) -> int:
        """One host call per task: T x W per graph, summed over an
        ensemble's members."""
        return work.num_tasks
