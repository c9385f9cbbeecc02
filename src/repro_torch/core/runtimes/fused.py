"""`fused` runtime — the whole graph as one program on one device.

Counterpart of ``repro.core.runtimes.fused`` for single graphs. The
reference lowers the T-step loop into one jitted ``lax.scan``; here the
loop is written eagerly (`_build_eager`: the t=0 body, then T-1 steps of
combine + body) and, on the card, captured as one CUDA graph, the analogue
of "one jit" (``Runtime.build``).

Ensembles (``build_ensemble``, the reference's two branches): a stackable
ensemble (uniform width and payload, padded tables under
``_MAX_DEP_CELLS``) keeps its K states as one (K*W, payload) tensor and
takes one combine a step over `GraphEnsemble.dependency_arrays`' padded
tables, member k's rows offset by k*W and its period slot chosen on the
host from t; the body is one application over all K*W rows when the spec
is uniform (one K1/K2 launch with the kernels). Any other ensemble takes
one combine and one body per member. A member past its own T keeps its
state through a ``torch.where`` on a static (T, K) activity table, sliced
per step.

Option: ``use_kernels`` (the reference's ``use_pallas``) runs the body
through the CUDA kernels K1 (compute_bound) / K2 (memory_bound) instead of
their plain PyTorch versions.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.graph import GraphEnsemble, TaskGraph
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

    # ------------------------------------------------------------ ensembles

    def _is_stacked(self, ensemble: GraphEnsemble) -> bool:
        """The stacked branch: uniform (width, payload) and the padded
        (K, Pmax, W, Dmax) tables under the cell limit."""
        m = ensemble.members
        return ensemble.stackable and (
            len(m) * max(g.period for g in m) * m[0].width * max(g.max_deps for g in m)
            <= _MAX_DEP_CELLS)

    def _build_ensemble_eager(self, ensemble: GraphEnsemble) -> Callable:
        if self._is_stacked(ensemble):
            return self._build_ensemble_stacked(ensemble)
        return self._build_ensemble_tuple(ensemble)

    def _build_ensemble_stacked(self, ensemble: GraphEnsemble) -> Callable:
        """All K members as one (K*W, payload) state: one combine a step on
        the members' padded tables, member k's indices offset by k*W (so
        the one-graph `combine_dependencies` serves, each row's own state
        its fallback), and one body over all K*W rows (per member and a
        concatenation when the specs differ)."""
        members = ensemble.members
        K, W, T = len(members), members[0].width, ensemble.steps
        specs = [g.kernel for g in members]
        use_kernels = self._use_kernels()
        idx_np, mask_np, periods = ensemble.dependency_arrays()
        offset = (np.arange(K) * W)[:, None, None]
        tables: Dict[Tuple[int, ...], Tuple[torch.Tensor, torch.Tensor]] = {}
        slot_of = []
        for t in range(1, T):
            key = tuple(int((t - 1) % p) for p in periods)
            if key not in tables:
                i = np.stack([idx_np[k, s] for k, s in enumerate(key)]) + offset
                m = np.stack([mask_np[k, s] for k, s in enumerate(key)])
                tables[key] = (torch.from_numpy(i.reshape(K * W, -1)).long().to(self.device),
                               torch.from_numpy(m.reshape(K * W, -1)).to(self.device))
            slot_of.append(tables[key])
        active = torch.from_numpy(ensemble.active_table()[:, :, None, None]).to(self.device)
        hetero = ensemble.heterogeneous_steps

        def body(x):  # (K*W, payload)
            if len(set(specs)) == 1:
                return apply_kernel(x, specs[0], use_kernels=use_kernels)
            return torch.cat([apply_kernel(x[k * W:(k + 1) * W], sp, use_kernels=use_kernels)
                              for k, sp in enumerate(specs)])

        def run(inits):
            state = body(torch.cat(inits))  # t=0 tasks
            for t in range(1, T):
                nxt = body(combine_dependencies(state, *slot_of[t - 1]))
                if hetero:  # freeze members whose own T is exhausted
                    nxt = torch.where(active[t], nxt.view(K, W, -1),
                                      state.view(K, W, -1)).view(K * W, -1)
                state = nxt
            return tuple(state[k * W:(k + 1) * W] for k in range(K))

        return run

    def _build_ensemble_tuple(self, ensemble: GraphEnsemble) -> Callable:
        """Mixed shapes: one combine and one body per member a step."""
        members = ensemble.members
        T = ensemble.steps
        use_kernels = self._use_kernels()
        combines = [self._make_combine(g) for g in members]
        active = torch.from_numpy(ensemble.active_table()).to(self.device)

        def run(inits):
            states = [apply_kernel(x, g.kernel, use_kernels=use_kernels)
                      for x, g in zip(inits, members)]
            for t in range(1, T):
                for k, (g, combine) in enumerate(zip(members, combines)):
                    n = apply_kernel(combine(states[k], t), g.kernel, use_kernels=use_kernels)
                    if g.steps < T:  # freeze once this member's T is done
                        n = torch.where(active[t, k], n, states[k])
                    states[k] = n
            return tuple(states)

        return run

    def ensemble_dispatches_per_run(self, ensemble: GraphEnsemble) -> int:
        """Device operations one ensemble run issues, counted as
        `dispatches_per_run` counts them. Stacked: the concatenation of the
        inits, T bodies over all rows (per member and a concatenation when
        the specs differ), T-1 combines, and with mixed horizons T-1
        freezes. Tuple: each member's T bodies and T-1 combines, and T-1
        freezes for each member shorter than the ensemble."""
        members = ensemble.members
        T = ensemble.steps
        uk = self._use_kernels()
        if self._is_stacked(ensemble):
            specs = {g.kernel for g in members}
            body = (_body_ops(members[0].kernel, uk) if len(specs) == 1
                    else sum(_body_ops(g.kernel, uk) for g in members) + 1)
            freeze = 1 if ensemble.heterogeneous_steps else 0
            return 1 + T * body + (T - 1) * (_COMBINE_OPS + freeze)
        total = 0
        for g in members:
            combine = _ALL_TO_ALL_OPS if g.pattern == "all_to_all" else _COMBINE_OPS
            freeze = 1 if g.steps < T else 0
            total += T * _body_ops(g.kernel, uk) + (T - 1) * (combine + freeze)
        return total
