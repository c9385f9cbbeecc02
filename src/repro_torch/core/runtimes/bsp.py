"""`bsp` and `bsp_scan` runtimes: bulk-synchronous supersteps (the MPI
analogue), on one device.

Counterpart of ``repro.core.runtimes.bsp``. Points are block-distributed
over the devices (one so far: B = W), and every timestep is one synchronous
superstep, exchange then compute, as in MPI's send/recv + compute.

Two dispatch models:
  bsp        one host call per superstep: each distinct superstep (the t = 0
             body, the halo step, each butterfly period slot, the global
             step) is captured once as its own CUDA graph on static state
             buffers (``_capture.ReplayLoop``), and a host loop replays one
             graph a timestep, the counterpart of the reference's ``jax.jit``
             call per step. Each superstep ends in a copy into its state
             buffer: ``donate=True`` (the default) steps one buffer in place,
             ``donate=False`` two buffers ping-pong; the bits are the same.
  bsp_scan   the whole timestep loop as one CUDA graph (``Runtime.build``),
             the reference's ``lax.scan`` in one jit: the amortised MPI bound.

Exchange per pattern class on one device (the multi-rank transports are
ROADMAP.md Queue 1 item 8):
  halo       the ring wrap (``_halo.exchange_halos``), then the window
             combine (``_halo.make_halo_combine``)
  butterfly  every stride is below the block: the local row shuffle
             ``local[j ^ stride]``, the slot picked on the host from t
  global     all_to_all's mean (``_halo.global_mean``); spread's
             ``(p + i*stride + t - 1) % W`` gather and its mean over the
             fanout, duplicates included, as the reference computes it; t
             comes from a step counter on the device that the t = 0 body
             resets and each step advances, so one graph serves every t;
             trivial: the body alone

Options: ``use_kernels`` (the reference's ``use_pallas``) runs the body as
the CUDA kernels K1 / K2; ``bsp``'s ``donate`` (above); ``bsp_scan``'s
``unroll``, the reference's scan unroll factor, is accepted and changes
nothing here: the capture already unrolls every step.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import patterns as _patterns
from repro_torch.core.graph import GraphEnsemble, TaskGraph
from repro_torch.core.runtimes import _halo
from repro_torch.core.runtimes._capture import HostLoop, ReplayLoop
from repro_torch.core.runtimes.base import Runtime, register
from repro_torch.core.runtimes.fused import _body_ops
from repro_torch.core.task_kernels import apply_kernel

#: Device operations of each step part (a test counts them): the halo
#: step's wrap concatenation; the window combine (weight, sum, divide); the
#: butterfly shuffle (row gather, add, halve); all_to_all's mean (sum,
#: divide) and its materialized broadcast; spread's gather (ids from the
#: counter: add, remainder; the counter's advance; row gather; mean); the
#: counter's reset in the t = 0 body; the masked freeze of a finished
#: ensemble member.
_WRAP_OPS, _COMBINE_OPS, _SHUFFLE_OPS = 1, 3, 3
_ALL_TO_ALL_OPS, _SPREAD_OPS, _RESET_OPS, _FREEZE_OPS = 3, 5, 1, 1

#: (init(local) -> state, step(local, t) -> state): one member's t = 0 body
#: and its superstep
MemberSteps = Tuple[Callable[[torch.Tensor], torch.Tensor],
                    Callable[[torch.Tensor, int], torch.Tensor]]


def _members(work) -> Tuple[TaskGraph, ...]:
    return work.members if isinstance(work, GraphEnsemble) else (work,)


class _BspBase(Runtime):
    """Shared machinery for bsp / bsp_scan / overlap."""

    known_options: Tuple[str, ...] = ("use_kernels",)
    #: devices the points are block-distributed over (one so far)
    num_devices = 1

    def _block(self, graph: TaskGraph) -> int:
        return graph.width // self.num_devices

    def _use_kernels(self) -> bool:
        return bool(self.options.get("use_kernels", False))

    def supports(self, graph: TaskGraph):
        D = self.num_devices
        if graph.width % D != 0:
            return False, f"width {graph.width} not divisible by {D} devices"
        B = graph.width // D
        pat = graph.pattern
        if pat in _patterns.HALO_PATTERNS or pat == "random_nearest":
            r = _patterns.halo_radius(graph)
            if r > B:
                return False, f"halo radius {r} exceeds block {B} (multi-hop needed)"
            return True, ""
        if pat in _patterns.BUTTERFLY_PATTERNS:
            if D & (D - 1):
                return False, "butterfly patterns need power-of-two device count"
            return True, ""
        if pat in ("all_to_all", "spread", "trivial"):
            return True, ""
        return False, f"pattern {pat} unsupported by {self.name}"

    def _body(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        spec, use_kernels = graph.kernel, self._use_kernels()
        return lambda x: apply_kernel(x, spec, use_kernels=use_kernels)

    # ---------------------------------------------------------- step bodies

    def _make_halo_step(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        r = _patterns.halo_radius(graph)
        B = self._block(graph)
        combine = _halo.make_halo_combine(graph, self.device)
        body = self._body(graph)

        def step(local):  # (B, payload)
            if r == 0:
                return body(combine(local, B, 0))
            recv_l, recv_r = _halo.exchange_halos(local, r, self.num_devices)
            return body(combine(torch.cat([recv_l, local, recv_r]), B, 0))

        return step

    def _make_butterfly_steps(self, graph: TaskGraph) -> List[Callable]:
        """One step body per period slot (pairing distance 2^k). On one
        device every stride is below the block: the partner is the local
        row shuffle ``local[j ^ stride]`` (clamped to the block, as the
        reference's gather clamps, which only W = 1 reaches)."""
        B = self._block(graph)
        body = self._body(graph)
        j = np.arange(B)

        def make(stride: int) -> Callable:
            partner_rows = torch.from_numpy(np.minimum(j ^ stride, B - 1)).to(self.device)

            def step(local):
                partner = local.index_select(0, partner_rows)
                return body((local + partner) * 0.5)

            return step

        return [make(s) for s in _patterns.butterfly_slot_strides(graph)]

    def _make_global_step(self, graph: TaskGraph) -> Tuple[Callable, Callable]:
        """(init, step) of a global pattern; spread's step reads t from a
        counter on the device, which init resets to 1 and each step
        advances."""
        W, B = graph.width, self._block(graph)
        body = self._body(graph)
        if graph.pattern == "all_to_all":
            def step(local):
                mean = _halo.global_mean(local, W, self.num_devices)
                return body(mean[None, :].expand_as(local).contiguous())

            return body, step
        if graph.pattern == "spread":
            stride = max(1, W // graph.fanout)
            # (p + i*stride - 1): the step's ids are (base + t) % W
            p = np.arange(B)  # this device's first point is 0
            base = torch.from_numpy(
                p[:, None] + np.arange(graph.fanout)[None, :] * stride - 1).to(self.device)
            t_dev = torch.ones((), dtype=torch.int64, device=self.device)

            def init(local):
                t_dev.fill_(1)
                return body(local)

            def step(local):
                ids = torch.remainder(base + t_dev, W)  # (B, fanout)
                t_dev.add_(1)
                full = _halo.gather_global(local, self.num_devices)
                return body(full[ids].mean(dim=1))

            return init, step
        if graph.pattern == "trivial":
            return body, body
        raise ValueError(graph.pattern)

    def _supersteps(self, graph: TaskGraph) -> Tuple[List[Callable], Callable[[int], int]]:
        """(the distinct step bodies of one graph, t -> the index of the one
        timestep t runs): the t = 0 body first, then the halo step, each
        butterfly period slot (picked on the host from t), or the global
        step."""
        pat = graph.pattern
        if pat in _patterns.HALO_PATTERNS or pat == "random_nearest":
            return [self._body(graph), self._make_halo_step(graph)], lambda t: min(t, 1)
        if pat in _patterns.BUTTERFLY_PATTERNS:
            period = graph.period
            return ([self._body(graph), *self._make_butterfly_steps(graph)],
                    lambda t: 0 if t == 0 else 1 + (t - 1) % period)
        return list(self._make_global_step(graph)), lambda t: min(t, 1)

    def _make_member_step(self, graph: TaskGraph) -> MemberSteps:
        """(init, step(local, t)) for one graph: the building block of the
        one-graph loops (bsp_scan's single graphs and ensembles)."""
        bodies, pick = self._supersteps(graph)
        return bodies[0], lambda local, t: bodies[pick(t)](local)

    def _step_ops(self, graph: TaskGraph) -> Tuple[int, int]:
        """Device operations of (the t = 0 body, one superstep), as
        `_make_member_step` issues them."""
        body = _body_ops(graph.kernel, self._use_kernels())
        pat = graph.pattern
        if pat in _patterns.HALO_PATTERNS or pat == "random_nearest":
            r = _patterns.halo_radius(graph)
            return body, body + (_WRAP_OPS + _COMBINE_OPS if r else 0)
        if pat in _patterns.BUTTERFLY_PATTERNS:
            return body, body + _SHUFFLE_OPS
        if pat == "all_to_all":
            return body, body + _ALL_TO_ALL_OPS
        if pat == "spread":
            return body + _RESET_OPS, body + _SPREAD_OPS
        return body, body  # trivial

    def _step_bodies(self, graph: TaskGraph) -> int:
        """Body applications of one superstep."""
        return 1

    def _bodies(self, graph: TaskGraph, steps: int) -> int:
        """K1/K2 launches of ``steps`` timesteps of ``graph`` with the
        kernels: the t = 0 body and each superstep's bodies (none for the
        empty body)."""
        if graph.kernel.kind == "empty" or graph.kernel.iterations == 0:
            return 0
        return 1 + (steps - 1) * self._step_bodies(graph)

    def body_launches_per_run(self, work) -> int:
        """K1/K2 launches of one run of ``work`` (a graph or an ensemble)
        with ``use_kernels``. A one-graph loop steps every member at every
        timestep of the run, a finished member's result masked by the
        freeze."""
        members = _members(work)
        T = max(g.steps for g in members)
        return sum(self._bodies(g, T) for g in members)

    def _loop_ops(self, work) -> int:
        """Device operations of a one-graph loop over ``work``'s members:
        each member's t = 0 body and T - 1 supersteps, and with mixed
        horizons a freeze a step for each member shorter than the run."""
        members = _members(work)
        T = max(g.steps for g in members)
        total = 0
        for g in members:
            init, step = self._step_ops(g)
            total += init + (T - 1) * (step + (_FREEZE_OPS if g.steps < T else 0))
        return total

    def _one_graph_loop(self, members: Sequence[TaskGraph],
                        member_steps: Sequence[MemberSteps]) -> Callable:
        """The eager loop of every member in one program: each member's t =
        0 body, then per timestep each member's superstep in member order, a
        member past its own T frozen by ``torch.where`` on a static (T, K)
        activity table (the reference's masked freeze)."""
        T = max(g.steps for g in members)
        active = torch.from_numpy(GraphEnsemble(members).active_table()).to(self.device)

        def run(inits):
            states = [init(x) for (init, _), x in zip(member_steps, inits)]
            for t in range(1, T):
                for k, (g, (_, step)) in enumerate(zip(members, member_steps)):
                    n = step(states[k], t)
                    if g.steps < T:  # masked freeze past this member's T
                        n = torch.where(active[t, k], n, states[k])
                    states[k] = n
            return tuple(states)

        return run


@register
class BspRuntime(_BspBase):
    name = "bsp"
    known_options = ("use_kernels", "donate")

    def _host_loop(self, members: Sequence[TaskGraph]) -> HostLoop:
        """One program per (step body, buffer parity) a run uses, each
        ``dst.copy_(body(src))`` on static buffers, and the host calls in
        round-robin order: per timestep one call per member still within its
        own T, in member order, none for a frozen member."""
        donate = bool(self.options.get("donate", True))
        programs: List[Callable[[], None]] = []
        index = {}
        calls: List[List[int]] = []  # per member, the program of each timestep
        buffers: List[List[torch.Tensor]] = []
        for k, g in enumerate(members):
            bodies, pick = self._supersteps(g)
            bufs = [torch.zeros((g.width, g.payload), dtype=torch.float32,
                                device=self.device) for _ in range(1 if donate else 2)]
            buffers.append(bufs)
            mine = []
            for t in range(g.steps):
                src, dst = (0, 0) if donate else (t % 2, (t + 1) % 2)
                key = (k, pick(t), src)
                if key not in index:
                    def program(f=bodies[pick(t)], a=bufs[src], b=bufs[dst]):
                        b.copy_(f(a))
                    index[key] = len(programs)
                    programs.append(program)
                mine.append(index[key])
            calls.append(mine)
        order = [calls[k][t] for t in range(max(g.steps for g in members))
                 for k, g in enumerate(members) if t < g.steps]

        def stage(xs):
            for bufs, x in zip(buffers, xs):
                bufs[0].copy_(x)

        def output():
            return tuple(bufs[0 if donate else g.steps % 2]
                         for bufs, g in zip(buffers, members))

        return HostLoop(stage, programs, order, output)

    def _build_eager(self, graph: TaskGraph) -> HostLoop:
        loop = self._host_loop((graph,))
        return HostLoop(lambda x: loop.stage((x,)), loop.programs, loop.order,
                        lambda: loop.output()[0])

    def _build_ensemble_eager(self, ensemble: GraphEnsemble) -> HostLoop:
        return self._host_loop(ensemble.members)

    def _replayed(self, loop: HostLoop):
        """On the card each distinct superstep captured as its own CUDA
        graph and replayed once a host call (`_capture.ReplayLoop`): the
        whole run is never one graph. On the CPU the host loop itself."""
        return loop if self.device.type != "cuda" else ReplayLoop(loop, self.device)

    def build(self, graph: TaskGraph):
        """A host loop of T calls, one a superstep (see `_replayed`)."""
        self._require_support(graph)
        return self._replayed(self._build_eager(graph))

    def build_ensemble(self, ensemble: GraphEnsemble):
        """Round-robin host calls: per timestep one superstep per member
        still within its own T, in member order (an MPI-style runtime: no
        program spans two members' supersteps)."""
        self._require_ensemble_support(ensemble)
        return self._replayed(self._build_ensemble_eager(ensemble))

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Device operations one run issues: the t = 0 body and T - 1
        supersteps, each followed by its copy into the state buffer."""
        init, step = self._step_ops(graph)
        return init + (graph.steps - 1) * step + graph.steps

    def host_calls_per_run(self, work) -> int:
        """One host call per superstep: T per graph, and per ensemble the
        members' own T summed (a frozen member makes no call)."""
        return sum(g.steps for g in _members(work))

    def body_launches_per_run(self, work) -> int:
        """K1/K2 launches of one run with ``use_kernels``: each member's
        bodies within its own T (a frozen member makes no call)."""
        return sum(self._bodies(g, g.steps) for g in _members(work))


@register
class BspScanRuntime(_BspBase):
    """BSP with the timestep loop in one CUDA graph (amortised dispatch)."""

    name = "bsp_scan"
    known_options = ("use_kernels", "unroll")

    def _build_eager(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        loop = self._one_graph_loop((graph,), (self._make_member_step(graph),))
        return lambda init: loop((init,))[0]

    def _build_ensemble_eager(self, ensemble: GraphEnsemble) -> Callable:
        """Every member in one program (one graph on the card): per timestep
        each member's superstep, in member order."""
        members = ensemble.members
        return self._one_graph_loop(members, [self._make_member_step(g) for g in members])

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Device operations one run issues: the t = 0 body and T - 1
        supersteps (every one a node of the run's graph)."""
        return self._loop_ops(graph)

    def ensemble_dispatches_per_run(self, ensemble: GraphEnsemble) -> int:
        return self._loop_ops(ensemble)
