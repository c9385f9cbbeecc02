"""`bsp` and `bsp_scan` runtimes: bulk-synchronous supersteps (the MPI
analogue), over D row shards.

Counterpart of ``repro.core.runtimes.bsp``. Points are block-distributed
over the devices (``Runtime(devices=...)``; one by default): shard d owns
rows [d*B, (d+1)*B), B = W / D, as its own tensor, and every timestep is
one synchronous superstep, exchange then compute, as in MPI's send/recv +
compute. Each shard's compute runs on its own stream; the exchanges are
``_halo``'s transports (on one device, the ring wrap as views).

Two dispatch models:
  bsp        one host call per superstep: each distinct superstep (the t = 0
             body, the halo step, each butterfly period slot, the global
             step), for all shards at once, is captured once as its own
             CUDA graph on static state buffers (``_capture.ReplayLoop``),
             and a host loop replays one graph a timestep, the counterpart
             of the reference's ``jax.jit`` call per step. Each superstep
             ends in a copy into its state buffer: ``donate=True`` (the
             default) steps one buffer in place, ``donate=False`` two
             buffers ping-pong; the bits are the same.
  bsp_scan   the whole timestep loop as one CUDA graph (``Runtime.build``),
             the reference's ``lax.scan`` in one jit: the amortised MPI bound.

Exchange per pattern class:
  halo       ``_halo.exchange_halos`` (the "ppermute" transport; one device:
             the wrap), then the window combine (``_halo.make_halo_combine``)
             at the shard's first global row p0 = d*B
  butterfly  strides below the block: the local row shuffle
             ``local[j ^ stride]``; strides of a block or more: the partner
             block ``d XOR stride / B`` through ``_halo.exchange_stride``
             (a power-of-two D); the slot picked on the host from t
  global     all_to_all's mean (``_halo.global_mean``); spread's
             ``(p + i*stride + t - 1) % W`` gather from
             ``_halo.gather_global`` and its mean over the fanout, duplicates
             included, as the reference computes it; t comes from a step
             counter on each shard's device that the t = 0 body resets and
             each step advances, so one graph serves every t; trivial: the
             body alone

At D > 1 the state a run takes and gives is a tuple of D shards
(``Runtime.build`` wraps it to take the global state, `_capture.ShardedRun`).
``dispatches_per_run`` counts one shard's device operations (the
reference's per-device program), the transports' copies apart;
``body_launches_per_run`` counts the K1/K2 launches of every shard.

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
from repro_torch.core.runtimes._capture import HostLoop, ReplayLoop, ShardedRun, clone_states
from repro_torch.core.runtimes.base import Runtime, register
from repro_torch.core.runtimes.fused import _body_ops
from repro_torch.core.task_kernels import apply_kernel

#: Device operations of each step part, on each shard (a test counts them):
#: the halo step's concatenation of its halos; the window combine (weight,
#: sum, divide); the butterfly shuffle (row gather, add, halve; off the
#: block: add, halve); all_to_all's mean (sum, divide) and its materialized
#: broadcast, across shards also the partial sum; spread's gather (ids from
#: the counter: add, remainder; the counter's advance; row gather; mean);
#: the counter's reset in the t = 0 body; the masked freeze of a finished
#: ensemble member.
_WRAP_OPS, _COMBINE_OPS, _SHUFFLE_OPS = 1, 3, 3
_ALL_TO_ALL_OPS, _SPREAD_OPS, _RESET_OPS, _FREEZE_OPS = 3, 5, 1, 1

#: A state over the shards: one tensor per shard, in shard order.
Shards = List[torch.Tensor]
#: (init(shards) -> shards, step(shards, t) -> shards): one member's t = 0
#: body and its superstep
MemberSteps = Tuple[Callable[[Shards], Shards], Callable[[Shards, int], Shards]]


def _members(work) -> Tuple[TaskGraph, ...]:
    return work.members if isinstance(work, GraphEnsemble) else (work,)


class _BspBase(Runtime):
    """Shared machinery for bsp / bsp_scan / overlap."""

    known_options: Tuple[str, ...] = ("use_kernels",)
    sharded = True

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

    # ---------------------------------------------------------- the shards

    def _per_device(self, make: Callable) -> List:
        """``make(device)`` once per distinct device, listed per shard."""
        made = {dev: make(dev) for dev in dict.fromkeys(self.devices)}
        return [made[dev] for dev in self.devices]

    def _bodies_of(self, graph: TaskGraph) -> Callable[[Shards], Shards]:
        body = self._body(graph)
        return lambda xs: self._map(lambda d, x: body(x), xs)

    def _exchange(self, locals_: Shards, r: int):
        """(left halos, right halos) per shard: the wrap on one device."""
        if self.mesh is None:
            left, right = _halo.exchange_halos(locals_[0], r)
            return [left], [right]
        return _halo.exchange_halos(locals_, r, self.mesh)

    def _combines(self, graph: TaskGraph) -> List[_halo.HaloCombine]:
        return self._per_device(lambda dev: _halo.make_halo_combine(graph, dev))

    def _fork(self) -> None:
        if self.mesh is not None:
            self.mesh.fork()

    def _join(self, *outputs: Shards) -> None:
        if self.mesh is not None:
            self.mesh.join(*outputs)

    def _in(self, x) -> Shards:
        """A run's input state as shards: one tensor on one device."""
        return [x] if self.mesh is None else list(x)

    def _out(self, shards: Shards):
        return shards[0] if self.mesh is None else tuple(shards)

    # ---------------------------------------------------------- step bodies

    def _make_halo_step(self, graph: TaskGraph) -> Callable[[Shards], Shards]:
        r = _patterns.halo_radius(graph)
        B = self._block(graph)
        combine = self._combines(graph)
        body = self._body(graph)

        def step(locals_):  # D x (B, payload)
            if r == 0:
                return self._map(lambda d, x: body(combine[d](x, B, d * B)), locals_)
            lefts, rights = self._exchange(locals_, r)
            return self._map(
                lambda d, x, lh, rh: body(combine[d](torch.cat([lh, x, rh]), B, d * B)),
                locals_, lefts, rights)

        return step

    def _make_butterfly_steps(self, graph: TaskGraph) -> List[Callable]:
        """One step body per period slot (pairing distance 2^k). A stride
        below the block pairs rows within a shard: the local row shuffle
        ``local[j ^ stride]`` (clamped to the block, as the reference's
        gather clamps, which only W = 1 reaches); a stride of a block or
        more pairs whole shards, d and d XOR stride / B, through the
        stride exchange."""
        B = self._block(graph)
        body = self._body(graph)
        j = np.arange(B)

        def make(stride: int) -> Callable:
            if self.mesh is not None and stride >= B:
                bs = stride // B

                def step(locals_):
                    partners, = _halo.exchange_stride(self.mesh, locals_, (bs,),
                                                      impl="ppermute")
                    return self._map(lambda d, x, p: body((x + p) * 0.5), locals_, partners)

                return step
            rows = self._per_device(
                lambda dev: torch.from_numpy(np.minimum(j ^ stride, B - 1)).to(dev))

            def step(locals_):
                return self._map(
                    lambda d, x: body((x + x.index_select(0, rows[d])) * 0.5), locals_)

            return step

        return [make(s) for s in _patterns.butterfly_slot_strides(graph)]

    def _make_global_step(self, graph: TaskGraph) -> Tuple[Callable, Callable]:
        """(init, step) of a global pattern; spread's step reads t from a
        counter on each shard's device, which init resets to 1 and each
        step advances."""
        W, B = graph.width, self._block(graph)
        body = self._body(graph)
        init = self._bodies_of(graph)
        if graph.pattern == "all_to_all":
            def step(locals_):
                if self.mesh is None:
                    means = [_halo.global_mean(locals_[0], W)]
                else:
                    means = _halo.global_mean(locals_, W, self.mesh)
                return self._map(
                    lambda d, x, m: body(m[None, :].expand_as(x).contiguous()),
                    locals_, means)

            return init, step
        if graph.pattern == "spread":
            stride = max(1, W // graph.fanout)
            # (p + i*stride - 1) from shard d's first point d*B: the step's
            # ids are (base + t) % W
            p = np.arange(B)
            base = [torch.from_numpy(d * B + p[:, None] + np.arange(graph.fanout)[None, :]
                                     * stride - 1).to(dev)
                    for d, dev in enumerate(self.devices)]
            t_dev = [torch.ones((), dtype=torch.int64, device=dev) for dev in self.devices]

            def init_spread(locals_):
                def one(d, x):
                    t_dev[d].fill_(1)
                    return body(x)

                return self._map(one, locals_)

            def step(locals_):
                def ids_of(d, x):
                    ids = torch.remainder(base[d] + t_dev[d], W)  # (B, fanout)
                    t_dev[d].add_(1)
                    return ids

                ids = self._map(ids_of, locals_)
                if self.mesh is None:
                    fulls = [_halo.gather_global(locals_[0])]
                else:
                    fulls = _halo.gather_global(locals_, self.mesh)
                return self._map(lambda d, i, f: body(f[i].mean(dim=1)), ids, fulls)

            return init_spread, step
        if graph.pattern == "trivial":
            return init, init
        raise ValueError(graph.pattern)

    def _supersteps(self, graph: TaskGraph) -> Tuple[List[Callable], Callable[[int], int]]:
        """(the distinct step bodies of one graph, each over the shards; t
        -> the index of the one timestep t runs): the t = 0 body first,
        then the halo step, each butterfly period slot (picked on the host
        from t), or the global step."""
        pat = graph.pattern
        if pat in _patterns.HALO_PATTERNS or pat == "random_nearest":
            return [self._bodies_of(graph), self._make_halo_step(graph)], lambda t: min(t, 1)
        if pat in _patterns.BUTTERFLY_PATTERNS:
            period = graph.period
            return ([self._bodies_of(graph), *self._make_butterfly_steps(graph)],
                    lambda t: 0 if t == 0 else 1 + (t - 1) % period)
        return list(self._make_global_step(graph)), lambda t: min(t, 1)

    def _make_member_step(self, graph: TaskGraph) -> MemberSteps:
        """(init, step(shards, t)) for one graph: the building block of the
        one-graph loops (bsp_scan's single graphs and ensembles)."""
        bodies, pick = self._supersteps(graph)
        return bodies[0], lambda local, t: bodies[pick(t)](local)

    def _step_ops(self, graph: TaskGraph, t: int = 1) -> Tuple[int, int]:
        """Device operations of (the t = 0 body, timestep t's superstep) on
        one shard, as `_make_member_step` issues them (the transports
        apart)."""
        body = _body_ops(graph.kernel, self._use_kernels())
        pat = graph.pattern
        if pat in _patterns.HALO_PATTERNS or pat == "random_nearest":
            r = _patterns.halo_radius(graph)
            return body, body + (_WRAP_OPS + _COMBINE_OPS if r else 0)
        if pat in _patterns.BUTTERFLY_PATTERNS:
            strides = _patterns.butterfly_slot_strides(graph)
            off_block = (self.mesh is not None
                         and strides[(t - 1) % graph.period] >= self._block(graph))
            return body, body + _SHUFFLE_OPS - off_block  # no row gather
        if pat == "all_to_all":
            return body, body + _ALL_TO_ALL_OPS + (self.num_devices > 1)
        if pat == "spread":
            return body + _RESET_OPS, body + _SPREAD_OPS
        return body, body  # trivial

    def _step_bodies(self, graph: TaskGraph) -> int:
        """Body applications of one superstep on one shard."""
        return 1

    def _bodies(self, graph: TaskGraph, steps: int) -> int:
        """K1/K2 launches of ``steps`` timesteps of ``graph`` with the
        kernels, every shard's: the t = 0 body and each superstep's bodies
        (none for the empty body)."""
        if graph.kernel.kind == "empty" or graph.kernel.iterations == 0:
            return 0
        return self.num_devices * (1 + (steps - 1) * self._step_bodies(graph))

    def body_launches_per_run(self, work) -> int:
        """K1/K2 launches of one run of ``work`` (a graph or an ensemble)
        with ``use_kernels``, over every shard. A one-graph loop steps every
        member at every timestep of the run, a finished member's result
        masked by the freeze."""
        members = _members(work)
        T = max(g.steps for g in members)
        return sum(self._bodies(g, T) for g in members)

    def _loop_ops(self, work) -> int:
        """Device operations of a one-graph loop over ``work``'s members on
        one shard: each member's t = 0 body and T - 1 supersteps, and with
        mixed horizons a freeze a step for each member shorter than the
        run."""
        members = _members(work)
        T = max(g.steps for g in members)
        total = 0
        for g in members:
            total += self._step_ops(g)[0] + sum(
                self._step_ops(g, t)[1] + (_FREEZE_OPS if g.steps < T else 0)
                for t in range(1, T))
        return total

    def _one_graph_loop(self, members: Sequence[TaskGraph],
                        member_steps: Sequence[MemberSteps]) -> Callable:
        """The eager loop of every member in one program: each member's t =
        0 body, then per timestep each member's superstep in member order, a
        member past its own T frozen by ``torch.where`` on a static (T, K)
        activity table (the reference's masked freeze). It takes and gives
        a tuple of member states (at D > 1 each a tuple of shards); at D > 1
        it forks the shards' streams first and joins them last."""
        T = max(g.steps for g in members)
        table = GraphEnsemble(members).active_table()
        active = self._per_device(lambda dev: torch.from_numpy(table).to(dev))

        def run(inits):
            self._fork()
            states = [init(self._in(x)) for (init, _), x in zip(member_steps, inits)]
            for t in range(1, T):
                for k, (g, (_, step)) in enumerate(zip(members, member_steps)):
                    n = step(states[k], t)
                    if g.steps < T:  # masked freeze past this member's T
                        n = self._map(lambda d, a, b: torch.where(active[d][t, k], a, b),
                                      n, states[k])
                    states[k] = n
            self._join(*states)
            return tuple(self._out(s) for s in states)

        return run


@register
class BspRuntime(_BspBase):
    name = "bsp"
    known_options = ("use_kernels", "donate")

    def _host_loop(self, members: Sequence[TaskGraph]) -> HostLoop:
        """One program per (step body, buffer parity) a run uses, each
        ``dst.copy_(body(src))`` on static buffers, for every shard at once
        (at D > 1 forking the shards' streams first and joining them last),
        and the host calls in round-robin order: per timestep one call per
        member still within its own T, in member order, none for a frozen
        member."""
        donate = bool(self.options.get("donate", True))
        programs: List[Callable[[], None]] = []
        index = {}
        calls: List[List[int]] = []  # per member, the program of each timestep
        buffers: List[List[Shards]] = []
        for k, g in enumerate(members):
            bodies, pick = self._supersteps(g)
            B = self._block(g)
            bufs = [[torch.zeros((B, g.payload), dtype=torch.float32, device=dev)
                     for dev in self.devices] for _ in range(1 if donate else 2)]
            buffers.append(bufs)
            mine = []
            for t in range(g.steps):
                src, dst = (0, 0) if donate else (t % 2, (t + 1) % 2)
                key = (k, pick(t), src)
                if key not in index:
                    def program(f=bodies[pick(t)], a=bufs[src], b=bufs[dst]):
                        self._fork()
                        self._map(lambda d, out, new: out.copy_(new), b, f(list(a)))
                        self._join()
                    index[key] = len(programs)
                    programs.append(program)
                mine.append(index[key])
            calls.append(mine)
        order = [calls[k][t] for t in range(max(g.steps for g in members))
                 for k, g in enumerate(members) if t < g.steps]

        def stage(xs):
            for bufs, x in zip(buffers, xs):
                for buf, shard in zip(bufs[0], self._in(x)):
                    buf.copy_(shard)

        def output():
            return tuple(self._out(bufs[0 if donate else g.steps % 2])
                         for bufs, g in zip(buffers, members))

        return HostLoop(stage, programs, order, output)

    def _build_eager(self, graph: TaskGraph) -> HostLoop:
        loop = self._host_loop((graph,))
        return HostLoop(lambda x: loop.stage((x,)), loop.programs, loop.order,
                        lambda: loop.output()[0])

    def _build_ensemble_eager(self, ensemble: GraphEnsemble) -> HostLoop:
        return self._host_loop(ensemble.members)

    def _build_traced(self, graph: TaskGraph) -> Callable:
        """Spans a superstep over the host loop (`_host_loop`), its programs
        called eagerly: ``dispatch`` is the host call issuing one superstep
        (``t0_dispatch``, then ``superstep_dispatch``), ``compute.interior``
        the wait for it to finish on every shard (``t0_compute``, then
        ``superstep``). The exchange runs inside the superstep (MPI's
        exchange and compute are one call here by construction), so its wall
        lands in the compute span, as in the reference."""
        loop = self._build_eager(graph)
        tr = self.tracer

        def run(x):
            loop.stage(x)
            self._drain()
            for t, i in enumerate(loop.order):
                with tr.span("superstep_dispatch" if t else "t0_dispatch", "dispatch",
                             step=t):
                    loop.programs[i]()
                attrs = {"pattern": graph.pattern} if t else {}
                with tr.span("superstep" if t else "t0_compute", "compute.interior",
                             step=t, **attrs):
                    self._drain()
            return clone_states(loop.output())

        return run

    def _replayed(self, loop: HostLoop):
        """On the card each distinct superstep captured as its own CUDA
        graph and replayed once a host call (`_capture.ReplayLoop`): the
        whole run is never one graph. On the CPU, or with the shards on
        distinct cards, the host loop itself. At D > 1 wrapped to take
        and give the global state (`_capture.ShardedRun`)."""
        if self.device.type == "cuda" and (self.mesh is None or self.mesh.one_card):
            loop = ReplayLoop(loop, self.device)
        return loop if self.mesh is None else ShardedRun(loop, self._split, self._gather)

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
        """Device operations one run issues on one shard: the t = 0 body
        and T - 1 supersteps, each followed by its copy into the state
        buffer."""
        return self._step_ops(graph)[0] + sum(
            self._step_ops(graph, t)[1] for t in range(1, graph.steps)) + graph.steps

    def host_calls_per_run(self, work) -> int:
        """One host call per superstep: T per graph, and per ensemble the
        members' own T summed (a frozen member makes no call)."""
        return sum(g.steps for g in _members(work))

    def body_launches_per_run(self, work) -> int:
        """K1/K2 launches of one run with ``use_kernels``, every shard's:
        each member's bodies within its own T (a frozen member makes no
        call)."""
        return sum(self._bodies(g, g.steps) for g in _members(work))


@register
class BspScanRuntime(_BspBase):
    """BSP with the timestep loop in one CUDA graph (amortised dispatch)."""

    name = "bsp_scan"
    known_options = ("use_kernels", "unroll")

    def _build_eager(self, graph: TaskGraph) -> Callable:
        loop = self._one_graph_loop((graph,), (self._make_member_step(graph),))
        return lambda init: loop((init,))[0]

    def _build_ensemble_eager(self, ensemble: GraphEnsemble) -> Callable:
        """Every member in one program (one graph on the card): per timestep
        each member's superstep, in member order."""
        members = ensemble.members
        return self._one_graph_loop(members, [self._make_member_step(g) for g in members])

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Device operations one run issues on one shard: the t = 0 body
        and T - 1 supersteps (every one a node of the run's graph)."""
        return self._loop_ops(graph)

    def ensemble_dispatches_per_run(self, ensemble: GraphEnsemble) -> int:
        return self._loop_ops(ensemble)
