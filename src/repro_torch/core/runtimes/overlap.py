"""`overlap` runtime: overdecomposed and communication-hiding (the
Charm++/HPX analogue), over D row shards.

Counterpart of ``repro.core.runtimes.overlap``. The AMT value proposition
the paper studies (§6.2): give each core N > 1 tasks so the runtime can run
ready tasks while messages for the others are in flight. Each shard owns
B = width / devices points, and every timestep is split: the halo exchange
is issued first, then the B - 2r interior points (all of whose inputs are
local) are combined and run through the body, then the top and bottom r
boundary points from their 3r-row contexts, which hold the received halos.
That is three body applications a step and shard (three K1 or K2 launches
with ``use_kernels``). The whole timestep loop is one CUDA graph on the
card (``Runtime.build``), as the reference's is one ``lax.scan``.

At D > 1 the exchange is ``_halo``'s "ppermute" transport: its copies run
on the receiving shards' transfer streams, and each shard's interior, issued on the shard's
own stream between the transport's start and its join, runs under them;
the boundary waits for the join. That is the paper's latency hiding, on
one card between D shards, and across cards by the same code. On one
device there is no transfer to hide: the halos are two views of the
state (``_halo.exchange_halos``), so the rung measures the cost of the
split step alone.

Options (the reference's Fig-3-style build options):
  use_kernels         the body as the CUDA kernels K1 / K2
  overlap=False       the join before any compute, then the boundary first
                      (no latency hiding): the "simplified scheduling path"
                      ablation
  halo_via="allgather"  take the halos from the whole ring (the transport
                      ablation): ``_halo.gather_global``'s "xla" gather,
                      started before the interior and joined after it, then
                      roll the global state and slice the shard's halos
  unroll=k            the reference's scan unroll factor: accepted, and it
                      changes nothing here, the capture already unrolls
                      every step
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from repro_torch.core import patterns as _patterns
from repro_torch.core.graph import GraphEnsemble, TaskGraph
from repro_torch.core.runtimes import _halo
from repro_torch.core.runtimes.base import register
from repro_torch.core.runtimes.bsp import _COMBINE_OPS, _BspBase
from repro_torch.core.runtimes.fused import _body_ops

HALO_VIA = ("ppermute", "allgather")
#: Device operations of a split step besides its combines and bodies: the
#: two boundary contexts' concatenations and the result's; the all-gather
#: transport's two rolls.
_SPLIT_OPS, _ALLGATHER_OPS = 3, 2


@register
class OverlapRuntime(_BspBase):
    name = "overlap"
    known_options = ("use_kernels", "overlap", "halo_via", "unroll")

    def __init__(self, device="cuda", devices=None, **options):
        super().__init__(device, devices, **options)
        if str(self.options.get("halo_via", "ppermute")) not in HALO_VIA:
            raise ValueError(f"runtime overlap: unknown halo_via "
                             f"{self.options['halo_via']!r}; known {list(HALO_VIA)}")

    def supports(self, graph: TaskGraph):
        ok, why = super().supports(graph)
        if not ok:
            return ok, why
        pat = graph.pattern
        if pat not in _patterns.HALO_PATTERNS and pat != "random_nearest":
            return False, f"overlap models halo patterns; {pat} is not one"
        r = _patterns.halo_radius(graph)
        B = self._block(graph)
        if r > 0 and B < 2 * r:
            return False, (
                f"block {B} < 2*radius {r}: no interior to overlap "
                f"(increase overdecomposition)"
            )
        return True, ""

    def _fetch_start(self, locals_: List[torch.Tensor], r: int, B: int,
                     halo_via: str) -> Callable[[], Tuple[list, list]]:
        """Start the halo fetch; returns its join, which gives (left halos,
        right halos) per shard. On one device the halos are there at once
        (views, or the all-gather's rolls); at D > 1 the join is the
        transport's, and the all-gather's rolls follow it."""
        if self.mesh is None:
            if halo_via == "allgather":
                full = _halo.gather_global(locals_[0])  # (W, P)
                # this device's block starts at row 0
                halos = [torch.roll(full, r, 0)[:r]], [torch.roll(full, -B, 0)[:r]]
            else:
                halos = self._exchange(locals_, r)
            return lambda: halos
        if halo_via == "allgather":
            handle = _halo.gather_global_start(self.mesh, locals_)

            def join():
                fulls = handle.join()
                pairs = self._map(
                    lambda d, f: (torch.roll(f, r, 0)[d * B:d * B + r],
                                  torch.roll(f, -B, 0)[d * B:d * B + r]), fulls)
                return [a for a, _ in pairs], [b for _, b in pairs]

            return join
        handle = _halo.exchange_halos_start(self.mesh, locals_, r, impl="ppermute")
        return handle.join

    def _make_overlap_step(self, graph: TaskGraph) -> Callable:
        """step(shards) for one timestep of one graph, halo-first ordering."""
        do_overlap = bool(self.options.get("overlap", True))
        halo_via = str(self.options.get("halo_via", "ppermute"))
        B = self._block(graph)
        r = _patterns.halo_radius(graph)
        combine = self._combines(graph)
        body = self._body(graph)

        def step(locals_):  # D x (B, payload)
            if r == 0:
                return self._map(lambda d, x: body(combine[d](x, B, d * B)), locals_)
            if not do_overlap:  # the join before any compute
                halos = self._fetch_start(locals_, r, B, halo_via)()
                fetched = lambda: halos
            else:
                fetched = self._fetch_start(locals_, r, B, halo_via)

            def interior():
                # rows r .. B-r-1; their full window lives in the shard
                if B == 2 * r:
                    return [x[r:r] for x in locals_]
                return self._map(lambda d, x: body(combine[d](x, B - 2 * r, d * B + r)),
                                 locals_)

            def boundary():
                lefts, rights = fetched()

                def edges(d, x, lh, rh):
                    ctx_top = torch.cat([lh, x[:2 * r]])
                    ctx_bot = torch.cat([x[B - 2 * r:], rh])
                    return (body(combine[d](ctx_top, r, d * B)),
                            body(combine[d](ctx_bot, r, d * B + B - r)))

                pairs = self._map(edges, locals_, lefts, rights)
                return [a for a, _ in pairs], [b for _, b in pairs]

            if do_overlap:
                # interior first: no data dependence on the exchange
                mid = interior()
                top, bot = boundary()
            else:
                top, bot = boundary()
                mid = interior()
            return self._map(lambda d, a, m, b: torch.cat([a, m, b]), top, mid, bot)

        return step

    def _member(self, graph: TaskGraph):
        step = self._make_overlap_step(graph)
        return self._bodies_of(graph), lambda local, t: step(local)

    def _build_eager(self, graph: TaskGraph) -> Callable:
        loop = self._one_graph_loop((graph,), (self._member(graph),))
        return lambda init: loop((init,))[0]

    def _build_ensemble_eager(self, ensemble: GraphEnsemble) -> Callable:
        """The paper's §6.2 workload: K overdecomposed graphs in one program
        (one graph on the card), each member's split step in member order."""
        members = ensemble.members
        return self._one_graph_loop(members, [self._member(g) for g in members])

    def _step_ops(self, graph: TaskGraph, t: int = 1) -> Tuple[int, int]:
        """Device operations of (the t = 0 body, one split step) on one
        shard (the transports apart)."""
        body = _body_ops(graph.kernel, self._use_kernels())
        r = _patterns.halo_radius(graph)
        if r == 0:
            return body, body
        interior = _COMBINE_OPS + body if self._block(graph) > 2 * r else 0
        transport = _ALLGATHER_OPS if self.options.get("halo_via") == "allgather" else 0
        return body, interior + 2 * (_COMBINE_OPS + body) + _SPLIT_OPS + transport

    def _step_bodies(self, graph: TaskGraph) -> int:
        """Body applications of one split step on one shard: interior, top
        and bottom (no interior when B = 2r; the whole block when r = 0)."""
        r = _patterns.halo_radius(graph)
        if r == 0:
            return 1
        return 3 if self._block(graph) > 2 * r else 2

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Device operations one run issues on one shard: the t = 0 body
        and T - 1 split steps (every one a node of the run's graph)."""
        return self._loop_ops(graph)

    def ensemble_dispatches_per_run(self, ensemble: GraphEnsemble) -> int:
        return self._loop_ops(ensemble)
