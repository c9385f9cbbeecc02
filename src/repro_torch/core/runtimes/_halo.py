"""The halo dataflow the bulk-synchronous backends share, on one device.

Counterpart of ``repro.core.runtimes._halo``, its one-device part. Points are
block-distributed: device d owns rows [d*B, (d+1)*B) of the global
(W, payload) state. Halo patterns (stencil/dom/nearest/...) reach at most
``r = halo_radius`` points across, so one ring exchange of r edge rows per
direction supplies every remote input. On one device B = W, and the ring
exchange is the wrap: the last r rows come in on the left and the first r
on the right, as views of the state.

``make_halo_combine`` builds a combine that matches
``task_kernels.combine_dependencies`` (the mean over live deps) on every
halo pattern: its masks mirror ``patterns.dependencies`` for every edge case
(global edges, dom's asymmetry, random_nearest's keep set). It sums each
window's 2r+1 terms in another order than the padded gather does, so the
two agree to f32 rounding, not bit for bit.

Every function takes ``num_devices``, and only 1 so far. Not ported yet
(ROADMAP.md Queue 1 item 8, the multi-rank transports): more than one
device, multi-hop halos (r > B), the async ``*_start``/``*_join`` handles,
``HALO_ASYNC_IMPLS``, ``STRIDE_ASYNC_IMPLS``, ``GATHER_IMPLS``,
``TRANSPORT_REGISTRIES``, and the chunked and ppermute gathers.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import patterns as _patterns
from repro_torch.core.graph import TaskGraph


def _one_device(num_devices: int) -> None:
    if num_devices != 1:
        raise NotImplementedError(
            f"num_devices={num_devices}: the port's halo dataflow runs on one "
            f"device so far; the multi-rank transports are ROADMAP.md Queue 1 "
            f"item 8")


def offset_keep(graph: TaskGraph) -> np.ndarray:
    """Which window offsets [-r..r] the pattern actually consumes."""
    r = _patterns.halo_radius(graph)
    offsets = np.arange(-r, r + 1)
    if graph.pattern == "no_comm":
        return offsets == 0
    if graph.pattern == "dom":
        return offsets <= 0
    # stencil_1d(_periodic), nearest, random_nearest: whole window
    return np.ones_like(offsets, dtype=bool)


def random_keep_table(graph: TaskGraph) -> Optional[np.ndarray]:
    """(W, 2r+1) keep mask for random_nearest; None for other patterns."""
    if graph.pattern != "random_nearest":
        return None
    r = graph.radius
    W = graph.width
    keep = np.zeros((W, 2 * r + 1), dtype=np.float32)
    for p in range(W):
        deps = set(_patterns.dependencies(graph, 1, p))
        for j, o in enumerate(range(-r, r + 1)):
            if (p + o) % W in deps:
                keep[p, j] = 1.0
    return keep


class HaloCombine:
    """``combine(ctx, n, p0) -> (n, payload)``, built by `make_halo_combine`.

    ``ctx`` holds the (n + 2r, payload) rows that give each output row its
    full window: output row i consumes ctx rows [i, i + 2r]. ``n`` is the
    number of output rows and ``p0`` the global point of output row 0 (for
    edge masking), both host integers. Each (n, p0)'s mask and denominator
    are built once, on the host, and kept on ``device``; a call is three
    device operations (weight, sum, divide) on the windows, a view of ctx.
    """

    def __init__(self, graph: TaskGraph, device):
        self.r = _patterns.halo_radius(graph)
        if self.r < 0:
            raise ValueError(f"{graph.pattern} is not halo-expressible")
        self.keep = offset_keep(graph).astype(np.float32)
        self.nonperiodic = graph.pattern in ("stencil_1d", "dom")
        self.rand = random_keep_table(graph)
        self.width = graph.width
        self.device = torch.device(device)
        self._tables: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def tables(self, n: int, p0: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (n, 1, 2r+1) mask and the (n, 1) denominator of output rows
        p0 .. p0 + n - 1."""
        if (n, p0) not in self._tables:
            r, W = self.r, self.width
            mask = np.repeat(self.keep[None, :], n, axis=0)
            if self.nonperiodic:
                q = p0 + np.arange(n)[:, None] + np.arange(-r, r + 1)[None, :]
                mask *= (q >= 0) & (q < W)
            if self.rand is not None:
                mask *= self.rand[p0:p0 + n]
            denom = np.maximum(mask.sum(-1, keepdims=True), np.float32(1.0))
            self._tables[(n, p0)] = (
                torch.from_numpy(np.ascontiguousarray(mask[:, None, :])).to(self.device),
                torch.from_numpy(denom.astype(np.float32)).to(self.device))
        return self._tables[(n, p0)]

    def __call__(self, ctx: torch.Tensor, n: int, p0: int) -> torch.Tensor:
        if self.r == 0:  # no_comm, trivial: self only
            return ctx
        mask, denom = self.tables(n, p0)
        windows = ctx.unfold(0, 2 * self.r + 1, 1)  # (n, payload, 2r+1)
        return (windows * mask).sum(-1) / denom


def make_halo_combine(graph: TaskGraph, device="cpu") -> HaloCombine:
    """The window combine of a halo pattern (see `HaloCombine`)."""
    return HaloCombine(graph, device)


def exchange_halos(local: torch.Tensor, r: int, num_devices: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The r rows that sit immediately left and right of this device's
    (B, payload) block in global order, wrapped at the ends (the combine
    masks the wrap off for non-periodic patterns). On one device, the ring
    wrap: the block's last r rows and its first r, as views."""
    _one_device(num_devices)
    B = local.shape[0]
    if r > B:
        raise NotImplementedError(
            f"halo radius {r} exceeds block {B}: multi-hop halos are ROADMAP.md "
            f"Queue 1 item 8")
    return local[B - r:], local[:r]


def gather_global(local: torch.Tensor, num_devices: int = 1) -> torch.Tensor:
    """The full global-order state (the all-gather); on one device, the
    block itself."""
    _one_device(num_devices)
    return local


def global_mean(local: torch.Tensor, width: int, num_devices: int = 1) -> torch.Tensor:
    """Mean over the global row axis (the uniform all_to_all combine): the
    block's row sum over ``width``, two device operations."""
    _one_device(num_devices)
    return local.sum(dim=0) / width
