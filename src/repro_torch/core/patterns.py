"""Dependence patterns for Task Bench task graphs.

A copy of ``repro.core.patterns`` (pure numpy): the port imports nothing of
the JAX package, and the tests hold the two byte-equal.

Pattern definitions follow Task Bench (Slaughter et al., SC'20, arXiv:1908.05790)
in spirit; each is documented precisely here since the exact index arithmetic is
normative for all runtime backends (they must agree bit-for-bit).

All functions answer: which points at timestep ``t-1`` does point ``p`` at
timestep ``t`` depend on? (t >= 1.)

Patterns:
  trivial              no dependencies at all (embarrassingly parallel tasks).
  no_comm              depend only on self: {p}.
  stencil_1d           {p-1, p, p+1} clipped to [0, W).
  stencil_1d_periodic  {p-1, p, p+1} mod W.
  dom                  wavefront/dominance sweep: {p-1, p} clipped (lower-
                       triangular dataflow, models sweeps like LU/Gauss-Seidel).
  tree                 binary reduce/broadcast ladder with period 2*log2(W):
                       first log2(W) steps reduce (p pairs with p XOR 2^k for
                       k rising), next log2(W) steps broadcast back (k falling).
                       Every point stays live (Task Bench keeps width constant);
                       the pairing distance is what contracts/expands.
  fft                  butterfly: {p, p XOR 2^(t-1 mod log2(W))}.
  all_to_all           every point: {0, ..., W-1}.
  nearest              {p-radius, ..., p+radius} mod W.
  spread               ``fanout`` points spread across the width, rotating with
                       t: {(p + i*W//fanout + (t-1)) mod W : i in [0, fanout)}.
  random_nearest       deterministic random subset of the nearest window
                       (seeded per graph; same seed => same graph).
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.graph import TaskGraph

PATTERNS = (
    "trivial",
    "no_comm",
    "stencil_1d",
    "stencil_1d_periodic",
    "dom",
    "tree",
    "fft",
    "all_to_all",
    "nearest",
    "spread",
    "random_nearest",
)

#: Patterns whose cross-device traffic is carried by halo exchange (ppermute)
#: in the distributed runtimes.
HALO_PATTERNS = ("no_comm", "stencil_1d", "stencil_1d_periodic", "dom", "nearest")
#: Patterns carried by XOR block permutes.
BUTTERFLY_PATTERNS = ("fft", "tree")
#: Patterns requiring full gather.
GLOBAL_PATTERNS = ("all_to_all", "spread", "random_nearest")


def _log2(w: int) -> int:
    return int(math.log2(w))


def period(g: "TaskGraph") -> int:
    if g.pattern == "fft":
        return max(1, _log2(g.width))
    if g.pattern == "tree":
        return max(1, 2 * _log2(g.width))
    if g.pattern == "spread":
        return g.width  # rotation repeats every W steps
    return 1


def max_deps(g: "TaskGraph") -> int:
    return {
        "trivial": 1,  # keep >=1 so array shapes stay non-degenerate
        "no_comm": 1,
        "stencil_1d": 3,
        "stencil_1d_periodic": 3,
        "dom": 2,
        "tree": 2,
        "fft": 2,
        "all_to_all": g.width,
        "nearest": 2 * g.radius + 1,
        "spread": g.fanout,
        "random_nearest": 2 * g.radius + 1,
    }[g.pattern]


def _rng_for(g: "TaskGraph", p: int) -> np.random.Generator:
    # Stable per-(graph, point) stream: the random_nearest neighborhood is
    # fixed across timesteps (matches Task Bench's use of a fixed random
    # graph rather than fresh randomness each step, which would defeat
    # caching in real runtimes too). Timestep-independence is why the
    # pattern's period is 1.
    return np.random.default_rng((g.seed * 1_000_003 + p) & 0x7FFFFFFF)


def dependencies(g: "TaskGraph", t: int, p: int) -> Tuple[int, ...]:
    W = g.width
    pat = g.pattern
    if pat == "trivial":
        return ()
    if pat == "no_comm":
        return (p,)
    if pat == "stencil_1d":
        return tuple(q for q in (p - 1, p, p + 1) if 0 <= q < W)
    if pat == "stencil_1d_periodic":
        return ((p - 1) % W, p, (p + 1) % W)
    if pat == "dom":
        return tuple(q for q in (p - 1, p) if 0 <= q < W)
    if pat == "fft":
        k = (t - 1) % max(1, _log2(W))
        partner = p ^ (1 << k)
        return (p, partner) if partner < W else (p,)
    if pat == "tree":
        L = max(1, _log2(W))
        s = (t - 1) % (2 * L)
        k = s if s < L else (2 * L - 1 - s)  # rise then fall
        partner = p ^ (1 << k)
        return (p, partner) if partner < W else (p,)
    if pat == "all_to_all":
        return tuple(range(W))
    if pat == "nearest":
        return tuple((p + d) % W for d in range(-g.radius, g.radius + 1))
    if pat == "spread":
        stride = max(1, W // g.fanout)
        return tuple(sorted({(p + i * stride + (t - 1)) % W for i in range(g.fanout)}))
    if pat == "random_nearest":
        rng = _rng_for(g, p)
        window = [(p + d) % W for d in range(-g.radius, g.radius + 1)]
        keep = rng.random(len(window)) < 0.5
        keep[g.radius] = True  # always keep self so graphs stay connected
        return tuple(sorted({w for w, k in zip(window, keep) if k}))
    raise ValueError(f"unknown pattern {pat!r}")


def halo_radius(g: "TaskGraph") -> int:
    """Cross-point reach of the pattern (for halo-exchange runtimes)."""
    return {
        "trivial": 0,
        "no_comm": 0,
        "stencil_1d": 1,
        "stencil_1d_periodic": 1,
        "dom": 1,
        "nearest": g.radius,
        "random_nearest": g.radius,
    }.get(g.pattern, -1)  # -1 => not halo-expressible


def butterfly_stride(g: "TaskGraph", slot: int) -> int:
    """XOR pairing distance 2^k for period slot ``slot`` of a butterfly
    pattern: timestep t uses slot (t-1) % period. fft's exponent rises
    0..L-1 and wraps; tree rises 0..L-1 then falls back (reduce /
    broadcast ladder). Graph validation guarantees a power-of-two width,
    so partner = p XOR stride is always in [0, W) and every point has
    exactly two dependencies {p, partner}.
    """
    if g.pattern not in BUTTERFLY_PATTERNS:
        raise ValueError(f"{g.pattern} is not a butterfly pattern")
    L = max(1, _log2(g.width))
    if g.pattern == "fft":
        return 1 << (slot % L)
    k = slot % (2 * L)
    return 1 << (k if k < L else (2 * L - 1 - k))


def butterfly_slot_strides(g: "TaskGraph") -> Tuple[int, ...]:
    """Pairing distance per period slot (length ``period(g)``)."""
    return tuple(butterfly_stride(g, s) for s in range(period(g)))
