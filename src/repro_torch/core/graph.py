"""Task graph abstraction — the heart of Task Bench.

A task graph is ``steps`` timesteps x ``width`` parallel points. Each point at
timestep ``t`` depends on a pattern-defined set of points at timestep ``t-1``.
Executing the graph means executing every task (t, p) after its dependencies,
with each task running a grain-size-parameterized kernel (see task_kernels.py).

This mirrors Task Bench (Slaughter et al., SC'20) as used by the paper
"Quantifying Overheads in Charm++ and HPX using Task Bench": the graph is the
*workload*, the runtime (see runtimes/) is the *system under test*, and METG
(see metg.py) is the *metric*.

Counterpart of ``repro.core.graph``; the host-side tables are byte-equal to
the reference's. Dependence sets are materialized as padded index/mask
arrays so that every runtime backend consumes the same graph. The arrays have
a leading ``period`` dimension: patterns whose dependences change per timestep
(fft, tree) repeat with period log2(width), so we store one period and index by
``t % period`` instead of materializing all ``steps`` slices.
"""
from __future__ import annotations

import dataclasses
import math
from functools import cached_property
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core import patterns as _patterns
from repro_torch.core.task_kernels import KernelSpec


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class TaskGraph:
    """A parameterized Task Bench task graph.

    Attributes:
      steps:   number of timesteps (T). The paper uses 1000.
      width:   number of parallel points (W); typically #cores x overdecomposition.
      pattern: dependence pattern name, one of ``patterns.PATTERNS``.
      kernel:  grain-size-parameterized task body.
      payload: floats of output state per point (task output size).
      radius:  neighborhood radius for nearest/random_nearest.
      fanout:  dependence count for spread.
      seed:    RNG seed for random_nearest (deterministic graphs).
    """

    steps: int
    width: int
    pattern: str = "stencil_1d"
    kernel: KernelSpec = dataclasses.field(default_factory=KernelSpec)
    payload: int = 64
    radius: int = 1
    fanout: int = 3
    seed: int = 0

    def __post_init__(self):
        if self.pattern not in _patterns.PATTERNS:
            raise ValueError(
                f"unknown pattern {self.pattern!r}; known: {sorted(_patterns.PATTERNS)}"
            )
        if self.pattern in ("fft", "tree") and not _is_pow2(self.width):
            raise ValueError(f"pattern {self.pattern} requires power-of-two width")
        if self.steps < 1 or self.width < 1:
            raise ValueError("steps and width must be >= 1")
        if self.payload < 1:
            raise ValueError("payload must be >= 1")

    # ------------------------------------------------------------------ deps

    def dependencies(self, t: int, p: int) -> Tuple[int, ...]:
        """Points at timestep t-1 that task (t, p) consumes. Empty at t=0."""
        if t == 0:
            return ()
        if not 0 <= p < self.width:
            raise IndexError(f"point {p} outside [0, {self.width})")
        return _patterns.dependencies(self, t, p)

    def reverse_dependencies(self, t: int, p: int) -> Tuple[int, ...]:
        """Points at timestep t+1 that consume task (t, p)."""
        if t >= self.steps - 1:
            return ()
        return tuple(
            q for q in range(self.width) if p in _patterns.dependencies(self, t + 1, q)
        )

    @cached_property
    def period(self) -> int:
        """Timestep periodicity of the dependence sets."""
        return _patterns.period(self)

    @cached_property
    def max_deps(self) -> int:
        return _patterns.max_deps(self)

    def dependency_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Padded dependence arrays.

        Returns:
          idx:  int32 (period, width, max_deps) — dependency point ids, padded
                with 0 where masked out.
          mask: float32 (period, width, max_deps) — 1.0 for live deps, else 0.0.

        Timestep ``t >= 1`` uses slice ``(t - 1) % period`` (t=0 has no deps).
        """
        P, W, D = self.period, self.width, self.max_deps
        idx = np.zeros((P, W, D), dtype=np.int32)
        mask = np.zeros((P, W, D), dtype=np.float32)
        for s in range(P):
            t = s + 1  # slice s serves timesteps t with (t-1) % period == s
            for p in range(W):
                deps = _patterns.dependencies(self, t, p)
                for j, d in enumerate(deps):
                    idx[s, p, j] = d
                    mask[s, p, j] = 1.0
        return idx, mask

    # ----------------------------------------------------------------- stats

    @property
    def num_tasks(self) -> int:
        return self.steps * self.width

    @cached_property
    def num_dependencies(self) -> int:
        """Total dependence edges in the graph."""
        _, mask = self.dependency_arrays()
        per_period = mask.sum(axis=(1, 2))
        total = 0.0
        for t in range(1, self.steps):
            total += per_period[(t - 1) % self.period]
        return int(total)

    def flops_per_task(self) -> int:
        return self.kernel.flops(self.payload)

    def bytes_per_task(self) -> int:
        return self.kernel.bytes(self.payload)

    def total_flops(self) -> int:
        return self.num_tasks * self.flops_per_task()

    def describe(self) -> str:
        return (
            f"TaskGraph({self.pattern}, T={self.steps}, W={self.width}, "
            f"payload={self.payload}, kernel={self.kernel.kind}"
            f"@{self.kernel.iterations}it, deps<= {self.max_deps}, "
            f"period={self.period})"
        )


@dataclasses.dataclass(frozen=True)
class GraphEnsemble:
    """K independent task graphs executed concurrently (Task Bench ``-and``).

    This is the paper's §6.2 latency-hiding workload: give each core more
    than one graph's worth of tasks so the runtime can execute a ready task
    from graph A while graph B's messages are in flight. Members may differ
    in pattern, grain, payload, width, AND ``steps``: the interleaved
    backends drive all members from ONE timestep loop of ``max(steps)``
    iterations (the lockstep composition Task Bench itself uses for
    ``-and``), and a member whose own T is exhausted is *frozen by masking*
    — it carries its final state unchanged through the remaining lockstep
    iterations, executing no further tasks.

    There is no dataflow between members: every backend must produce, for
    each member, the final state of running that member alone. On the card
    each backend runs an ensemble as one CUDA graph replay
    (``Runtime.build_ensemble``): ``fused`` shares each combine and body
    across a stackable ensemble's members, ``pallas_step`` each megakernel
    launch across a stacked one's, and both launch per member otherwise.
    """

    members: Tuple[TaskGraph, ...]

    def __init__(self, members: Sequence[TaskGraph]):
        object.__setattr__(self, "members", tuple(members))
        if not self.members:
            raise ValueError("ensemble needs at least one member graph")

    def __len__(self) -> int:
        return len(self.members)

    def __iter__(self):
        return iter(self.members)

    @property
    def steps(self) -> int:
        """Lockstep iteration count: the longest member's T."""
        return max(g.steps for g in self.members)

    @property
    def member_steps(self) -> Tuple[int, ...]:
        """Each member's own T; members are frozen once t reaches theirs."""
        return tuple(g.steps for g in self.members)

    @property
    def heterogeneous_steps(self) -> bool:
        return len({g.steps for g in self.members}) > 1

    @property
    def num_tasks(self) -> int:
        return sum(g.num_tasks for g in self.members)

    def total_flops(self) -> int:
        return sum(g.total_flops() for g in self.members)

    def active_table(self) -> np.ndarray:
        """(T, K) bool: row t says which members run timestep t (t < T_k)."""
        return np.arange(self.steps)[:, None] < np.asarray(self.member_steps)[None, :]

    @cached_property
    def stackable(self) -> bool:
        """Whether members can share one (K, W, payload) state tensor.

        True when every member has the same width and payload.
        """
        return (
            len({g.width for g in self.members}) == 1
            and len({g.payload for g in self.members}) == 1
        )

    def dependency_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Member dep arrays padded to a common (K, Pmax, W, Dmax) shape.

        Only defined for ``stackable`` ensembles (uniform width). Each
        member's (period, W, max_deps) arrays are tiled cyclically along the
        period axis up to Pmax = max member period, so slice
        ``idx[k, (t - 1) % Pmax]`` is correct for every member whose period
        divides Pmax, and ``(t - 1) % periods[k]`` indexing stays correct
        otherwise (consumers index per member with ``periods``).

        Returns:
          idx:     int32 (K, Pmax, W, Dmax)
          mask:    float32 (K, Pmax, W, Dmax)
          periods: int32 (K,) — each member's true period.
        """
        if not self.stackable:
            raise ValueError(
                "dependency_arrays requires a stackable ensemble "
                "(uniform width/payload)"
            )
        K = len(self.members)
        W = self.members[0].width
        Pmax = max(g.period for g in self.members)
        Dmax = max(g.max_deps for g in self.members)
        idx = np.zeros((K, Pmax, W, Dmax), dtype=np.int32)
        mask = np.zeros((K, Pmax, W, Dmax), dtype=np.float32)
        periods = np.array([g.period for g in self.members], dtype=np.int32)
        for k, g in enumerate(self.members):
            gi, gm = g.dependency_arrays()  # (period, W, D_k)
            P, _, D = gi.shape
            for s in range(Pmax):
                idx[k, s, :, :D] = gi[s % P]
                mask[k, s, :, :D] = gm[s % P]
        return idx, mask, periods

    def describe(self) -> str:
        inner = "; ".join(g.describe() for g in self.members)
        return f"GraphEnsemble(K={len(self.members)}, T={self.steps}: {inner})"
