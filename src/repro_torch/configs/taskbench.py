"""Task Bench workload configs (the paper's own experiment grid).

A copy of ``repro.configs.taskbench``: the same presets, field for field.
The paper runs the stencil pattern for 1000 timesteps, 5 reps per point,
with overdecomposition {1, 8, 16} (Table 2) and grain sweeps (Fig 1).
``PAPER`` is that protocol; the others are the reference's scaled sweeps.
The port's benchmark scripts (``benchmarks/torch_*.py``) read them from here. The
``runtimes`` tuples name the reference's backends, and the port runs all
six on one card: ``benchmarks/torch_metg.py`` sweeps ``fused``,
``pallas_step`` and the rungs ``bsp``, ``bsp_scan`` and ``overlap`` on
``PAPER``, and ``serialized`` at ``QUICK``'s steps.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TaskBenchConfig:
    name: str
    pattern: str = "stencil_1d"
    steps: int = 1000
    payload: int = 64
    overdecomposition: Tuple[int, ...] = (1, 8, 16)
    grains: Tuple[int, ...] = (1, 4, 16, 64, 256, 1024, 4096, 16384)
    reps: int = 5
    runtimes: Tuple[str, ...] = ("fused", "serialized", "bsp", "bsp_scan",
                                 "overlap", "pallas_step")
    #: K values for concurrent multi-graph ensembles (Task Bench `-and`,
    #: paper §6.2): K independent graphs per run, each width = devices x od.
    ensemble_sizes: Tuple[int, ...] = (1, 2, 4, 8)


# The paper's protocol (1000 steps, 5 reps).
PAPER = TaskBenchConfig(name="paper")

# The reference's scaled preset: the same shape of sweep, a shorter graph.
QUICK = TaskBenchConfig(
    name="quick",
    steps=50,
    overdecomposition=(1, 8),
    grains=(1, 16, 256, 4096, 65536),
    reps=3,
    runtimes=("fused", "serialized", "bsp", "bsp_scan", "overlap",
              "pallas_step"),
    ensemble_sizes=(1, 2, 4),
)

# Latency-hiding sweep: the smallest grains, so that per-step overhead is
# not negligible, K = 1..8 concurrent graphs.
FIG4 = TaskBenchConfig(
    name="fig4",
    steps=100,
    overdecomposition=(8,),
    grains=(1, 8, 64),
    reps=5,
    runtimes=("overlap", "bsp", "bsp_scan", "pallas_step"),
    ensemble_sizes=(1, 2, 4, 8),
)

# Fused-timestep floor check: iterations=1, the grain where the per-step
# operation count, not arithmetic, sets the wall.
FLOOR = TaskBenchConfig(
    name="floor",
    steps=200,
    overdecomposition=(1,),
    grains=(1,),
    reps=5,
    runtimes=("fused", "pallas_step"),
    ensemble_sizes=(1,),
)

PRESETS = {c.name: c for c in (PAPER, QUICK, FIG4, FLOOR)}
