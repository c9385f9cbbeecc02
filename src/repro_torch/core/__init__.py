"""Task Bench in PyTorch — the counterpart of ``repro.core`` for this slice.

Public API:
    TaskGraph, KernelSpec           workload definition
    GraphEnsemble                   K concurrent graphs (host-side tables)
    PATTERNS                        dependence pattern names
    get_runtime, available_runtimes execution backends (fused, serialized,
                                    bsp, bsp_scan, overlap, pallas_step)
    compute_metg, GrainSample       the METG metric
    combine_grain_samples           ensemble-aggregate samples for METG
"""
from repro_torch.core.graph import GraphEnsemble, TaskGraph
from repro_torch.core.metg import (
    DEFAULT_THRESHOLD,
    GrainSample,
    MetgResult,
    combine_grain_samples,
    compute_metg,
    default_grain_schedule,
    efficiency_curve,
)
from repro_torch.core.patterns import PATTERNS
from repro_torch.core.task_kernels import KernelSpec

# importing the backends registers them
from repro_torch.core.runtimes.base import Runtime, available_runtimes, get_runtime
from repro_torch.core.runtimes import bsp as _bsp  # noqa: F401
from repro_torch.core.runtimes import fused as _fused  # noqa: F401
from repro_torch.core.runtimes import overlap as _overlap  # noqa: F401
from repro_torch.core.runtimes import pallas_step as _pallas_step  # noqa: F401
from repro_torch.core.runtimes import serialized as _serialized  # noqa: F401

__all__ = [
    "TaskGraph",
    "GraphEnsemble",
    "KernelSpec",
    "combine_grain_samples",
    "PATTERNS",
    "Runtime",
    "get_runtime",
    "available_runtimes",
    "GrainSample",
    "MetgResult",
    "compute_metg",
    "efficiency_curve",
    "default_grain_schedule",
    "DEFAULT_THRESHOLD",
]
