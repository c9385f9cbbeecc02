"""Grain-size-parameterized task bodies and dependency combines, in PyTorch.

Counterpart of ``repro.core.task_kernels``. The task body is an iterated
elementwise FMA over the point's payload vector (``compute_bound``,
FLOPs(task) = 2 * payload * iterations), a scratch sweep (``memory_bound``)
or a no-op (``empty``). Runtimes select the CUDA body kernels with
``use_kernels=True`` (the reference's ``use_pallas``) through the
``_BODY_DISPATCH`` table; on a CPU tensor those wrappers run their plain
versions.

Initial states differ from the reference: its ``initial_state`` draws from
``jax.random``, whose stream the port cannot reproduce. The port's own
`initial_state` draws from a seeded ``torch.Generator``; to compare with the
reference, feed its arrays in through `state_from_reference`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as _kops
from repro_torch.kernels.bodies import fma_body, memory_sweep_body
from repro_torch.kernels.taskbench_step import KINDS


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Task body spec. ``iterations`` is the grain-size knob."""

    kind: str = "compute_bound"
    iterations: int = 16
    scratch: int = 2048  # floats; memory_bound working set per point

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown kernel kind {self.kind!r}; known {KINDS}")
        if self.iterations < 0:
            raise ValueError("iterations must be >= 0")

    def flops(self, payload: int) -> int:
        if self.kind == "compute_bound":
            return 2 * payload * self.iterations
        if self.kind == "memory_bound":
            return self.scratch * self.iterations  # 1 add per touched element
        return 0

    def bytes(self, payload: int) -> int:
        if self.kind == "compute_bound":
            return 4 * payload * 2  # read + write once; iterations live in reg
        if self.kind == "memory_bound":
            return 4 * self.scratch * 2 * self.iterations
        return 0

    def grain_duration_estimate(self, payload: int, flops_per_s: float) -> float:
        """Seconds per task at a given sustained FLOP rate (napkin math)."""
        return self.flops(payload) / max(flops_per_s, 1.0)


#: (kind, use_kernels) -> body; the one dispatch point for the runtimes.
_BODY_DISPATCH = {
    ("compute_bound", False): lambda x, spec: fma_body(x, spec.iterations),
    ("compute_bound", True): lambda x, spec: _kops.taskbench_compute(x, spec.iterations),
    ("memory_bound", False): lambda x, spec: memory_sweep_body(
        x, spec.iterations, spec.scratch),
    ("memory_bound", True): lambda x, spec: _kops.taskbench_memory(
        x, spec.iterations, spec.scratch),
    ("empty", False): lambda x, spec: x,
    ("empty", True): lambda x, spec: x,
}


def apply_kernel(x: torch.Tensor, spec: KernelSpec, *,
                 use_kernels: bool = False) -> torch.Tensor:
    """Apply the task body to a batch of point states x: (..., payload)."""
    if spec.kind == "empty" or spec.iterations == 0:
        return x
    return _BODY_DISPATCH[(spec.kind, bool(use_kernels))](x, spec)


def combine_dependencies(outputs: torch.Tensor, idx: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Gather + reduce dependency outputs into per-point kernel inputs.

    Args:
      outputs: (W, payload) previous-step point outputs.
      idx:     (W, D) integer dependency indices (padded).
      mask:    (W, D) f32 1/0 liveness.

    Returns:
      (W, payload): mean over live deps of their outputs; points with zero
      deps keep their own previous output.
    """
    live = mask.sum(-1, keepdim=True)
    combined = (outputs[idx] * mask[..., None]).sum(dim=1) / live.clamp(min=1.0)
    return torch.where(live > 0, combined, outputs)


def combine_all_to_all(outputs: torch.Tensor) -> torch.Tensor:
    """Mean over all points, for every point (no (W, W) index array)."""
    return outputs.mean(dim=0, keepdim=True).expand_as(outputs)


def initial_state(width: int, payload: int, seed: int = 0,
                  device="cuda") -> torch.Tensor:
    """(width, payload) f32 uniform in [0.1, 1.0) from a seeded generator.

    Not the reference's values (it draws from jax.random); see
    `state_from_reference`.
    """
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((width, payload), generator=gen, dtype=torch.float32) * 0.9 + 0.1
    return x.to(device)


def state_from_reference(array: np.ndarray, device="cuda") -> torch.Tensor:
    """A reference state (a numpy array, e.g. ``np.asarray`` of the JAX
    package's ``initial_state``) as a float32 tensor on ``device``."""
    return torch.from_numpy(np.array(array, dtype=np.float32, copy=True)).to(device)
