"""Public wrappers over the port's Task Bench kernels.

Counterpart of ``repro.kernels.ops`` (its Task Bench wrappers). One rule for
all three: a tensor on the CPU goes to the kernel's plain PyTorch version; a
tensor on the card goes to the CUDA kernel, which launches or raises. There
is no fallback from the card to the plain version, and a tensor on any
other device raises. Each kernel's launches are counted in
``_build.LAUNCHES`` (see `launch_counts`), by the wrapper that launches it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bodies import apply_body, fma_body, memory_bound
from repro_torch.kernels.taskbench_compute import taskbench_compute as _compute_kernel
from repro_torch.kernels.taskbench_step import (
    check_step_operands,
    taskbench_step as _step_kernel,
    taskbench_step_plain,
)


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"tensor on {x.device}: the port runs on cuda or cpu")


def taskbench_compute(x: torch.Tensor, iterations: int) -> torch.Tensor:
    """Iterated-FMA task body (K1 on the card); accepts (..., payload)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    out = _compute_kernel(x2, iterations) if _on_card(x) else fma_body(x2, iterations)
    return out.reshape(shape)


def taskbench_memory(x: torch.Tensor, iterations: int, scratch: int) -> torch.Tensor:
    """Scratch-sweep task body (K2 on the card); accepts (..., payload)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _on_card(x):
        out = memory_bound(x2, iterations, scratch)
    else:
        out = apply_body(x2, "memory_bound", iterations, scratch)
    return out.reshape(shape)


def taskbench_step(src, idx, wgt, *, kind: str = "compute_bound",
                   iterations: int = 16, scratch: int = 2048,
                   combine: str = "gather", steps_per_launch: int = 1):
    """One fused Task Bench timestep for K graphs (K3 on the card).

    See ``repro_torch.kernels.taskbench_step`` for the operand contract;
    the operands are checked on either device.
    """
    kw = dict(kind=kind, iterations=iterations, scratch=scratch, combine=combine)
    if _on_card(src):
        return _step_kernel(src, idx, wgt, steps_per_launch=steps_per_launch, **kw)
    check_step_operands(src, idx, wgt, steps_per_launch=steps_per_launch, **kw)
    return taskbench_step_plain(src, idx, wgt, **kw)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last `reset_launch_counts`, per kernel."""
    return {entry: _build.LAUNCHES[entry] for entry in _build.ENTRIES}


def reset_launch_counts() -> None:
    _build.reset_launches()
