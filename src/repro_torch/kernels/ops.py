"""Public wrappers over the port's kernels: Task Bench's and attention's.

Counterpart of ``repro.kernels.ops`` (its Task Bench and attention
wrappers). One rule for all of them: a tensor on the CPU goes to the
kernel's plain PyTorch version; a tensor on the card goes to the CUDA
kernel, which launches or raises. There is no fallback from the card to the
plain version, and a tensor on any other device raises. The attention
wrappers also take ``use_kernel=False``, which runs the plain version on
either device, as the reference's does. Each kernel's launches are counted
in ``_build.LAUNCHES`` (see `launch_counts`), by the wrapper that launches
it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bodies import apply_body, fma_body, memory_bound
from repro_torch.kernels.decode_attention import decode_attention as _decode_kernel
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.taskbench_compute import taskbench_compute as _compute_kernel
from repro_torch.kernels.taskbench_step import (
    step_on_device,
    taskbench_step_boundary,
    taskbench_step_interior,
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


def taskbench_step(src, idx, wgt, act=None, **kw):
    """Fused Task Bench timestep(s) for K graphs: K3 on the card, or K4 at
    ``steps_per_launch > 1`` (which requires the (K, S) ``act`` mask).

    See ``repro_torch.kernels.taskbench_step`` for the operand contract;
    the operands are checked on either device.
    """
    _on_card(src)
    return step_on_device(src, idx, wgt, act, **kw)


def taskbench_interior(src, idx, wgt, act, *, depth: int, **kw):
    """Interior phase of a pipelined blocked launch (owned block only;
    returns the (K, B - 2*depth, payload) rows valid after S depths).
    See kernels.taskbench_step.taskbench_step_interior."""
    _on_card(src)
    return taskbench_step_interior(src, idx, wgt, act, depth=depth, **kw)


def taskbench_boundary(left, right, idx, wgt, act, *, depth: int, **kw):
    """Boundary phase of a pipelined blocked launch (both 3*depth edge
    buffers of all K members in ONE launch; returns the new edge rows).
    See kernels.taskbench_step.taskbench_step_boundary."""
    _on_card(left)
    return taskbench_step_boundary(left, right, idx, wgt, act, depth=depth, **kw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """Attention over q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D): K5 on the
    card, ``ref.attention_plain`` on the CPU or with ``use_kernel=False``."""
    if use_kernel and _on_card(q):
        return _flash_kernel(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    return ref.attention_plain(q, k, v, causal=causal, window=window,
                               sm_scale=sm_scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, sm_scale: Optional[float] = None,
                     window: int = 0, return_stats: bool = False,
                     use_kernel: bool = True):
    """Returns o (B, Hq, D), or (o, m, l) softmax stats with
    ``return_stats=True`` (the stats feed an lse-combine across cache
    shards): K6 on the card, ``ref.decode_attention_plain`` on the CPU or
    with ``use_kernel=False``."""
    if not (use_kernel and _on_card(q)):
        return ref.decode_attention_plain(q, k_cache, v_cache, lengths,
                                          sm_scale=sm_scale, window=window,
                                          return_stats=return_stats)
    o, m, l = _decode_kernel(q, k_cache, v_cache, lengths, sm_scale=sm_scale,
                             window=window)
    return (o, m, l) if return_stats else o


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last `reset_launch_counts`, per kernel."""
    return {entry: _build.LAUNCHES[entry] for entry in _build.ENTRIES}


def reset_launch_counts() -> None:
    _build.reset_launches()
