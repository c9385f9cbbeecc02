"""Gradient compression for a slow inter-node hop: int8 with error feedback.

Counterpart of ``repro.optim.grad_compression``'s pure functions: per-tensor
symmetric int8 with stochastic rounding, and error feedback (the
quantization residual is carried to the next step, Seide et al. 1-bit SGD /
Dettmers 8-bit). The stochastic rounding's uniforms come from ``key``: a
``torch.Generator`` (drawn on its device), or a tensor of uniforms in [0,
1) of the input's shape, which is how the tests feed in the reference's
``jax.random.uniform`` draws. The reference's ``cross_pod_mean_int8``, a
collective over a mesh axis, is not ported yet (ROADMAP Queue 1 item 12,
slice 23).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

Key = Union[torch.Generator, torch.Tensor]


def _uniforms(key: Key, x: torch.Tensor) -> torch.Tensor:
    if isinstance(key, torch.Generator):
        return torch.rand(x.shape, generator=key, device=key.device).to(x.device)
    if key.shape != x.shape:
        raise ValueError(f"uniforms of shape {tuple(key.shape)} for an input of "
                         f"shape {tuple(x.shape)}")
    return key.to(device=x.device, dtype=torch.float32)


def quantize_int8(x: torch.Tensor, key: Key) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 with stochastic rounding: returns (q int8,
    scale () f32), scale = max(max|x|, 1e-12) / 127."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    y = x / scale
    lo = torch.floor(y)
    q = lo + (_uniforms(key, x) < y - lo).to(y.dtype)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(g: torch.Tensor, ef: torch.Tensor, key: Key
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q, scale, new_ef): quantize g + ef in f32; ef' = that input
    minus its dequantized value."""
    target = g.float() + ef
    q, scale = quantize_int8(target, key)
    return q, scale, target - dequantize_int8(q, scale)


def compression_ratio(g_dtype: torch.dtype = torch.bfloat16) -> float:
    """Bytes of a ``g_dtype`` gradient per byte of its int8 payload."""
    return g_dtype.itemsize / torch.int8.itemsize
