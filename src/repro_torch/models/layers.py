"""Shared model layers: norms, RoPE, MLP, embeddings.

Counterpart of ``repro.models.layers``, in the same functional style:
``*_init`` returns a tensor or a plain dict of tensors, ``*_fwd`` applies
it. Init draws from a ``torch.Generator``, so its values differ from the
reference's ``jax.random`` stream; tests carry the reference's weights in
(``models.model.params_from_reference``). The reference's sharding
constraints (``distributed.api.constrain``) are no-ops without a mesh, and
the port has no mesh yet, so they have no counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import rmsnorm_plain

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w / in_dim ** 0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


# ------------------------------------------------------------------ RMSNorm


def rmsnorm_init(dim: int, dtype, device) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)


def rmsnorm_fwd(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """In f32, cast back to x's dtype: K8's plain version. The models call
    it as the reference's call theirs, never the kernel."""
    return rmsnorm_plain(x, w, eps)


# --------------------------------------------------------------------- RoPE


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-rotation convention, in f32, cast back.

    x: (B, S, H, D_head), positions: (B, S) absolute token positions.
    """
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- SwiGLU MLP


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, device) -> dict:
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype, device),
        "up": dense_init(gen, d_model, d_ff, dtype, device),
        "down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def mlp_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): silu(x W_gate) * (x W_up) W_down."""
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]
