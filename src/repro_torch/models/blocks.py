"""Decoder blocks, composed by model.py's layer plan.

Counterpart of ``repro.models.blocks`` for the kinds the port serves:

  attn / local / global   pre-norm self-attention + pre-norm SwiGLU MLP

The reference's ``moe``, ``ssm``, ``hybrid`` and ``xattn`` kinds are not
ported yet (ROADMAP Queue 1 item 12); they raise ``NotImplementedError``.
Every block returns (x, cache', aux) as the reference's does; aux (the MoE
load-balancing loss there) is 0 for these kinds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KINDS, attn_fwd, attn_init, init_cache
from repro_torch.models.layers import mlp_fwd, mlp_init, rmsnorm_fwd, rmsnorm_init

Params = Dict[str, Any]


@dataclasses.dataclass
class BlockCtx:
    mode: str  # prefill | decode
    positions: Optional[torch.Tensor] = None  # (B, S)
    lengths: Optional[torch.Tensor] = None  # (B,)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP Queue 1 item 12)")


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
               device) -> Params:
    _check_kind(kind)
    d = cfg.d_model
    return {
        "norm1": rmsnorm_init(d, dtype, device),
        "attn": attn_init(gen, cfg, dtype, device),
        "norm2": rmsnorm_init(d, dtype, device),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype, device),
    }


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, capacity: int,
                     dtype, device) -> Params:
    _check_kind(kind)
    return {"attn": init_cache(cfg, kind, batch, capacity, dtype, device)}


def block_fwd(
    p: Params,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    kind: str,
    ctx: BlockCtx,
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params, torch.Tensor]:
    _check_kind(kind)
    eps = cfg.norm_eps
    h = rmsnorm_fwd(p["norm1"], x, eps)
    a, c_attn = attn_fwd(p["attn"], h, cfg=cfg, kind=kind, mode=ctx.mode,
                         positions=ctx.positions, lengths=ctx.lengths,
                         cache=cache["attn"] if cache else None)
    x = x + a
    x = x + mlp_fwd(p["mlp"], rmsnorm_fwd(p["norm2"], x, eps))
    return x, {"attn": c_attn}, torch.zeros((), dtype=torch.float32, device=x.device)
