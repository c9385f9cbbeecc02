"""Decoder blocks, composed by model.py's layer plan.

Counterpart of ``repro.models.blocks``:

  attn / local / global   pre-norm self-attention + pre-norm SwiGLU MLP
  moe                     pre-norm self-attention + pre-norm MoE FFN
  ssm                     pre-norm Mamba-2 mixer (+ MLP only if d_ff > 0)
  hybrid                  Hymba: attention and SSM heads in parallel on the
                          same normed input, outputs normed and mixed by
                          the fuse_a / fuse_s scalars; + MLP
  xattn                   Llama-Vision gated cross-attention layer + MLP:
                          tanh(gate_attn) and tanh(gate_mlp) scale the two
                          sublayers (f32 scalars, 0 at init)

Every block returns (x, cache', aux) as the reference's does; aux is the
MoE load-balancing loss of a ``moe`` block and 0 for the other kinds. In
``train`` mode no sublayer writes a cache and the cache is None.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.attention import attn_fwd, attn_init, init_cache
from repro_torch.models.layers import mlp_fwd, mlp_init, rmsnorm_fwd, rmsnorm_init
from repro_torch.models.moe import moe_fwd, moe_init
from repro_torch.models.ssm import ssm_cache_init, ssm_fwd, ssm_init

Params = Dict[str, Any]
KINDS = attention.KINDS + ("ssm", "hybrid")


@dataclasses.dataclass
class BlockCtx:
    mode: str  # train | prefill | decode
    positions: Optional[torch.Tensor] = None  # (B, S)
    lengths: Optional[torch.Tensor] = None  # (B,)
    image_embeds: Optional[torch.Tensor] = None  # (B, I, D)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
               device) -> Params:
    _check_kind(kind)
    d = cfg.d_model
    p: Params = {"norm1": rmsnorm_init(d, dtype, device)}
    if kind != "ssm":
        p["attn"] = attn_init(gen, cfg, dtype, device)
    if kind in ("ssm", "hybrid"):
        p["ssm"] = ssm_init(gen, cfg, dtype, device)
    if kind == "hybrid":
        p["fuse_norm_a"] = rmsnorm_init(d, dtype, device)
        p["fuse_norm_s"] = rmsnorm_init(d, dtype, device)
        p["fuse_a"] = torch.full((), 0.5, dtype=torch.float32, device=device)
        p["fuse_s"] = torch.full((), 0.5, dtype=torch.float32, device=device)
    if kind == "xattn":
        p["gate_attn"] = torch.zeros((), dtype=torch.float32, device=device)
        p["gate_mlp"] = torch.zeros((), dtype=torch.float32, device=device)
    if kind == "moe":
        p["norm2"] = rmsnorm_init(d, dtype, device)
        p["moe"] = moe_init(gen, cfg, dtype, device)
    elif kind != "ssm" or cfg.d_ff:
        p["norm2"] = rmsnorm_init(d, dtype, device)
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, dtype, device)
    return p


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, capacity: int,
                     dtype, device) -> Params:
    _check_kind(kind)
    cache: Params = {}
    if kind != "ssm":
        cache["attn"] = init_cache(cfg, "attn" if kind == "hybrid" else kind, batch,
                                   capacity, dtype, device)
    if kind in ("ssm", "hybrid"):
        cache["ssm"] = ssm_cache_init(cfg, batch, dtype, device)
    return cache


def block_fwd(
    p: Params,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    kind: str,
    ctx: BlockCtx,
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    _check_kind(kind)
    eps = cfg.norm_eps
    cache = cache or {}
    new_cache: Params = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm_fwd(p["norm1"], x, eps)
    if "attn" in p:
        # the hybrid's attention heads run as an "attn" layer (cfg.window)
        a, new_cache["attn"] = attn_fwd(
            p["attn"], h, cfg=cfg, kind="attn" if kind == "hybrid" else kind,
            mode=ctx.mode, positions=ctx.positions, lengths=ctx.lengths,
            cache=cache.get("attn"), kv_src=ctx.image_embeds if kind == "xattn" else None)
    if "ssm" in p:
        s, new_cache["ssm"] = ssm_fwd(p["ssm"], h, cfg=cfg, mode=ctx.mode,
                                      cache=cache.get("ssm"), lengths=ctx.lengths)
    if kind == "hybrid":
        fused = (p["fuse_a"].float() * rmsnorm_fwd(p["fuse_norm_a"], a, eps).float()
                 + p["fuse_s"].float() * rmsnorm_fwd(p["fuse_norm_s"], s, eps).float())
        x = x + fused.to(x.dtype)
    elif kind == "xattn":
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * a
    else:
        x = x + (s if kind == "ssm" else a)
    if "moe" in p:
        m, aux = moe_fwd(p["moe"], rmsnorm_fwd(p["norm2"], x, eps), cfg, mode=ctx.mode)
        x = x + m
    elif "mlp" in p:
        m = mlp_fwd(p["mlp"], rmsnorm_fwd(p["norm2"], x, eps))
        if kind == "xattn":
            m = torch.tanh(p["gate_mlp"]).to(x.dtype) * m
        x = x + m
    return x, None if ctx.mode == "train" else new_cache, aux
