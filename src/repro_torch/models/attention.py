"""Attention module: GQA + RoPE + sliding window / local:global + KV cache.

Counterpart of ``repro.models.attention`` for the self-attention kinds
``attn``, ``local`` and ``global`` in two modes:

  prefill  the whole prompt: causal attention through ``ops.flash_attention``
           (K5 on the card), returning the populated KV cache
  decode   one token: the cache is written at ``lengths`` and read through
           ``ops.decode_attention`` (K6 on the card) up to ``lengths + 1``

Not ported yet (ROADMAP Queue 1 item 12): the ``train`` mode, cross-
attention (``xattn``), the int8 KV cache (``kv_quant``) and the
sequence-parallel cache read over a mesh.

Unlike the reference, decode writes the new token into the cache tensors in
place (and returns them): a serving loop then keeps one cache buffer
instead of a new copy per step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rmsnorm_fwd, rope

Params = Dict[str, torch.Tensor]
KINDS = ("attn", "local", "global")
MODES = ("prefill", "decode")


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    d, hd = cfg.d_model, cfg.head_dim_
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, device),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _window_for(cfg: ModelConfig, kind: str) -> int:
    if kind == "local":
        return cfg.local_window
    if kind == "global":
        return 0
    return cfg.window  # attn: arch-wide setting (0 = full)


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    B, S = x.shape[0], x.shape[1]
    hd = cfg.head_dim_
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        q = rmsnorm_fwd(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_fwd(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def attn_fwd(
    p: Params,
    x: torch.Tensor,  # (B, S, D); S == 1 in decode
    *,
    cfg: ModelConfig,
    kind: str,  # attn | local | global
    mode: str,  # prefill | decode
    positions: torch.Tensor,  # (B, S) absolute positions
    cache: Optional[Params] = None,  # {"k","v"}: (B, Hkv, S_max, hd)
    lengths: Optional[torch.Tensor] = None,  # (B,) int32 tokens already in cache
) -> Tuple[torch.Tensor, Params]:
    if kind not in KINDS:
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported yet (ROADMAP Queue 1 item 12)")
    if mode not in MODES:
        raise NotImplementedError(
            f"attention mode {mode!r} is not ported yet: the port serves "
            f"(prefill, decode); training is ROADMAP Queue 1 item 12")
    B, S, _ = x.shape
    hd = cfg.head_dim_
    window = _window_for(cfg, kind)
    use_kernel = cfg.use_flash

    if mode == "decode":
        if cache is None or lengths is None or S != 1:
            raise ValueError("decode takes one token (S == 1), a cache and lengths")
        q, t_k, t_v = _project_qkv(p, x, cfg)
        q = rope(q, positions, cfg.rope_theta)
        t_k = rope(t_k, positions, cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        # the new token goes to position lengths[b]; JAX's dynamic_update_slice
        # clamps a start index past the end, so a full cache (lengths == S)
        # overwrites its last slot, as the reference's does
        at = lengths.long().clamp(0, kc.shape[2] - 1)
        rows = torch.arange(B, device=x.device)
        kc[rows, :, at] = t_k[:, 0].to(kc.dtype)
        vc[rows, :, at] = t_v[:, 0].to(vc.dtype)
        out = ops.decode_attention(q.reshape(B, cfg.n_heads, hd), kc, vc, lengths + 1,
                                   window=window, use_kernel=use_kernel)
        return out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"], {"k": kc, "v": vc}

    q, k, v = _project_qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()  # (B, Hkv, S, hd): also the cache
    vh = v.transpose(1, 2).contiguous()
    out = ops.flash_attention(qh, kh, vh, causal=True, window=window,
                              use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * hd)
    return out @ p["wo"], {"k": kh, "v": vh}  # capacity == S


def init_cache(cfg: ModelConfig, kind: str, batch: int, capacity: int, dtype,
               device) -> Params:
    if kind not in KINDS:
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported yet (ROADMAP Queue 1 item 12)")
    if cfg.kv_quant:
        raise NotImplementedError(
            "the int8 KV cache (kv_quant) is not ported yet (ROADMAP Queue 1 item 12)")
    shape = (batch, cfg.n_kv_heads, capacity, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
