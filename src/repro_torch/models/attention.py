"""Attention module: GQA + RoPE + SWA/local:global + KV cache + cross-attn.

Counterpart of ``repro.models.attention`` in two modes:

  prefill  the whole prompt through ``ops.flash_attention`` (K5 on the
           card), returning the populated KV cache
  decode   one token: the cache is written at ``lengths`` and read through
           ``ops.decode_attention`` (K6 on the card) up to ``lengths + 1``

Self-attention (``attn``, ``local``, ``global`` and the ``moe`` kind's
mixer) is causal with RoPE. Cross-attention (``xattn``, the VLM's image
layers) takes K and V from ``kv_src``, the image embeddings, with no RoPE
and no causal mask; its prefill caches the projected image K/V (B, Hkv,
n_image_tokens, hd), never quantized, and its decode reads that cache
whole and writes nothing. Image K/V take the promoted dtype of the image
embeddings and the weights, as the reference's: a bf16 model fed f32
image embeddings keeps an f32 image cache, and its cross-attention runs
K5's and K6's f32 forms. With ``kv_quant`` a self-attention cache is int8
with per-(batch, head, position) bf16 scales (B, Hkv, S, 1): the prefill
quantizes the K/V it computed (its attention uses the unquantized values),
and decode quantizes the new token, writes it, and dequantizes the whole
cache to the activation dtype before K6.

Not ported yet (ROADMAP Queue 1): the ``train`` mode and the
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
KINDS = ("attn", "local", "global", "moe", "xattn")
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
    return cfg.window  # attn / moe: arch-wide setting (0 = full)


def _project_q(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    q = (x @ p["wq"]).reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.head_dim_)
    return rmsnorm_fwd(p["q_norm"], q, cfg.norm_eps) if cfg.use_qk_norm else q


def _project_kv(p: Params, src: torch.Tensor, cfg: ModelConfig):
    """K and V of ``src`` in the promoted dtype of ``src`` and the weights,
    as the reference's ``kv_src @ wk``: f32 image embeddings give a bf16
    model f32 image K/V."""
    B, S = src.shape[0], src.shape[1]
    dt = torch.promote_types(src.dtype, p["wk"].dtype)
    src = src.to(dt)
    k = (src @ p["wk"].to(dt)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim_)
    v = (src @ p["wv"].to(dt)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim_)
    if cfg.use_qk_norm:
        k = rmsnorm_fwd(p["k_norm"], k, cfg.norm_eps)
    return k, v


def _quantize_kv(x: torch.Tensor):
    """x (..., hd) -> (int8 values, (..., 1) bf16 scales): the scale is
    max(amax, 1e-6) / 127 in f32, the values round half to even."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def attn_fwd(
    p: Params,
    x: torch.Tensor,  # (B, S, D); S == 1 in decode
    *,
    cfg: ModelConfig,
    kind: str,  # attn | local | global | moe | xattn
    mode: str,  # prefill | decode
    positions: torch.Tensor,  # (B, S) absolute positions
    cache: Optional[Params] = None,  # {"k","v"}: (B, Hkv, S_max, hd)
    lengths: Optional[torch.Tensor] = None,  # (B,) int32 tokens already in cache
    kv_src: Optional[torch.Tensor] = None,  # cross-attn source (B, I, D)
) -> Tuple[torch.Tensor, Params]:
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    if mode not in MODES:
        raise NotImplementedError(
            f"attention mode {mode!r} is not ported yet: the port serves "
            f"(prefill, decode); training is ROADMAP Queue 1 item 12")
    B, S, _ = x.shape
    hd = cfg.head_dim_
    cross = kind == "xattn"
    window = 0 if cross else _window_for(cfg, kind)
    use_kernel = cfg.use_flash

    if mode == "decode":
        if cache is None or lengths is None or S != 1:
            raise ValueError("decode takes one token (S == 1), a cache and lengths")
        q = _project_q(p, x, cfg)
        if cross:  # the static image K/V of the prefill, read whole
            kc, vc = cache["k"], cache["v"]
            read_len = torch.full((B,), kc.shape[2], dtype=torch.int32, device=x.device)
        else:
            q = rope(q, positions, cfg.rope_theta)
            t_k, t_v = _project_kv(p, x, cfg)
            t_k = rope(t_k, positions, cfg.rope_theta)
            # the new token goes to position lengths[b]; JAX's
            # dynamic_update_slice clamps a start index past the end, so a
            # full cache (lengths == S) overwrites its last slot, as the
            # reference's does
            at = lengths.long().clamp(0, cache["k"].shape[2] - 1)
            rows = torch.arange(B, device=x.device)
            if "k_scale" in cache:  # int8 cache: quantize the new token
                for name, t in (("k", t_k), ("v", t_v)):
                    qt, st = _quantize_kv(t[:, 0])  # (B, Hkv, hd), (B, Hkv, 1)
                    cache[name][rows, :, at] = qt
                    cache[name + "_scale"][rows, :, at] = st.to(cache[name + "_scale"].dtype)
                kc = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
                vc = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
            else:
                kc, vc = cache["k"], cache["v"]
                kc[rows, :, at] = t_k[:, 0].to(kc.dtype)
                vc[rows, :, at] = t_v[:, 0].to(vc.dtype)
            read_len = lengths + 1
        # an f32 image cache in a bf16 model: q widened (exactly) to f32,
        # K6's f32 form, the output rounded to q's dtype, as the prefill
        out = ops.decode_attention(q.reshape(B, cfg.n_heads, hd).to(kc.dtype), kc, vc,
                                   read_len, window=window, use_kernel=use_kernel)
        out = out.to(x.dtype).reshape(B, 1, cfg.n_heads * hd)
        return out @ p["wo"], cache  # written in place

    if cross and kv_src is None:
        raise ValueError("a cross-attention prefill needs kv_src (the image embeddings)")
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, kv_src if cross else x, cfg)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()  # (B, Hkv, S or I, hd): also the cache
    vh = v.transpose(1, 2).contiguous()
    # K5 takes one dtype. Over f32 image K/V (a bf16 model fed f32 image
    # embeddings) it runs its f32 form on q widened exactly to f32 and the
    # output is rounded to q's dtype: the reference's kernel reads every
    # operand as f32 and writes q's dtype
    out = ops.flash_attention(qh.to(kh.dtype), kh, vh, causal=not cross, window=window,
                              use_kernel=use_kernel).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * hd)
    if cfg.kv_quant and not cross:
        qk, sk = _quantize_kv(kh)
        qv, sv = _quantize_kv(vh)
        new_cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        new_cache = {"k": kh, "v": vh}  # capacity == S (I for the image cache)
    return out @ p["wo"], new_cache


def init_cache(cfg: ModelConfig, kind: str, batch: int, capacity: int, dtype,
               device) -> Params:
    """Zeroed K/V of (B, Hkv, capacity, hd) in ``dtype``; an image cache
    holds ``n_image_tokens`` positions; with ``kv_quant`` a self-attention
    cache is int8 with (B, Hkv, capacity, 1) bf16 scales."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    cap = cfg.n_image_tokens if kind == "xattn" else capacity
    shape = (batch, cfg.n_kv_heads, cap, cfg.head_dim_)
    if cfg.kv_quant and kind != "xattn":
        scales = (batch, cfg.n_kv_heads, cap, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scales, dtype=torch.bfloat16, device=device),
                "v_scale": torch.zeros(scales, dtype=torch.bfloat16, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
