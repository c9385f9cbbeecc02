"""Mamba-2 (SSD) block inner: in_proj -> causal conv -> SSD -> gated norm -> out.

Counterpart of ``repro.models.ssm`` (arXiv:2405.21060): the projection
produces (z, x, B, C, dt); the short causal depthwise conv runs over (x, B,
C); the selective scan is the chunked SSD of ``kernels.ops.ssd`` (K7 on the
card); the output is RMSNorm(y * silu(z)) @ out_proj.

Three modes: ``train`` runs the whole sequence, differentiable, through
``ops.ssd``'s plain version (``use_kernel=False``, on the card too, as the
reference's train mode: K7 has no backward) and writes no cache;
``prefill`` runs the whole prompt and returns the decode state, ``decode``
one token. Decode carries two states,
the conv window (the last ssm_conv - 1 inputs) and the (H, N, P) SSM state,
both O(1) in the sequence length. Unlike the reference, decode updates both
in the caller's tensors in place (and returns them), as ``attn_fwd`` does
with its KV cache: a serving loop keeps one buffer of each.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rmsnorm_fwd

Params = Dict[str, torch.Tensor]
MODES = ("train", "prefill", "decode")


def _dims(cfg: ModelConfig):
    di = cfg.ssm_inner
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    H = di // P
    conv_ch = di + 2 * G * N
    return di, G, N, P, H, conv_ch


def ssm_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    di, G, N, P, H, conv_ch = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen, **f32) * 0.1
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * G * N + H, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), math.log(math.expm1(0.01)), **f32),
        "norm_w": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """(z, x, B, C, dt) along the last dim."""
    di, G, N, P, H, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)


def _causal_conv(conv_in: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps w (cw, C), then silu."""
    cw, S = w.shape[0], conv_in.shape[1]
    pad = F.pad(conv_in, (0, 0, cw - 1, 0))
    out = sum(pad[:, i: i + S, :] * w[i][None, None, :] for i in range(cw))
    return F.silu(out + b[None, None, :])


def ssm_fwd(
    p: Params,
    x: torch.Tensor,  # (B, S, D); S == 1 in decode
    *,
    cfg: ModelConfig,
    mode: str,  # train | prefill | decode
    cache: Optional[Params] = None,  # {"conv": (B, cw-1, C), "ssd": (B, H, N, P)}
    lengths: Optional[torch.Tensor] = None,  # unused: the state carries position
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (out (B, S, D), the cache: None in train mode)."""
    if mode not in MODES:
        raise ValueError(f"unknown ssm mode {mode!r}")
    di, G, N, P, H, conv_ch = _dims(cfg)
    B, S, _ = x.shape
    A = -torch.exp(p["A_log"])  # (H,) negative

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token (S == 1) and a cache")
        z, xin, bm, cm, dt = _split(x @ p["in_proj"], cfg)
        conv_in = torch.cat([xin, bm, cm], dim=-1)  # (B, 1, conv_ch)
        win = torch.cat([cache["conv"], conv_in], dim=1)  # (B, cw, conv_ch)
        conv_out = F.silu((win * p["conv_w"][None]).sum(dim=1) + p["conv_b"][None])
        xin, bm, cm = torch.split(conv_out, [di, G * N, G * N], dim=-1)
        dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B, H)
        xh = xin.reshape(B, H, P)
        state, y = ops.ssd_decode_step(cache["ssd"], xh, bm.reshape(B, G, N),
                                       cm.reshape(B, G, N), dtv * A[None], dtv)
        y = y + p["D"][None, :, None] * xh.float()
        y = y.reshape(B, 1, di).to(x.dtype)
        y = rmsnorm_fwd(p["norm_w"], y * F.silu(z), cfg.norm_eps)
        cache["conv"].copy_(win[:, 1:])
        return y @ p["out_proj"], {"conv": cache["conv"], "ssd": state}

    z, xin, bm, cm, dt = _split(x @ p["in_proj"], cfg)
    conv_in = torch.cat([xin, bm, cm], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xin, bm, cm = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    chunk = min(cfg.ssm_chunk, S)
    pad_s = (-S) % chunk
    if pad_s:
        # dt = 0 on the padding: decay 1, contribution 0, the state stays exact
        dtv, xin, bm, cm = (F.pad(t, (0, 0, 0, pad_s)) for t in (dtv, xin, bm, cm))
    Sp = S + pad_s
    xh = xin.reshape(B, Sp, H, P)
    y, final_state = ops.ssd(xh, bm.reshape(B, Sp, G, N), cm.reshape(B, Sp, G, N),
                             dtv * A[None, None, :], dtv, chunk=chunk,
                             use_kernel=cfg.use_flash and mode != "train")
    y = y.float() + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, Sp, di)[:, :S].to(x.dtype)
    y = rmsnorm_fwd(p["norm_w"], y * F.silu(z), cfg.norm_eps)
    if mode == "train":
        return y @ p["out_proj"], None
    cw = p["conv_w"].shape[0]
    if S >= cw - 1:
        tail = conv_in[:, S - (cw - 1): S].clone()  # a copy: conv_in is freed
    else:
        tail = F.pad(conv_in, (0, 0, cw - 1 - S, 0))
    return y @ p["out_proj"], {"conv": tail, "ssd": final_state}


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    di, G, N, P, H, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
        "ssd": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
    }
