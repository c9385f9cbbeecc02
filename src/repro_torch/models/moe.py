"""Mixture-of-Experts layer: top-k router + capacity dispatch.

Counterpart of ``repro.models.moe`` in ``prefill`` and ``decode`` mode.
Dispatch is sort-free capacity bucketing: each token's slot in its expert
is the count of earlier assignments to that expert (a cumsum over expert
one-hots in token-major assignment order), and the kept rows are scattered
into (G, E, C, d) buckets. The expert FFNs run as batched matrix products
over stacked expert weights; the reference computes them outside any
Pallas kernel (``jnp.einsum``), so here they are plain ``torch.matmul``.

Nothing here syncs with the host (no ``.item()``, no ``nonzero``, no
data-dependent shape), so a decode step through it captures as one CUDA
graph: a dropped assignment is scattered into one overflow row past the
buckets, which is sliced off, and gathered back with a zero weight.

Routing ties: ``jax.lax.top_k`` takes the lower expert index first, and so
does the stable descending sort used here (``torch.topk`` leaves the order
of ties unspecified). ``route`` exposes (e_idx, s_idx, keep) for tests.

The dispatch-group count G is 1 (the reference's ``_dispatch_groups``
without a mesh); the group axis stays in the shapes.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]
MODES = ("prefill", "decode")


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    d = cfg.d_model
    ff = cfg.d_ff_expert or cfg.d_ff
    E = cfg.n_experts
    scale = 1.0 / math.sqrt(d)

    def draw(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    return {
        "router": dense_init(gen, d, E, torch.float32, device),  # stays f32
        "gate": (draw(E, d, ff) * scale).to(dtype),
        "up": (draw(E, d, ff) * scale).to(dtype),
        "down": (draw(E, ff, d) / math.sqrt(ff)).to(dtype),
    }


def _dispatch_groups(cfg: ModelConfig, N: int, mode: str) -> int:
    """Dispatch groups: 1 (the reference's count with no mesh)."""
    return 1


def capacity(cfg: ModelConfig, Ng: int, mode: str) -> int:
    """Slots per expert and group: ceil(Ng K / E x capacity_factor) in
    prefill, Ng K (no drop possible) in decode; at least 8, a multiple of
    8."""
    K, E = cfg.top_k, cfg.n_experts
    C = Ng * K if mode == "decode" else int(math.ceil(Ng * K / E * cfg.capacity_factor))
    return max(8, -(-C // 8) * 8)


class Routing(NamedTuple):
    gates: torch.Tensor  # (G, Ng, K) in x's dtype
    e_idx: torch.Tensor  # (G, Ng*K) int64: expert, E where dropped
    s_idx: torch.Tensor  # (G, Ng*K) int64: slot, C where dropped
    keep: torch.Tensor   # (G, Ng*K) bool
    aux: torch.Tensor    # () f32 Switch load-balancing loss
    C: int


def route(p: Params, xt: torch.Tensor, cfg: ModelConfig, mode: str) -> Routing:
    """Top-k routing and capacity slots of the grouped tokens xt (G, Ng, D)."""
    G, Ng, _ = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = xt.float() @ p["router"].float()  # (G, Ng, E)
    probs = torch.softmax(logits, dim=-1)
    top_v, top_e = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_v, top_e = top_v[..., :K], top_e[..., :K]  # (G, Ng, K)
    gates = torch.softmax(top_v, dim=-1).to(xt.dtype)
    experts = torch.arange(E, device=xt.device)
    # Switch aux loss: E * sum_e fraction_tokens_e * mean_prob_e
    assign = (top_e[..., :1] == experts).float()  # top-1 one-hot
    aux = E * torch.mean(assign.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))

    C = capacity(cfg, Ng, mode)
    flat_e = top_e.reshape(G, Ng * K)  # token-major assignment order
    # expert-major one-hots, so that the cumsum runs along the last dim: a
    # scan along dim 1 of (G, Ng*K, E) walks each expert's column serially
    # and dominated granite's prefill on the card (chip_smoke.py
    # [serve-moe]'s warm prefill)
    onehot = (experts[:, None] == flat_e[:, None, :]).long()  # (G, E, Ng*K)
    pos = torch.cumsum(onehot, dim=-1) - 1  # position within expert
    slot = torch.gather(pos, 1, flat_e[:, None, :])[:, 0]
    keep = slot < C
    e_idx = torch.where(keep, flat_e, E)
    s_idx = torch.where(keep, slot, C)
    return Routing(gates, e_idx, s_idx, keep, aux, C)


def moe_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, mode: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss () f32)."""
    if mode not in MODES:
        raise NotImplementedError(
            f"moe mode {mode!r} is not ported yet: the port serves (prefill, "
            f"decode); training is ROADMAP Queue 1 item 12")
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    G = _dispatch_groups(cfg, N, mode)
    Ng = N // G
    xt = x.reshape(G, Ng, D)
    r = route(p, xt, cfg, mode)
    C = r.C

    # ---- bucketize: row e*C + s of each group's (E*C + 1, D) buffer; the
    # last row takes every dropped assignment and is sliced off
    flat = torch.where(r.keep, r.e_idx * C + r.s_idx, E * C)  # (G, Ng*K)
    xk = xt[:, :, None, :].expand(G, Ng, K, D).reshape(G, Ng * K, D)
    buckets = x.new_zeros((G, E * C + 1, D))
    buckets.scatter_(1, flat[..., None].expand(G, Ng * K, D), xk)
    buckets = buckets[:, :E * C].reshape(G, E, C, D)

    # ---- expert FFN, batched over (G, E)
    h = F.silu(buckets @ p["gate"]) * (buckets @ p["up"])  # (G, E, C, F)
    y = (h @ p["down"]).reshape(G, E * C, D)

    # ---- combine: each assignment's row times gate x keep, summed over K
    rows_at = r.e_idx.clamp(0, E - 1) * C + r.s_idx.clamp(0, C - 1)
    rows = torch.gather(y, 1, rows_at[..., None].expand(G, Ng * K, D))
    w = r.gates.reshape(G, Ng * K) * r.keep.to(x.dtype)
    out = (rows * w[..., None]).reshape(G, Ng, K, D).sum(dim=2)
    return out.reshape(B, S, D).to(x.dtype), r.aux
