"""Plain PyTorch oracles: the Task Bench kernels', the attention kernels',
RMSNorm's and SSD's.

Counterpart of ``repro.kernels.ref``. The Task Bench oracles re-derive the
semantics independently of ``kernels/bodies.py`` (which the runtimes and
the CUDA kernels' plain versions share), so a test can catch a regression
in the shared bodies. ``attention_plain`` and ``decode_attention_plain``
are the plain versions of K5 and K6 (``ops.flash_attention`` and
``ops.decode_attention`` run them on CPU tensors and with
``use_kernel=False``), written from ``attention_ref`` and
``decode_attention_ref``; ``rmsnorm_plain`` (K8) and ``ssd_chunk_plain``
(K7) likewise, from ``rmsnorm_ref`` and ``ssd_chunk_ref``.
``ssd_sequential_plain`` is the token-by-token recurrence that chunked SSD
must equal.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.bodies import FMA_A, FMA_B


def taskbench_compute_ref(x: torch.Tensor, iterations: int) -> torch.Tensor:
    a = torch.tensor(FMA_A, dtype=x.dtype, device=x.device)
    b = torch.tensor(FMA_B, dtype=x.dtype, device=x.device)
    for _ in range(iterations):
        x = a * x + b
    return x


def taskbench_memory_ref(x: torch.Tensor, iterations: int, scratch: int) -> torch.Tensor:
    """Memory-bound scratch sweep, written independently of kernels.bodies:
    expand the payload to a (scratch,) working set, roll + add per
    iteration, mean-reduce back over the repeats (zero-padded tail)."""
    if iterations == 0:
        return x
    payload = x.shape[-1]
    reps = (scratch + payload - 1) // payload
    buf = torch.cat([x] * reps, dim=-1)[..., :scratch]
    for _ in range(iterations):
        buf = torch.cat([buf[..., -1:], buf[..., :-1]], dim=-1) + 1e-6
    zeros = buf.new_zeros(*buf.shape[:-1], reps * payload - scratch)
    buf = torch.cat([buf, zeros], dim=-1)
    return buf.reshape(*x.shape[:-1], reps, payload).sum(dim=-2) / reps


def taskbench_step_ref(src, idx, wgt, *, kind: str = "compute_bound",
                       iterations: int = 16, scratch: int = 2048) -> torch.Tensor:
    """Oracle for the fused-timestep megakernel: per member, gather the
    dependency rows, weighted-sum them in f32, then the grain body."""
    outs = []
    for s, i, w in zip(src, idx, wgt):
        x = (s[i.long()].float() * w[..., None]).sum(dim=1).to(s.dtype)
        if kind == "empty" or iterations == 0:
            pass
        elif kind == "compute_bound":
            x = taskbench_compute_ref(x, iterations)
        elif kind == "memory_bound":
            x = taskbench_memory_ref(x, iterations, scratch)
        else:
            raise ValueError(f"unknown kernel kind {kind!r}")
        outs.append(x)
    return torch.stack(outs)


# --------------------------------------------------------------- attention

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Dense masked softmax attention, f32 inside, q's dtype out.

    q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D); query head h reads key head
    h // (Hq // Hkv). Row i sees key j when j <= i (causal) and
    i - j < window (window > 0); a row that sees nothing gives 0.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kx = k.repeat_interleave(G, dim=1).float()
    vx = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * sm_scale
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= (qi - kj) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           sm_scale: Optional[float] = None, window: int = 0,
                           return_stats: bool = False):
    """One query per head over a cache: q (B, Hq, D), caches (B, Hkv, S, D),
    lengths (B,). Position p of sequence b is visible when p < lengths[b]
    and (window > 0) p >= lengths[b] - window. Returns o in q's dtype, or
    (o, m, l) with the f32 softmax max and sum per (b, head); a sequence
    that sees nothing gives o = 0, l = 0, m = -1e30.
    """
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    kx = k_cache.repeat_interleave(G, dim=1).float()
    vx = v_cache.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kx) * sm_scale
    pos = torch.arange(S, device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    valid = pos < lengths
    if window > 0:
        valid &= pos >= lengths - window
    valid = valid[:, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    lsafe = torch.where(l == 0.0, 1.0, l)
    o = (torch.einsum("bhs,bhsd->bhd", p, vx) / lsafe[..., None]).to(q.dtype)
    if return_stats:
        return o, m, l
    return o


# ----------------------------------------------------------------- rmsnorm


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w over the last dim, in f32, cast back
    to x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


# --------------------------------------------------------------------- SSD


def ssd_chunk_plain(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    dta: torch.Tensor, dt: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD terms for x (BC, H, T, P), b and c (BC, G, T, N),
    dta and dt (BC, H, T); head h reads group h // (H / G). With
    a = cumsum(dta) over the chunk, in f32:

      y[i]  = sum_{j <= i} (c_i . b_j) exp(a_i - a_j) dt_j x_j  (x's dtype)
      state = sum_t exp(a_T - a_t) dt_t b_t (outer) x_t          (f32)

    The cumsum adds in f32 in token order, one token after the other, as
    K7 does, so that both take the same a: a_i - a_j is a difference of two
    sums that may be far larger than it (|a| reaches hundreds for strongly
    decaying heads), and another association of the sum would move it by
    their rounding. The exponent is masked to -inf above the diagonal
    before ``exp`` (a_i - a_j > 0 there and may overflow), so no inf meets
    a 0.
    """
    T = x.shape[2]
    ratio = x.shape[1] // b.shape[1]
    bh = b.repeat_interleave(ratio, dim=1).float()  # (BC, H, T, N)
    ch = c.repeat_interleave(ratio, dim=1).float()
    xf = x.float()
    dta = dta.float()
    a = torch.empty_like(dta)  # (BC, H, T)
    run = torch.zeros_like(dta[..., 0])
    for t in range(T):
        run = run + dta[..., t]
        a[..., t] = run
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    logl = torch.where(causal, a[..., :, None] - a[..., None, :], float("-inf"))
    scores = torch.einsum("bhin,bhjn->bhij", ch, bh) * torch.exp(logl)
    y = torch.einsum("bhij,bhjp->bhip", scores, xf * dt.float()[..., None])
    decay_to_end = torch.exp(a[..., -1:] - a)  # (BC, H, T)
    bw = bh * (decay_to_end * dt.float())[..., None]
    state = torch.einsum("bhtn,bhtp->bhnp", bw, xf)
    return y.to(x.dtype), state


def ssd_sequential_plain(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         dta: torch.Tensor, dt: torch.Tensor,
                         init_state: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence, the ground truth for chunked SSD: x (B, S,
    H, P), b and c (B, S, G, N), dta and dt (B, S, H), init_state (B, H, N,
    P). Returns (y (B, S, H, P) in x's dtype, final state f32).

      S_t = exp(dtA_t) S_{t-1} + dt_t * B_t (outer) x_t ;   y_t = C_t . S_t
    """
    Bsz, S, H, P = x.shape
    N = b.shape[3]
    ratio = H // b.shape[2]
    bh = b.repeat_interleave(ratio, dim=2).float()
    ch = c.repeat_interleave(ratio, dim=2).float()
    xf, dta, dt = x.float(), dta.float(), dt.float()
    state = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        state = (torch.exp(dta[:, t])[..., None, None] * state
                 + torch.einsum("bhn,bhp->bhnp", bh[:, t] * dt[:, t, :, None], xf[:, t]))
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state
