"""Public wrappers over the port's kernels: Task Bench's, attention's,
RMSNorm's and SSD's.

Counterpart of ``repro.kernels.ops``, every wrapper of it. One rule for
all of them: a tensor on the CPU goes to the kernel's plain PyTorch
version; a tensor on the card goes to the CUDA kernel, which launches or
raises. There is no fallback from the card to the plain version, and a
tensor on any other device raises. The attention, RMSNorm and SSD wrappers
also take ``use_kernel=False``, which runs the plain version on either
device, as the reference's do. Each kernel's launches are counted in
``_build.LAUNCHES`` (see `launch_counts`), by the wrapper that launches it.
``ssd`` wraps K7 in the chunk reshapes and the inter-chunk recurrence;
``ssd_decode_step`` is plain PyTorch, as the reference's is plain jnp.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bodies import apply_body, fma_body, memory_bound
from repro_torch.kernels.decode_attention import decode_attention as _decode_kernel
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm_kernel
from repro_torch.kernels.ssd_scan import ssd_chunk as _ssd_chunk_kernel
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


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            use_kernel: bool = True) -> torch.Tensor:
    """RMSNorm over the last dim of x (..., d) with weights w (d,): K8 on the
    card, ``ref.rmsnorm_plain`` on the CPU or with ``use_kernel=False``."""
    if not (use_kernel and _on_card(x)):
        return ref.rmsnorm_plain(x, w, eps)
    shape = x.shape
    return _rmsnorm_kernel(x.reshape(-1, shape[-1]), w, eps=eps).reshape(shape)


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dta: torch.Tensor,
              dt: torch.Tensor, use_kernel: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD terms (y (BC, H, T, P) in x's dtype, state (BC, H, N,
    P) f32): K7 on the card, ``ref.ssd_chunk_plain`` on the CPU or with
    ``use_kernel=False``."""
    if use_kernel and _on_card(x):
        return _ssd_chunk_kernel(x, b, c, dta, dt)
    return ref.ssd_chunk_plain(x, b, c, dta, dt)


def ssd(
    x: torch.Tensor,    # (B, S, H, P)
    b: torch.Tensor,    # (B, S, G, N)
    c: torch.Tensor,    # (B, S, G, N)
    dta: torch.Tensor,  # (B, S, H)   dt * A (negative)
    dt: torch.Tensor,   # (B, S, H)
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD: the intra-chunk terms (K7) and the inter-chunk
    recurrence over the NC per-chunk states, a loop over chunks in f32.

    Returns (y (B, S, H, P) in x's dtype, final state (B, H, N, P) f32).
    The sequence length must be a multiple of ``chunk`` (callers pad).
    """
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if S % chunk:
        raise ValueError(f"seq {S} not a multiple of chunk {chunk}")
    NC, T = S // chunk, chunk

    # chunks, head-major for the kernel
    xc = x.reshape(B, NC, T, H, P).permute(0, 1, 3, 2, 4).reshape(B * NC, H, T, P)
    bc = b.reshape(B, NC, T, G, N).permute(0, 1, 3, 2, 4).reshape(B * NC, G, T, N)
    cc = c.reshape(B, NC, T, G, N).permute(0, 1, 3, 2, 4).reshape(B * NC, G, T, N)
    dtac = dta.reshape(B, NC, T, H).permute(0, 1, 3, 2).reshape(B * NC, H, T)
    dtc = dt.reshape(B, NC, T, H).permute(0, 1, 3, 2).reshape(B * NC, H, T)

    y_intra, states = ssd_chunk(xc, bc, cc, dtac, dtc, use_kernel=use_kernel)
    y_intra = y_intra.reshape(B, NC, H, T, P)
    states = states.reshape(B, NC, H, N, P)

    # the inter-chunk recurrence: carry the state across chunks
    a_cum = torch.cumsum(dtac.float(), dim=-1).reshape(B, NC, H, T)
    chunk_decay = torch.exp(a_cum[..., -1])  # (B, NC, H)
    decay_in = torch.exp(a_cum)  # decay from the chunk's start to each token
    ch = ref.repeat_heads(cc.reshape(B, NC, G, T, N), H // G, 2).float()
    carry = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    y_inter = []
    for k in range(NC):
        y_inter.append(torch.einsum("bhtn,bhnp->bhtp",
                                    ch[:, k] * decay_in[:, k, ..., None], carry))
        carry = carry * chunk_decay[:, k, :, None, None] + states[:, k]
    y = y_intra.float() + torch.stack(y_inter, dim=1)
    y = y.permute(0, 1, 3, 2, 4).reshape(B, S, H, P).to(x.dtype)
    return y, carry


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, N, P) f32, updated in place
    xt: torch.Tensor,     # (B, H, P)
    bt: torch.Tensor,     # (B, G, N)
    ct: torch.Tensor,     # (B, G, N)
    dtat: torch.Tensor,   # (B, H)
    dtt: torch.Tensor,    # (B, H)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the SSD recurrence (the serving path), plain PyTorch:
    state <- exp(dtA) state + dt B (outer) x, y = C . state. Unlike the
    reference, ``state`` is updated in place (and returned), so a serving
    loop keeps one state buffer. Returns (state, y (B, H, P) in xt's dtype).
    """
    ratio = state.shape[1] // bt.shape[1]
    bh = bt.repeat_interleave(ratio, dim=1).float()
    ch = ct.repeat_interleave(ratio, dim=1).float()
    state.mul_(torch.exp(dtat.float())[..., None, None])
    state.add_(torch.einsum("bhn,bhp->bhnp", bh * dtt.float()[..., None], xt.float()))
    y = torch.einsum("bhn,bhnp->bhp", ch, state)
    return state, y.to(xt.dtype)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last `reset_launch_counts`, per kernel."""
    return {entry: _build.LAUNCHES[entry] for entry in _build.ENTRIES}


def host_calls() -> int:
    """Host calls that issued device work since the last
    `reset_launch_counts`: graph replays and the per-task backend's eager
    task calls (``_build.HOST_CALLS``)."""
    return _build.HOST_CALLS


def reset_launch_counts() -> None:
    _build.reset_launches()
