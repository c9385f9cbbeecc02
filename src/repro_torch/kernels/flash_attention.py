"""K5 wrapper: blockwise online-softmax attention as a CUDA kernel.

Counterpart of ``repro.kernels.flash_attention``. The kernel
(``csrc/flash_attention.cu``) runs one CTA per (64-row q tile, q head,
batch) and loops over the key tiles the tile can see; its plain version is
``ref.attention_plain``. Forward only, as the TPU kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

#: Head dims the kernel is instantiated for (internlm2 128, gemma3 256,
#: stablelm 80, musicgen/granite/hymba 64, the reduced configs 16).
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: Operand dtypes, as the C entry's dtype code.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) on the card, one dtype
    (float32 or bfloat16); returns (B, Hq, Sq, D) in q's dtype.

    Raises on anything the kernel does not take: a CPU tensor, mixed or
    other dtypes, Hq not a multiple of Hkv, a head dim outside HEAD_DIMS.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype not in DTYPES or t.ndim != 4:
            raise ValueError(
                f"flash_attention takes 4-D float32 or bfloat16 CUDA tensors, got "
                f"{name} {tuple(t.shape)} {t.dtype} on {t.device}")
    if not (q.dtype == k.dtype == v.dtype) or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {q.dtype}, k {tuple(k.shape)} {k.dtype} "
                         f"and v {tuple(v.shape)} {v.dtype} must agree")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"differ in batch or head dim")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError("window must be >= 0")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    if o.numel():
        with torch.cuda.device(q.device):
            _build.launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), B, Hq, Hkv, Sq, Sk, D, int(causal), window,
                          sm_scale, DTYPES[q.dtype],
                          torch.cuda.current_stream().cuda_stream)
    return o
