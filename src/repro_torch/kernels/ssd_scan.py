"""K7 wrapper: the Mamba-2 SSD intra-chunk terms as a CUDA kernel.

Counterpart of ``repro.kernels.ssd_scan``. The kernel
(``csrc/ssd_chunk.cu``) computes, with a = cumsum(dtA) over the chunk's T
tokens,

  Y     = ((C B^T) * L) (X * dt),  L_ij = exp(a_i - a_j) for j <= i, else 0
  state = (B * exp(a_T - a) * dt)^T X

one CTA per (batch * chunk, group, block of the group's heads), forming
C B^T once per block (`cbt_per_chunk_group`) in f32; B and C come from
group h // (H / G). The two head products run on the TF32 tensor cores
with each f32 operand split into TF32 parts, so the sums keep f32's
precision. Y is stored in x's dtype and the state in f32, as the TPU
kernel's. The plain version is ``ref.ssd_chunk_plain``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

#: x, B and C dtypes, as the C entry's dtype code; dtA and dt are float32.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dta: torch.Tensor,
              dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BC, H, T, P), b and c (BC, G, T, N) in one dtype (float32 or
    bfloat16), dta and dt (BC, H, T) float32, all on the card. Returns
    (y (BC, H, T, P) in x's dtype, state (BC, H, N, P) float32).

    Raises on anything the kernel does not take: a CPU tensor, other or
    mixed dtypes, wrong ranks or shapes, H not a multiple of G, T > 128,
    P > 64, or a shape whose tiles do not fit in one SM's shared memory.
    """
    for name, t, ndim in (("x", x, 4), ("b", b, 4), ("c", c, 4), ("dta", dta, 3),
                          ("dt", dt, 3)):
        if t.device.type != "cuda" or t.ndim != ndim:
            raise ValueError(f"ssd_chunk takes {ndim}-D CUDA tensors for {name}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if x.dtype not in DTYPES or not (x.dtype == b.dtype == c.dtype):
        raise ValueError(f"ssd_chunk: x, b and c must share a float32 or bfloat16 "
                         f"dtype, got {x.dtype}, {b.dtype}, {c.dtype}")
    if dta.dtype != torch.float32 or dt.dtype != torch.float32:
        raise ValueError(f"ssd_chunk: dta and dt must be float32, got {dta.dtype}, "
                         f"{dt.dtype}")
    BC, H, T, P = x.shape
    _, G, _, N = b.shape
    if (b.shape != c.shape or b.shape[0] != BC or b.shape[2] != T
            or dta.shape != (BC, H, T) or dt.shape != (BC, H, T)):
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, dta {tuple(dta.shape)} and dt "
                         f"{tuple(dt.shape)} disagree")
    if G == 0 or H % G:
        raise ValueError(f"H={H} not a multiple of groups G={G}")
    if min(T, N, P) < 1:
        raise ValueError(f"ssd_chunk: T={T}, N={N}, P={P} must be positive")
    x, b, c, dta, dt = (t.contiguous() for t in (x, b, c, dta, dt))
    y = torch.empty_like(x)
    state = torch.empty((BC, H, N, P), dtype=torch.float32, device=x.device)
    if BC * H:
        with torch.cuda.device(x.device):
            _build.launch("ssd_chunk", x.data_ptr(), b.data_ptr(), c.data_ptr(),
                          dta.data_ptr(), dt.data_ptr(), y.data_ptr(), state.data_ptr(),
                          BC, H, G, T, N, P, DTYPES[x.dtype],
                          torch.cuda.current_stream().cuda_stream)
    return y, state


def cbt_per_chunk_group(BC: int, H: int, G: int, T: int, N: int, P: int,
                        dtype: torch.dtype) -> int:
    """How many times a launch at this shape forms each (chunk, group)'s
    C B^T: the head blocks the kernel splits a group into (on the card;
    the kernel library must be buildable). Raises on a shape it refuses."""
    n = _build.query("ssd_chunk_plan", BC, H, G, T, N, P, DTYPES[dtype])
    if n <= 0:
        raise ValueError(f"ssd_chunk refuses (BC, H, G, T, N, P) = "
                         f"{(BC, H, G, T, N, P)} in {dtype} (CUDA error {-n})")
    return n
