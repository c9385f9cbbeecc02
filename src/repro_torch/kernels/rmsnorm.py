"""K8 wrapper: RMSNorm over rows as a CUDA kernel.

Counterpart of ``repro.kernels.rmsnorm``. The kernel (``csrc/rmsnorm.cu``)
gives each row to one warp: it sums x^2 in f32 over the row's true length
d, then writes x * rsqrt(sum / d + eps) * w in x's dtype. Where d and the
pointers allow (`vector_width`), a lane moves 16 bytes a load and holds its
part of the row in registers between the sum and the write; otherwise the
same launch takes a scalar path. The plain version is
``ref.rmsnorm_plain``. Only ``ops.rmsnorm`` reaches it: the models call
the plain ``models.layers.rmsnorm_fwd``, as the reference's do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: x and w dtypes, as the C entry's dtype codes (they may differ).
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def vector_width(x: torch.Tensor, w: torch.Tensor) -> int:
    """Elements of x the kernel moves per load: 16 bytes' worth (8 bf16, 4
    f32) when every row of the contiguous x starts 16-byte aligned (d a
    multiple of that width and x 16-byte aligned) and w is 16-byte
    aligned; else 1, the scalar path. The output is allocated aligned."""
    vec = 16 // x.element_size()
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return vec if aligned and x.shape[-1] % vec == 0 else 1


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x (rows, d) and w (d,) on the card, each float32 or bfloat16; returns
    (rows, d) in x's dtype. Raises on anything the kernel does not take."""
    for name, t, ndim in (("x", x, 2), ("w", w, 1)):
        if t.device.type != "cuda" or t.dtype not in DTYPES or t.ndim != ndim:
            raise ValueError(f"rmsnorm takes a {ndim}-D float32 or bfloat16 CUDA tensor "
                             f"for {name}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    rows, d = x.shape
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} on {w.device} does not fit x "
                         f"{tuple(x.shape)} on {x.device}")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    if out.numel():
        with torch.cuda.device(x.device):
            _build.launch("rmsnorm", x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                          eps, DTYPES[x.dtype], DTYPES[w.dtype], vector_width(x, w),
                          torch.cuda.current_stream().cuda_stream)
    return out
