"""K1 wrapper: the compute-bound Task Bench body as a CUDA kernel.

Counterpart of ``repro.kernels.taskbench_compute``. The kernel
(``csrc/taskbench_compute.cu``) iterates x <- 0.5*x + 0.1 in registers,
four independent chains per thread; its plain version is
``bodies.fma_body``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def taskbench_compute(x: torch.Tensor, iterations: int) -> torch.Tensor:
    """Iterated FMA over x: (rows, payload) f32 on the card; same shape out.

    Raises on anything but a 2-D float32 CUDA tensor.
    """
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(
            f"taskbench_compute takes a (rows, payload) float32 CUDA tensor, "
            f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            _build.launch("taskbench_compute", x.data_ptr(), out.data_ptr(),
                          x.numel(), iterations,
                          torch.cuda.current_stream().cuda_stream)
    return out
