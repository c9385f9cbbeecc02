"""K1 wrapper: the compute-bound Task Bench body as a CUDA kernel.

Counterpart of ``repro.kernels.taskbench_compute``. The kernel
(``csrc/taskbench_compute.cu``) iterates x <- 0.5*x + 0.1 in registers, a
thread's consecutive elements its independent chains: 4 (one 16-byte load
and store) where there are enough to fill the card, else 1; its plain
version is ``bodies.fma_body``. ``compute_plan`` sizes its launch from the
SM count (``launch_plan``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.launch_plan import (
    LaunchPlan,
    aligned,
    chains_for,
    cut_ctas,
    sm_count,
)


def compute_plan(n: int, sms: int) -> LaunchPlan:
    """K1's launch over n elements."""
    chains = chains_for(n, sms)
    return LaunchPlan(chains, *cut_ctas(-(-n // chains), sms))


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
        plan = compute_plan(x.numel(), sm_count(x.device.index or 0))
        with torch.cuda.device(x.device):
            _build.launch("taskbench_compute", x.data_ptr(), out.data_ptr(),
                          x.numel(), iterations, plan.chains, plan.threads,
                          int(aligned(x, out)), torch.cuda.current_stream().cuda_stream,
                          ctas=plan.ctas)
    return out
