"""Plain PyTorch oracles for the Task Bench kernels.

Counterpart of the Task Bench part of ``repro.kernels.ref``. These re-derive
the semantics independently of ``kernels/bodies.py`` (which the runtimes
and the CUDA kernels' plain versions share), so a test can catch a
regression in the shared bodies.
"""
from __future__ import annotations

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
