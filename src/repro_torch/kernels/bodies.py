"""Grain-size task-body math for the Task Bench kernels, and the K2 wrapper.

Counterpart of ``repro.kernels.bodies``. The plain PyTorch bodies here are
the port's runtime reference path (``core.task_kernels`` with
``use_kernels=False``) and the plain versions the CUDA kernels are held
against; the CUDA kernels share one header of the same bodies
(``csrc/bodies.cuh``). ``kernels/ref.py`` re-derives the semantics
independently so a test can catch a regression here.

Bodies:

  compute_bound  iterated elementwise FMA x <- A*x + B; |A| < 1 keeps any
                 grain size bounded while staying un-foldable.
  memory_bound   scratch sweep: expand the payload into a (scratch,)
                 working set, roll + add per iteration, reduce back.
  empty          identity.

The reference's ``LANE``/``SUBLANE`` are TPU tile sizes and have no
counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

FMA_A = 0.5
FMA_B = 0.1
SWEEP_ADD = 1e-6

#: Shared memory one CTA may use on an H100 (bytes): bounds the sweep's
#: two scratch buffers, which the CUDA kernels keep on chip.
SMEM_LIMIT = 232448


def fma_body(x: torch.Tensor, iterations: int) -> torch.Tensor:
    """Iterated FMA: x <- A*x + B, ``iterations`` times."""
    for _ in range(iterations):
        x = x * FMA_A + FMA_B
    return x


def memory_sweep_body(x: torch.Tensor, iterations: int, scratch: int) -> torch.Tensor:
    """Stream a scratch buffer ``iterations`` times over x: (..., payload).

    Each point tiles its payload into a (scratch,) working set, rolls it by
    one and adds SWEEP_ADD per iteration, then reduces back to payload size
    by the mean over the ceil(scratch / payload) repeats; the zero-padded
    tail counts in the mean's denominator.
    """
    lead, payload = x.shape[:-1], x.shape[-1]
    reps = -(-scratch // payload)
    buf = x.repeat(*([1] * len(lead)), reps)[..., :scratch]
    for _ in range(iterations):
        buf = torch.roll(buf, 1, dims=-1) + SWEEP_ADD
    buf = torch.nn.functional.pad(buf, (0, reps * payload - scratch))
    return buf.reshape(*lead, reps, payload).mean(dim=-2)


def apply_body(x: torch.Tensor, kind: str, iterations: int, scratch: int) -> torch.Tensor:
    """Body dispatch by kind; iterations 0 and ``empty`` are the identity."""
    if kind == "empty" or iterations == 0:
        return x
    if kind == "compute_bound":
        return fma_body(x, iterations)
    if kind == "memory_bound":
        return memory_sweep_body(x, iterations, scratch)
    raise ValueError(f"unknown kernel kind {kind!r}")


def sweep_floats(payload: int, scratch: int) -> int:
    """Floats of shared memory one warp's sweep takes (``bodies.cuh``'s
    ``sweep_floats``): the payload row and the two scratch buffers, each
    rounded up to 16 bytes."""
    return -(-payload // 4) * 4 + 2 * (-(-scratch // 4) * 4)


def check_scratch(scratch: int, extra_floats: int = 0) -> None:
    """Raise if one row's sweep (a row of ``extra_floats`` and the two
    buffers) does not fit one CTA's shared memory."""
    need = 4 * sweep_floats(extra_floats, scratch)
    if scratch < 1 or need > SMEM_LIMIT:
        raise ValueError(
            f"scratch {scratch} needs {need} bytes of shared memory per row; "
            f"the CUDA sweep holds at most {SMEM_LIMIT} bytes per CTA")


def memory_bound(x: torch.Tensor, iterations: int, scratch: int) -> torch.Tensor:
    """K2: the scratch sweep over x: (rows, payload) f32 on the card.

    Launches ``csrc/memory_bound.cu`` (a warp per row, the working set in
    shared memory, the next row staged beside it). Same shape and dtype out; iterations 0 is the identity.
    Raises on anything but a contiguous 2-D float32 CUDA tensor.
    """
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(
            f"memory_bound takes a (rows, payload) float32 CUDA tensor, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    check_scratch(scratch, extra_floats=2 * sweep_floats(x.shape[1], 0))
    x = x.contiguous()
    out = torch.empty_like(x)
    rows, payload = x.shape
    if x.numel():
        with torch.cuda.device(x.device):
            _build.launch("memory_bound", x.data_ptr(), out.data_ptr(), rows,
                          payload, iterations, scratch,
                          torch.cuda.current_stream().cuda_stream)
    return out
