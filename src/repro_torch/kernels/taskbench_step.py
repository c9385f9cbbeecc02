"""K3 wrapper: the single-step Task Bench megakernel, and its host operands.

Counterpart of ``repro.kernels.taskbench_step`` at ``steps_per_launch=1``.
One launch of ``csrc/taskbench_step.cu`` runs one whole timestep for K
graphs: combine each output row's dependency rows of the previous state,
then the grain body on the combined row.

Operands (``prepare_step_operands`` builds idx/wgt host-side):

  src  (K, S, payload) f32  previous-state rows to combine from; S may
                            exceed the output width W (halo-extended rows).
  idx  (K, W, D) int32      dependency slot -> src row (gather / onehot).
                            Rows with no dependencies are self-padded
                            (idx = own row, weight 1), so the kernel needs
                            no branch for them.
  wgt  (K, W, D) f32        pre-normalised weights (1 / live count): the
                            masked mean is one weighted sum.

Combine modes (``COMBINE_MODES``): window (slot j weighs src row w + j;
idx unused), gather (src rows idx[w, j]), onehot (the same sum with
duplicate slots merged, the reference's one-hot matrix product), and pair
((src row w + src row W + w) * 0.5, the butterfly plan's mode; idx unused,
wgt's row count declares W). ``steps_per_launch > 1`` (the reference's
temporal-blocked kernel) is not ported yet: it raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bodies import apply_body, check_scratch

COMBINE_MODES = ("window", "gather", "onehot", "pair")
#: Task body kinds (``core.task_kernels.KernelSpec.kind``).
KINDS = ("compute_bound", "memory_bound", "empty")

#: Combine weights are accumulated host-side in this dtype and rounded ONCE
#: to WEIGHT_DTYPE by finalize_weights, for every operand builder.
WEIGHT_ACCUM_DTYPE = np.float64
WEIGHT_DTYPE = np.float32

BLOCKED_NOT_PORTED = (
    "steps_per_launch > 1 (the temporal-blocked megakernel, the reference's "
    "_blocked_step_kernel) is not ported yet: ROADMAP.md, port slice 2")


def finalize_weights(wgt: np.ndarray) -> np.ndarray:
    """Round host-accumulated combine weights once to the kernel dtype."""
    return np.asarray(wgt, WEIGHT_ACCUM_DTYPE).astype(WEIGHT_DTYPE)


def prepare_step_operands(dep_lists, width: int, self_pos) -> tuple:
    """Host-side build of one member's (idx, wgt) kernel operands.

    Args:
      dep_lists: length-``width`` list; entry p is the sequence of SRC ROW
        positions task p combines (duplicates weigh double). Empty ->
        self-padded.
      width: number of output rows W.
      self_pos: each row's own position in src (the zero-dep row).

    Returns:
      idx int32 (W, D), wgt WEIGHT_DTYPE (W, D) with D = max(1, max deps),
      weights 1 / live count, accumulated wide and rounded once.
    """
    D = max(1, max((len(d) for d in dep_lists), default=0))
    idx = np.zeros((width, D), dtype=np.int32)
    wgt = np.zeros((width, D), dtype=WEIGHT_ACCUM_DTYPE)
    for p, deps in enumerate(dep_lists):
        if not deps:
            idx[p, 0] = self_pos[p]
            wgt[p, 0] = 1.0
            continue
        w = 1.0 / len(deps)
        for j, q in enumerate(deps):
            idx[p, j] = q
            wgt[p, j] = w
    return idx, finalize_weights(wgt)


def check_step_operands(src, idx, wgt, *, combine: str, kind: str,
                        iterations: int, scratch: int,
                        steps_per_launch: int = 1) -> None:
    """The reference's operand checks for one step; raises ValueError.

    Same messages as ``repro.kernels.taskbench_step.taskbench_step_pallas``
    for an unknown mode, operand rank, K mismatch, pair (S == 2W), window
    (S >= W + D - 1) and gather/onehot (idx.shape == wgt.shape).
    """
    if combine not in COMBINE_MODES:
        raise ValueError(f"unknown combine mode {combine!r}; known {COMBINE_MODES}")
    if src.ndim != 3 or wgt.ndim not in (3, 4):
        raise ValueError(
            f"expected (K, S, payload)/(K, W, D) operands, got "
            f"{tuple(src.shape)}/{tuple(wgt.shape)}"
        )
    if wgt.ndim == 4 and steps_per_launch <= 1:
        raise ValueError(
            "time-varying (K, S, M, D) tables require steps_per_launch > 1")
    if steps_per_launch < 1:
        raise ValueError(f"steps_per_launch must be >= 1, got {steps_per_launch}")
    if steps_per_launch > 1:
        raise NotImplementedError(BLOCKED_NOT_PORTED)
    K, S, _ = src.shape
    _, W, D = wgt.shape
    if wgt.shape[0] != K:
        raise ValueError(f"operand K mismatch: {tuple(src.shape)}/{tuple(wgt.shape)}")
    if combine == "pair" and S != 2 * W:
        raise ValueError(
            f"pair combine needs src rows == 2 * W (the [x | partner] "
            f"halves), got {S} vs W = {W}")
    if combine in ("gather", "onehot") and tuple(idx.shape) != tuple(wgt.shape):
        raise ValueError(
            f"operand shape mismatch: {tuple(idx.shape)}/{tuple(wgt.shape)}")
    if combine == "window" and S < W + D - 1:
        raise ValueError(
            f"window combine needs src rows >= W + D - 1 = {W + D - 1}, "
            f"got {S} (window D = {D} includes the halo)"
        )
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    if kind == "memory_bound" and iterations > 0:
        check_scratch(scratch, extra_floats=src.shape[2])


def taskbench_step_plain(src, idx, wgt, *, kind: str = "compute_bound",
                         iterations: int = 16, scratch: int = 2048,
                         combine: str = "gather") -> torch.Tensor:
    """Plain PyTorch version of the kernel (operands checked by the caller)."""
    K, S, _ = src.shape
    W, D = wgt.shape[1], wgt.shape[2]
    srcf = src.float()
    if combine == "pair":
        x = (srcf[:, :W] + srcf[:, W:2 * W]) * 0.5
    elif combine == "window":
        x = torch.zeros((K, W, src.shape[2]), dtype=torch.float32, device=src.device)
        for j in range(D):
            x = x + srcf[:, j:j + W] * wgt[:, :, j, None]
    else:
        rows = idx.long().clamp(0, S - 1)
        w = wgt
        if combine == "onehot":
            # one weight per distinct row: the one-hot matrix merges
            # duplicate slots into the slot that names the row first
            same = rows[..., :, None] == rows[..., None, :]  # (K, W, D, D)
            earlier = torch.ones(D, D, dtype=torch.bool, device=src.device).tril(-1)
            first = ~(same & earlier).any(dim=-1)
            merged = (same.float() * wgt[..., None, :]).sum(dim=-1)
            w = torch.where(first, merged, torch.zeros_like(merged))
        members = torch.arange(K, device=src.device)[:, None, None]
        x = (srcf[members, rows] * w[..., None]).sum(dim=2)
    return apply_body(x.to(src.dtype), kind, iterations, scratch)


_MODE_CODE = {"window": 0, "gather": 1, "onehot": 2, "pair": 3}


def taskbench_step(src, idx, wgt, *, kind: str = "compute_bound",
                   iterations: int = 16, scratch: int = 2048,
                   combine: str = "gather",
                   steps_per_launch: int = 1) -> torch.Tensor:
    """K3: one fused Task Bench timestep for K graphs on the card.

    Checks the operands as the reference does, then launches
    ``csrc/taskbench_step.cu``; returns (K, W, payload). Raises on tensors
    that are not on the card, not contiguous float32 (int32 idx), or not
    on one device.
    """
    check_step_operands(src, idx, wgt, combine=combine, kind=kind,
                        iterations=iterations, scratch=scratch,
                        steps_per_launch=steps_per_launch)
    uses_idx = combine in ("gather", "onehot")
    tensors = (src, wgt, idx) if uses_idx else (src, wgt)
    for t, dtype in zip(tensors, (torch.float32, torch.float32, torch.int32)):
        if t.device != src.device or t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(
                f"taskbench_step takes float32 src/wgt and int32 idx on one "
                f"CUDA device, got {t.dtype} on {t.device}")
    K, S, P = src.shape
    W, D = wgt.shape[1], wgt.shape[2]
    if K > 65535:
        raise ValueError(f"K = {K} members exceed the kernel's grid (65535)")
    src, wgt = src.contiguous(), wgt.contiguous()
    idx = idx.contiguous() if uses_idx else None
    out = torch.empty((K, W, P), dtype=src.dtype, device=src.device)
    memory = kind == "memory_bound" and iterations > 0
    fma_iters = iterations if kind == "compute_bound" else 0
    if out.numel():
        with torch.cuda.device(src.device):
            _build.launch("taskbench_step", src.data_ptr(),
                          idx.data_ptr() if uses_idx else None,
                          wgt.data_ptr(), out.data_ptr(), K, S, W, P, D,
                          _MODE_CODE[combine], int(memory),
                          iterations if memory else fma_iters, scratch,
                          torch.cuda.current_stream().cuda_stream)
    return out
