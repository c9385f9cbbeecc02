"""K3 and K4 wrappers: the Task Bench megakernels, and their host operands.

Counterpart of ``repro.kernels.taskbench_step``. One launch of
``csrc/taskbench_step.cu`` (K3) runs one whole timestep for K graphs:
combine each output row's dependency rows of the previous state, then the
grain body on the combined row. One launch of ``csrc/taskbench_blocked.cu``
(K4, ``steps_per_launch=S > 1``) runs S timesteps on a deep-halo working
buffer (the contract below).

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
wgt's row count declares W). Index rule of gather and onehot, as the
reference's: a negative gather index counts once from the end (i + S), then
the row is clamped to [0, S - 1]; an onehot slot outside [0, S) adds
nothing.

One-device halo wrap (``wrap=H``, K3 only): src is the un-extended (K, W,
payload) state, read as the halo-extended source of W + 2H rows whose
position p is state row (p - H) mod W (a true modulo: exact at W <= 2H,
dependencies more than one ring away). The index rule applies to that
extended length. The result equals the same call on
``wrap_rows(src, H)`` bit for bit, in one launch.

Temporal blocking (``steps_per_launch=S > 1``, K4): square operands, src
(K, M, payload) and wgt (K, M, D) (every working row carries its own
weights), a required (K, S) ``act`` mask (member k runs depth d iff
act[k, d] > 0.5; otherwise its buffer passes through), and the full
(K, M, payload) buffer after S depths out. The window combine is centred
and zero-padded: row i sums rows i - h .. i + h (D = 2h + 1).
Gather/onehot idx address the buffer itself, and may carry a depth axis,
(K, S, M, D), one table per depth. pair is rejected. The caller slices the
rows still valid after S depths (each depth's valid span shrinks by the
pattern's radius per side); ``taskbench_step_interior`` and
``taskbench_step_boundary`` are the pipelined runtime's two phases.

K4's two forms. ``radius=r`` declares that the tables reach at most r
rows: row i's taps read rows in [i - r, i + r] only (the window's reach is
D - 1 - (D - 1) // 2, and must not exceed r). With fixed tables and the
compute or empty body, a declared radius takes the tiled form
(``taskbench_blocked_tiled``, rows tiled over CTAs by `plan_tiles`, each
tile carrying its own S * r halo); without one, with time-varying tables,
or with the memory body, the cooperative form (``taskbench_blocked``).
Both give the same bits. A table that reaches past its declared radius
raises on the CPU; on the card the tiled form reads NaN for such a tap.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.bodies import SMEM_LIMIT, apply_body, check_scratch
from repro_torch.kernels.launch_plan import (
    LaunchPlan,
    chains_for,
    cut_ctas,
    sm_count,
)

COMBINE_MODES = ("window", "gather", "onehot", "pair")
#: Task body kinds (``core.task_kernels.KernelSpec.kind``).
KINDS = ("compute_bound", "memory_bound", "empty")

#: Combine weights are accumulated host-side in this dtype and rounded ONCE
#: to WEIGHT_DTYPE by finalize_weights, for every operand builder.
WEIGHT_ACCUM_DTYPE = np.float64
WEIGHT_DTYPE = np.float32

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


def check_step_operands(src, idx, wgt, act=None, *, combine: str, kind: str,
                        iterations: int, scratch: int,
                        steps_per_launch: int = 1,
                        radius: Optional[int] = None,
                        wrap: Optional[int] = None) -> None:
    """The reference's operand checks; raises ValueError.

    Same messages as ``repro.kernels.taskbench_step.taskbench_step_pallas``
    (and, at ``steps_per_launch > 1``, its ``_blocked_call``) for an unknown
    mode, operand rank, K mismatch, pair (S == 2W), window (S >= W + D - 1)
    and gather/onehot (idx.shape == wgt.shape); blocked: the act mask,
    square operands, time-varying tables and pair. The port's own: a
    ``radius`` only with ``steps_per_launch > 1``, non-negative, and no
    smaller than a window's reach; a ``wrap`` only with
    ``steps_per_launch = 1``, non-negative, not with pair, and on a src of
    the tables' W rows (the window check then reads W + 2 * wrap rows).
    """
    if combine not in COMBINE_MODES:
        raise ValueError(f"unknown combine mode {combine!r}; known {COMBINE_MODES}")
    if wrap is not None:
        if steps_per_launch != 1:
            raise ValueError("wrap is K3's (steps_per_launch = 1)")
        if wrap < 0:
            raise ValueError(f"wrap must be >= 0, got {wrap}")
        if combine == "pair":
            raise ValueError("pair combine takes no wrap (it reads [x | partner] halves)")
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
        if act is None:
            raise ValueError("steps_per_launch > 1 requires an act mask")
        if act.ndim != 2 or act.shape[1] != steps_per_launch:
            raise ValueError(
                f"act must be (K, {steps_per_launch}), got {tuple(act.shape)}")
        _check_blocked_operands(src, idx, wgt, act, combine)
    else:
        _check_single_step_operands(src, idx, wgt, combine, wrap)
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    if iterations < 0:
        raise ValueError("iterations must be >= 0")
    if kind == "memory_bound" and iterations > 0:
        check_scratch(scratch, extra_floats=src.shape[2])
    if radius is not None:
        if steps_per_launch <= 1:
            raise ValueError("radius is K4's (steps_per_launch > 1)")
        if radius < 0:
            raise ValueError(f"radius must be >= 0, got {radius}")
        if combine == "window" and window_reach(wgt.shape[-1]) > radius:
            raise ValueError(
                f"a window of D = {wgt.shape[-1]} reaches "
                f"{window_reach(wgt.shape[-1])} rows, beyond radius {radius}")


def _check_single_step_operands(src, idx, wgt, combine: str,
                                wrap: Optional[int] = None) -> None:
    K, S, _ = src.shape
    _, W, D = wgt.shape
    if wgt.shape[0] != K:
        raise ValueError(f"operand K mismatch: {tuple(src.shape)}/{tuple(wgt.shape)}")
    if wrap is not None:
        if S != W:
            raise ValueError(
                f"wrap reads src as the (K, W, payload) state: src rows {S} != "
                f"table rows W = {W}")
        S = W + 2 * wrap
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


def _check_blocked_operands(src, idx, wgt, act, combine: str) -> None:
    K, M, _ = src.shape
    S = act.shape[1]
    if combine == "pair":
        raise ValueError(
            "pair combine is per-step only (blocked butterfly launches "
            "use gather/onehot with time-varying tables)")
    if wgt.ndim == 4:
        if combine == "window":
            raise ValueError(
                "window combine has no time-varying form (halo patterns "
                "have period 1); use gather or onehot")
        if tuple(wgt.shape[:3]) != (K, S, M):
            raise ValueError(
                f"time-varying tables must be (K, S, M, D) = ({K}, {S}, "
                f"{M}, ...), got {tuple(wgt.shape)}")
        if tuple(idx.shape) != tuple(wgt.shape):
            raise ValueError(
                f"operand shape mismatch: {tuple(idx.shape)}/{tuple(wgt.shape)}")
    else:
        if tuple(wgt.shape[:2]) != (K, M):
            raise ValueError(
                f"blocked path needs square operands: src {tuple(src.shape)} vs "
                f"wgt {tuple(wgt.shape)} (every working row carries its own weights)"
            )
        if combine != "window" and tuple(idx.shape) != tuple(wgt.shape):
            raise ValueError(
                f"operand shape mismatch: {tuple(idx.shape)}/{tuple(wgt.shape)}")
    if act.shape[0] != K:
        raise ValueError(f"act must be (K, S), got {tuple(act.shape)} for K={K}")


def _slot_combine(srcf, idx, wgt, onehot: bool) -> torch.Tensor:
    """Gather/onehot weighted sum of (K, S, P) rows over (K, R, D) slots,
    under the reference's index rule (see the module docstring)."""
    K, S = srcf.shape[0], srcf.shape[1]
    D = wgt.shape[-1]
    raw = idx.long()
    rows = torch.where(raw < 0, raw + S, raw).clamp(0, S - 1)
    w = wgt
    if onehot:
        # one weight per distinct in-range row: the one-hot matrix merges
        # duplicate slots into the slot that names the row first, and an
        # index outside [0, S) matches none of its columns
        same = raw[..., :, None] == raw[..., None, :]  # (K, R, D, D)
        earlier = torch.ones(D, D, dtype=torch.bool, device=srcf.device).tril(-1)
        first = ~(same & earlier).any(dim=-1) & (raw >= 0) & (raw < S)
        merged = (same.float() * wgt[..., None, :]).sum(dim=-1)
        w = torch.where(first, merged, torch.zeros_like(merged))
    members = torch.arange(K, device=srcf.device)[:, None, None]
    return (srcf[members, rows] * w[..., None]).sum(dim=2)


def halo_rows(width: int, halo: int, device=None) -> torch.Tensor:
    """Rows of the halo-extended source, [-halo, width + halo) mod width:
    the one-device ring exchange, exact at any depth (a true modulo)."""
    return torch.arange(-halo, width + halo, device=device) % width


def wrap_rows(x: torch.Tensor, wrap: int, row_axis: int = 1) -> torch.Tensor:
    """x halo-extended by ``wrap`` rows a side along ``row_axis`` (the (K, W,
    payload) state by default): rows `halo_rows` (p - wrap) mod W."""
    W = x.shape[row_axis]
    if W == 0:
        return x
    return x.index_select(row_axis, halo_rows(W, wrap, x.device))


def taskbench_step_plain(src, idx, wgt, *, kind: str = "compute_bound",
                         iterations: int = 16, scratch: int = 2048,
                         combine: str = "gather",
                         wrap: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K3 (operands checked by the caller); with
    ``wrap``, `wrap_rows` and then the same."""
    if wrap is not None:
        src = wrap_rows(src, wrap)
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
        x = _slot_combine(srcf, idx, wgt, combine == "onehot")
    return apply_body(x.to(src.dtype), kind, iterations, scratch)


def taskbench_step_blocked_plain(src, idx, wgt, act, *,
                                 kind: str = "compute_bound",
                                 iterations: int = 16, scratch: int = 2048,
                                 combine: str = "gather") -> torch.Tensor:
    """Plain PyTorch version of K4 (operands checked by the caller)."""
    M = src.shape[1]
    time_varying = wgt.ndim == 4
    buf = src.float()
    for d in range(act.shape[1]):
        w = wgt[:, d] if time_varying else wgt
        if combine == "window":
            h = (w.shape[2] - 1) // 2
            work = F.pad(buf, (0, 0, h, h))  # zero rows +-h
            x = torch.zeros_like(buf)
            for j in range(w.shape[2]):
                x = x + work[:, j:j + M] * w[:, :, j, None]
        else:
            x = _slot_combine(buf, idx[:, d] if time_varying else idx, w,
                              combine == "onehot")
        x = apply_body(x, kind, iterations, scratch)
        buf = torch.where(act[:, d, None, None] > 0.5, x, buf)
    return buf.to(src.dtype)


def window_reach(D: int) -> int:
    """Rows a D-tap window reaches: taps i - h .. i - h + D - 1, h = (D-1)//2."""
    return D - 1 - (D - 1) // 2


def table_reach(idx, wgt, combine: str) -> int:
    """The farthest row any row's taps read, |row read - row|, over a (.., M,
    D) table under the index rule (a gather index wrapped and clamped, an
    onehot slot outside [0, M) read by none)."""
    if combine == "window":
        return window_reach(wgt.shape[-1])
    M = wgt.shape[-2]
    raw = idx.long()
    own = torch.arange(M, device=raw.device)[:, None]
    if combine == "gather":
        rows = torch.where(raw < 0, raw + M, raw).clamp(0, M - 1)
        off = (rows - own).abs()
    else:
        off = torch.where((raw >= 0) & (raw < M), (raw - own).abs(),
                          torch.zeros_like(raw))
    return int(off.max()) if off.numel() else 0


#: Elements an SM keeps in flight to hide the FMA's latency: 128 f32 lanes
#: x 4 cycles. A depth with fewer costs as much as one with this many.
LATENCY_ELEMS = 512
#: The narrowest column slice `plan_tiles` takes: 8 floats, one 32-byte
#: sector of a row (unless the payload is narrower).
MIN_SLICE = 8


class TilePlan(NamedTuple):
    """How the tiled K4 form cuts a (K, M, P) buffer: CTA (member k, tile,
    slice) owns rows [tile * tile_rows, ...) and columns [slice << col_shift,
    ...), and loads up to ``loaded_rows`` rows (its own and the S * reach
    halo each side) into ``smem_bytes`` of shared memory."""

    tile_rows: int
    col_shift: int
    n_tiles: int
    n_slices: int
    loaded_rows: int
    smem_bytes: int
    ctas: int


def tiled_smem_bytes(loaded_rows: int, col_shift: int, D: int,
                     uses_idx: bool) -> int:
    """Shared memory of a tiled CTA (the kernel's ``tiled_smem_floats``):
    two buffers of the loaded rows' slice, their weights and indices."""
    return 4 * (2 * (loaded_rows << col_shift)
                + loaded_rows * D * (2 if uses_idx else 1))


@lru_cache(maxsize=256)
def plan_tiles(K: int, M: int, P: int, S: int, reach: int, D: int,
               uses_idx: bool, sms: int = 132,
               smem_limit: int = SMEM_LIMIT) -> Optional[TilePlan]:
    """The tiled form's cut of a (K, M, P) buffer, or None if no tile fits.

    Over column slices of 2^j floats (at least MIN_SLICE, at most the
    payload rounded up to a power of two) and tile heights ceil(M / n), it
    takes the cut that minimises the modelled time: waves of one CTA an SM,
    ceil(CTAs / sms), times a CTA's work, the elements of its S depths
    (depth d computes its rows and (S-1-d) * reach halo rows each side), a
    depth counted as at least LATENCY_ELEMS; ties go to fewer CTAs.
    """
    if min(K, M, P, S) < 1 or reach < 0:
        return None
    top = max(0, (P - 1).bit_length())  # the payload rounded up to 2^top
    low = min(top, (MIN_SLICE - 1).bit_length())
    best, best_key = None, None
    for sh in range(low, top + 1):
        width = 1 << sh
        n_slices = -(-P // width)
        seen = set()
        for n in range(1, min(M, 4 * sms) + 1):
            rows = -(-M // n)
            if rows in seen:
                continue
            seen.add(rows)
            loaded = min(M, rows + 2 * S * reach)
            smem = tiled_smem_bytes(loaded, sh, D, uses_idx)
            if smem > smem_limit:
                continue
            n_tiles = -(-M // rows)
            ctas = K * n_tiles * n_slices
            work = sum(max(min(M, rows + 2 * (S - 1 - d) * reach) * width,
                           LATENCY_ELEMS) for d in range(S))
            key = (-(-ctas // sms) * work, ctas)
            if best_key is None or key < best_key:
                best_key = key
                best = TilePlan(rows, sh, n_tiles, n_slices, loaded, smem, ctas)
    return best


def tile_spans(plan: TilePlan, M: int, S: int, reach: int):
    """Each tile's (t0, t1, lo, hi): its output rows [t0, t1) and the rows
    [lo, hi) it loads, as the kernel computes them."""
    spans = []
    for tile in range(plan.n_tiles):
        t0 = tile * plan.tile_rows
        t1 = min(M, t0 + plan.tile_rows)
        spans.append((t0, t1, max(0, t0 - S * reach), min(M, t1 + S * reach)))
    return spans


_MODE_CODE = {"window": 0, "gather": 1, "onehot": 2, "pair": 3}


def _require_card(tensors, dtypes) -> None:
    src = tensors[0]
    for t, dtype in zip(tensors, dtypes):
        if t.device != src.device or t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(
                f"taskbench_step takes float32 src/wgt/act and int32 idx on one "
                f"CUDA device, got {t.dtype} on {t.device}")


def taskbench_step(src, idx, wgt, act=None, *, kind: str = "compute_bound",
                   iterations: int = 16, scratch: int = 2048,
                   combine: str = "gather",
                   steps_per_launch: int = 1,
                   radius: Optional[int] = None,
                   wrap: Optional[int] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 (one timestep) or K4 (``steps_per_launch > 1``) on the card.

    Checks the operands as the reference does, then launches
    ``csrc/taskbench_step.cu`` (with ``wrap``, on the un-extended state, see
    the module docstring) and returns (K, W, payload), written into ``out``
    where given (a contiguous (K, W, payload) float32 tensor on the card,
    e.g. the owned rows of a halo-extended buffer), or
    ``csrc/taskbench_blocked.cu`` (its tiled form when ``radius`` declares
    the tables' reach and the form applies, see the module docstring) and
    returns (K, M, payload). Raises on tensors that are not on the card,
    not float32 (int32 idx), or not on one device.
    """
    check_step_operands(src, idx, wgt, act, combine=combine, kind=kind,
                        iterations=iterations, scratch=scratch,
                        steps_per_launch=steps_per_launch, radius=radius,
                        wrap=wrap)
    uses_idx = combine in ("gather", "onehot")
    memory = kind == "memory_bound" and iterations > 0
    body_iters = iterations if memory or kind == "compute_bound" else 0
    if steps_per_launch > 1:
        if out is not None:
            raise ValueError("out= is K3's (steps_per_launch = 1)")
        return _launch_blocked(src, idx if uses_idx else None, wgt, act, combine,
                               memory, body_iters, scratch, radius)
    tensors = (src, wgt, idx) if uses_idx else (src, wgt)
    _require_card(tensors, (torch.float32, torch.float32, torch.int32))
    K, S, P = src.shape
    W, D = wgt.shape[1], wgt.shape[2]
    if K > 65535:
        raise ValueError(f"K = {K} members exceed the kernel's grid (65535)")
    if W * P >= 2**31:
        raise ValueError(f"W = {W} rows of {P} columns exceed the kernel's 32-bit index")
    src, wgt = src.contiguous(), wgt.contiguous()
    idx = idx.contiguous() if uses_idx else None
    if out is None:
        out = torch.empty((K, W, P), dtype=src.dtype, device=src.device)
    elif (tuple(out.shape) != (K, W, P) or out.dtype != src.dtype
          or out.device != src.device or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous ({K}, {W}, {P}) {src.dtype} tensor on "
            f"{src.device}, got {tuple(out.shape)} {out.dtype} on {out.device}"
            f"{'' if out.is_contiguous() else ', not contiguous'}")
    if out.numel():
        plan = step_plan(K, W, P, sm_count(src.device.index or 0))
        # the memory body runs a warp per (member, row), not the plan
        ctas = K * W if memory else plan.ctas
        with torch.cuda.device(src.device):
            _build.launch("taskbench_step", src.data_ptr(),
                          idx.data_ptr() if uses_idx else None,
                          wgt.data_ptr(), out.data_ptr(), K,
                          S if wrap is None else W + 2 * wrap, W, P, D,
                          _MODE_CODE[combine], int(memory), body_iters,
                          scratch, -1 if wrap is None else wrap, plan.chains,
                          plan.threads, torch.cuda.current_stream().cuda_stream,
                          ctas=ctas)
    return out


def step_plan(K: int, W: int, P: int, sms: int = 132) -> LaunchPlan:
    """K3's compute launch: a thread per (member, row, ``chains`` columns),
    4 columns where K * W * P gives every SM `FILL` elements, else 1, cut
    by `cut_ctas` (a grid row per member). The memory body runs a warp per
    (member, row) instead."""
    chains = chains_for(K * W * P, sms)
    return LaunchPlan(chains, *cut_ctas(W * -(-P // chains), sms, K))


def cooperative_only(wgt_ndim: int, memory: bool,
                     radius: Optional[int]) -> Optional[str]:
    """Why a K4 launch takes the cooperative form whatever its size (each
    rule that binds, joined), or None when the tiled form may apply."""
    why = []
    if memory:
        why.append("the memory body runs only in K4's cooperative form")
    if radius is None:
        why.append("the launch declares no radius (its tables may reach any row)")
    if wgt_ndim != 3:
        why.append("time-varying (K, S, M, D) tables run only in K4's cooperative form")
    return "; ".join(why) or None


def blocked_plan(src_shape, wgt_shape, S: int, combine: str, memory: bool,
                 radius: Optional[int], sms: int = 132) -> Optional[TilePlan]:
    """K4's form rule: the tiled form's plan when a radius is declared, the
    (K, M, D) tables are fixed, the body is not the memory sweep and a tile
    fits in shared memory; None for the cooperative form."""
    if cooperative_only(len(wgt_shape), memory, radius):
        return None
    K, M, P = src_shape
    D = wgt_shape[-1]
    reach = window_reach(D) if combine == "window" else radius
    return plan_tiles(K, M, P, S, reach, D, combine != "window", sms)


def _launch_blocked(src, idx, wgt, act, combine, memory, iterations, scratch,
                    radius=None):
    """One K4 launch on checked operands; idx is None for window."""
    tensors = (src, wgt, act) if idx is None else (src, wgt, act, idx)
    _require_card(tensors, (torch.float32,) * 3 + (torch.int32,))
    K, M, P = src.shape
    S, D = act.shape[1], wgt.shape[-1]
    src, wgt, act = src.contiguous(), wgt.contiguous(), act.contiguous()
    idx = None if idx is None else idx.contiguous()
    out = torch.empty_like(src)
    if not out.numel():
        return out
    plan = blocked_plan(src.shape, wgt.shape, S, combine, memory, radius,
                        sm_count(src.device.index or 0))
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        if plan is not None:
            if K > 65535:
                raise ValueError(f"K = {K} members exceed the kernel's grid (65535)")
            _build.launch("taskbench_blocked_tiled", src.data_ptr(),
                          None if idx is None else idx.data_ptr(),
                          wgt.data_ptr(), act.data_ptr(), out.data_ptr(),
                          K, M, P, D, S, _MODE_CODE[combine],
                          window_reach(D) if combine == "window" else radius,
                          iterations, plan.tile_rows, plan.col_shift, stream)
            return out
        tmp = torch.empty_like(src)  # the depths' ping-pong partner of out
        _build.launch("taskbench_blocked", src.data_ptr(),
                      None if idx is None else idx.data_ptr(),
                      wgt.data_ptr(), act.data_ptr(), out.data_ptr(),
                      tmp.data_ptr(), K, M, P, D, S, _MODE_CODE[combine],
                      int(wgt.ndim == 4), int(memory), iterations, scratch,
                      stream)
    return out


def step_on_device(src, idx, wgt, act=None, *, kind: str = "compute_bound",
                   iterations: int = 16, scratch: int = 2048,
                   combine: str = "gather",
                   steps_per_launch: int = 1,
                   radius: Optional[int] = None,
                   wrap: Optional[int] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step on the tensors' device: K3/K4 on a CUDA tensor (launch or
    raise); on a CPU tensor the plain version, after the same checks and a
    check that the tables reach no farther than a declared ``radius``
    (copied into ``out`` where given, which K3 writes directly)."""
    kw = dict(kind=kind, iterations=iterations, scratch=scratch, combine=combine)
    if src.device.type == "cuda":
        return taskbench_step(src, idx, wgt, act, steps_per_launch=steps_per_launch,
                              radius=radius, wrap=wrap, out=out, **kw)
    check_step_operands(src, idx, wgt, act, steps_per_launch=steps_per_launch,
                        radius=radius, wrap=wrap, **kw)
    if radius is not None and combine != "window":
        reach = table_reach(idx, wgt, combine)
        if reach > radius:
            raise ValueError(
                f"the {combine} table reaches {reach} rows, beyond the declared "
                f"radius {radius}")
    if steps_per_launch > 1:
        if out is not None:
            raise ValueError("out= is K3's (steps_per_launch = 1)")
        return taskbench_step_blocked_plain(src, idx, wgt, act, **kw)
    res = taskbench_step_plain(src, idx, wgt, wrap=wrap, **kw)
    if out is None:
        return res
    if tuple(out.shape) != tuple(res.shape) or out.dtype != res.dtype or not out.is_contiguous():
        raise ValueError(
            f"out must be a contiguous {tuple(res.shape)} {res.dtype} tensor, got "
            f"{tuple(out.shape)} {out.dtype}")
    return out.copy_(res)


def taskbench_step_interior(src, idx, wgt, act, *, depth: int,
                            **kw) -> torch.Tensor:
    """Interior phase of a pipelined blocked launch (one K4 launch on the
    card, the plain version on the CPU).

    The working buffer is the owned (K, B, payload) block alone, with
    per-row tables for it. After S depths the rows whose light cone never
    left the block survive, [depth, B - depth) with depth = S * r: those
    are returned, and they depend on no halo. Requires B > 2 * depth.
    """
    B = src.shape[1]
    if B <= 2 * depth:
        raise ValueError(
            f"interior phase needs block > 2*depth, got {B} <= {2 * depth}")
    return step_on_device(src, idx, wgt, act, **kw)[:, depth:B - depth]


def taskbench_step_boundary(left, right, idx, wgt, act, *, depth: int, **kw):
    """Boundary phase of a pipelined blocked launch (one K4 launch on the
    card, the plain version on the CPU).

    ``left``/``right`` are the (K, 3 * depth, payload) edge buffers, [halo |
    first 2 * depth owned rows] and [last 2 * depth owned rows | halo],
    stacked row-wise into one (K, 6 * depth) working buffer; neither side's
    surviving rows have a light cone that crosses the junction. idx/wgt
    follow that layout. Returns (left_out, right_out), each the middle
    (K, depth, payload) rows of its side: the block's new edge rows.
    """
    if left.shape != right.shape or left.shape[1] != 3 * depth:
        raise ValueError(
            f"boundary buffers must both be (K, {3 * depth}, payload), got "
            f"{tuple(left.shape)}/{tuple(right.shape)}")
    out = step_on_device(torch.cat([left, right], dim=1), idx, wgt, act, **kw)
    return out[:, depth:2 * depth], out[:, 4 * depth:5 * depth]
