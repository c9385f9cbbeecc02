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

K4's three forms. ``radius=r`` declares that the tables reach at most r
rows: row i's taps read rows in [i - r, i + r] only (the window's reach is
D - 1 - (D - 1) // 2, and must not exceed r). `blocked_form` picks the
form before the launch, each choice with its reason: with fixed tables,
a declared radius and the compute or empty body, the tiled form
(``taskbench_blocked_tiled``, rows tiled over CTAs by `plan_tiles`, each
tile carrying its own S * r halo); else, with the compute or empty body,
the resident form (``taskbench_blocked_resident``, one thread block
cluster per (member, column slice) holding every row of the slice in
shared memory for all S depths, cut by `plan_resident`), for any table:
no radius, time-varying tables, all_to_all's D = M; else (the memory
body, or a buffer no cluster holds) the persistent cooperative form
(``taskbench_blocked``). ``form=`` pins one (a timing or a comparison);
a pinned form that does not apply raises. All three give the same bits.
A table that reaches past its declared radius raises on the CPU; on the
card the tiled form reads NaN for such a tap.
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
    aligned,
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


#: The cluster sizes the resident form takes (16 is beyond the portable 8).
CLUSTER_SIZES = (1, 2, 4, 8, 16)


class ResidentPlan(NamedTuple):
    """How the resident K4 form cuts a (K, M, P) buffer: one cluster of
    ``cluster`` CTAs per (member, column slice of 1 << col_shift columns),
    CTA ``rank`` owning rows [rank * rows, (rank + 1) * rows) of the slice;
    with ``tables_smem`` each CTA keeps its rows' tables (every depth's) in
    shared memory, else it reads them from global memory."""

    cluster: int
    rows: int
    col_shift: int
    n_slices: int
    tables_smem: bool
    smem_bytes: int
    ctas: int


def resident_smem_bytes(rows: int, col_shift: int, D: int, tables: int,
                        uses_idx: bool, tables_smem: bool) -> int:
    """Shared memory of a resident CTA (the kernel's
    ``resident_smem_floats``): two buffers of its rows' slice and, with
    ``tables_smem``, its rows' weights and indices of ``tables`` tables."""
    return 4 * (2 * (rows << col_shift)
                + (tables * rows * D * (2 if uses_idx else 1) if tables_smem else 0))


def default_clusters(sms: int) -> tuple:
    """Clusters of each of `CLUSTER_SIZES` that ``sms`` SMs hold at once,
    one CTA an SM, where the card is not asked (`resident_clusters`)."""
    return tuple(sms // c for c in CLUSTER_SIZES)


def share_clusters(clusters: tuple, grids: int) -> tuple:
    """The clusters of one of ``grids`` launches that share the card."""
    return tuple(c // grids for c in clusters)


@lru_cache(maxsize=256)
def plan_resident(K: int, M: int, P: int, S: int, D: int, time_varying: bool,
                  uses_idx: bool, sms: int = 132, clusters: Optional[tuple] = None,
                  smem_limit: int = SMEM_LIMIT) -> Optional[ResidentPlan]:
    """The resident form's cut of a (K, M, P) buffer, or None where no
    cluster holds it.

    Over column slices of 2^j floats (at least MIN_SLICE, one 32-byte
    sector, unless the payload is narrower; at most the payload rounded up
    to a power of two) and clusters of C in `CLUSTER_SIZES` CTAs (each
    owning ceil(M / C) rows; ``clusters[i]`` clusters of size
    CLUSTER_SIZES[i] run at once, one CTA an SM (the H100 holds 7 clusters
    of 16, not 8: a denser cut's second wave, or two CTAs an SM, costs more
    than its narrower rows save on the all-gather plan's tables);
    `default_clusters(sms)` if not given), it takes the cut that
    minimises the modelled time: waves of co-resident clusters, times a
    CTA's work, the elements it owns over S depths (a depth counted as at
    least LATENCY_ELEMS), doubled where its rows' tables do not fit the
    shared-memory budget beside its two buffers and are read from global
    memory; ties go to fewer CTAs, then to smaller clusters. A cut whose
    two buffers alone exceed the budget is no cut.
    """
    if min(K, M, P, S, D) < 1:
        return None
    caps = default_clusters(sms) if clusters is None else clusters
    tables = S if time_varying else 1
    top = max(0, (P - 1).bit_length())
    low = min(top, (MIN_SLICE - 1).bit_length())
    best, best_key = None, None
    for sh in range(low, top + 1):
        n_slices = -(-P // (1 << sh))
        for C, cap in zip(CLUSTER_SIZES, caps):
            if cap < 1:
                continue
            rows = -(-M // C)
            if resident_smem_bytes(rows, sh, D, tables, uses_idx, False) > smem_limit:
                continue
            smem = resident_smem_bytes(rows, sh, D, tables, uses_idx, True)
            in_smem = smem <= smem_limit
            if not in_smem:
                smem = resident_smem_bytes(rows, sh, D, tables, uses_idx, False)
            n_clusters = K * n_slices
            work = S * max(rows << sh, LATENCY_ELEMS) * (1 if in_smem else 2)
            ctas = n_clusters * C
            key = (-(-n_clusters // cap) * work, ctas, C)
            if best_key is None or key < best_key:
                best_key = key
                best = ResidentPlan(C, rows, sh, n_slices, in_smem, smem, ctas)
    return best


def resident_spans(plan: ResidentPlan, M: int):
    """Each CTA rank's owned rows [r0, r1) of a cluster, as the kernel
    computes them (a trailing rank may own none)."""
    return [(min(M, r * plan.rows), min(M, (r + 1) * plan.rows))
            for r in range(plan.cluster)]


@lru_cache(maxsize=None)
def resident_clusters(index: int) -> tuple:
    """Clusters of each of `CLUSTER_SIZES` the resident form holds at once
    on card ``index``, one CTA an SM (asked of the card once)."""
    with torch.cuda.device(index):
        caps = tuple(_build.query("taskbench_blocked_resident_clusters", c)
                     for c in CLUSTER_SIZES)
    if min(caps) < 0:
        raise RuntimeError(f"CUDA occupancy query for K4's resident form failed: {caps}")
    return caps


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
                   out: Optional[torch.Tensor] = None,
                   form: Optional[str] = None,
                   grids: int = 1) -> torch.Tensor:
    """K3 (one timestep) or K4 (``steps_per_launch > 1``) on the card.

    Checks the operands as the reference does, then launches
    ``csrc/taskbench_step.cu`` (with ``wrap``, on the un-extended state, see
    the module docstring) and returns (K, W, payload), written into ``out``
    where given (a contiguous (K, W, payload) float32 tensor on the card,
    e.g. the owned rows of a halo-extended buffer), or
    ``csrc/taskbench_blocked.cu`` (its tiled form when ``radius`` declares
    the tables' reach and the form applies, see the module docstring) and
    returns (K, M, payload). K4's form is `blocked_form`'s, planned for
    1/``grids`` of the card (``grids`` K4 launches run at once on it, the
    all-gather plan's shards), or the one ``form`` pins. Raises on tensors
    that are not on the card, not float32 (int32 idx), or not on one
    device, and on a pinned form that does not apply.
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
                               memory, body_iters, scratch, radius, form, grids)
    _check_k4_options(form, grids, steps_per_launch)
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


#: K4's forms, fastest first, and the C entry (launch counter) of each.
K4_FORMS = ("tiled", "resident", "cooperative")
K4_ENTRIES = {"tiled": "taskbench_blocked_tiled",
              "resident": "taskbench_blocked_resident",
              "cooperative": "taskbench_blocked"}


def why_not_tiled(wgt_ndim: int, memory: bool,
                  radius: Optional[int]) -> Optional[str]:
    """Why a K4 launch cannot take the tiled form whatever its size (each
    rule that binds, joined), or None when the tiled form may apply."""
    why = []
    if memory:
        why.append("the memory body runs only in K4's cooperative form")
    if radius is None:
        why.append("the launch declares no radius (its tables may reach any row)")
    if wgt_ndim != 3:
        why.append("time-varying (K, S, M, D) tables have no tiled form")
    return "; ".join(why) or None


def why_not_resident(memory: bool) -> Optional[str]:
    """Why a K4 launch cannot take the resident form whatever its size, or
    None when it may apply: the memory body's sweep mixes a row's columns
    and is bound by shared memory, which a cluster of at most 16 SMs would
    starve."""
    if memory:
        return "the memory body runs only in K4's cooperative form"
    return None


class BlockedForm(NamedTuple):
    """K4's form for one launch: ``form`` in `K4_FORMS`, its cut (a
    `TilePlan`, a `ResidentPlan`, or None for the cooperative form), and
    why each faster form does not apply ("" for the tiled form)."""

    form: str
    plan: object
    reason: str

    @property
    def entry(self) -> str:
        return K4_ENTRIES[self.form]


def blocked_form(src_shape, wgt_shape, S: int, combine: str, memory: bool,
                 radius: Optional[int], sms: int = 132,
                 clusters: Optional[tuple] = None,
                 form: Optional[str] = None) -> BlockedForm:
    """K4's form rule: the tiled form where it applies (`blocked_plan`);
    else the resident form where `plan_resident` gives a cut; else the
    persistent cooperative form. The reason names the rule that binds for
    each form passed over. ``form`` pins one; a pinned form that does not
    apply raises ValueError with that reason."""
    if form is not None and form not in K4_FORMS:
        raise ValueError(f"unknown K4 form {form!r}; known {K4_FORMS}")
    K, M, P = src_shape
    D = wgt_shape[-1]
    time_varying = len(wgt_shape) == 4
    why = []
    tiled_why = why_not_tiled(len(wgt_shape), memory, radius)
    if tiled_why is None:
        plan = blocked_plan(src_shape, wgt_shape, S, combine, memory, radius, sms)
        if plan is None:
            tiled_why = f"no tile fits {SMEM_LIMIT} bytes of shared memory"
        elif form in (None, "tiled"):
            return BlockedForm("tiled", plan, "")
        else:
            tiled_why = f"form={form!r} pinned"
    if form == "tiled":
        raise ValueError(f"K4's tiled form does not apply: {tiled_why}")
    why.append(f"not tiled: {tiled_why}")
    resident_why = why_not_resident(memory)
    if resident_why is None:
        plan = plan_resident(K, M, P, S, D, time_varying, combine != "window", sms,
                             clusters)
        if plan is None:
            resident_why = (f"no cluster of up to {CLUSTER_SIZES[-1]} CTAs holds the "
                            f"{M}-row buffer's two copies in {SMEM_LIMIT} bytes of "
                            f"shared memory a CTA")
        elif form in (None, "resident"):
            return BlockedForm("resident", plan, "; ".join(why))
        else:
            resident_why = f"form={form!r} pinned"
    if form == "resident":
        raise ValueError(f"K4's resident form does not apply: {resident_why}")
    why.append(f"not resident: {resident_why}")
    return BlockedForm("cooperative", None, "; ".join(why))


def blocked_plan(src_shape, wgt_shape, S: int, combine: str, memory: bool,
                 radius: Optional[int], sms: int = 132) -> Optional[TilePlan]:
    """The tiled form's plan when a radius is declared, the (K, M, D)
    tables are fixed, the body is not the memory sweep and a tile fits in
    shared memory; None where the tiled form does not apply."""
    if why_not_tiled(len(wgt_shape), memory, radius):
        return None
    K, M, P = src_shape
    D = wgt_shape[-1]
    reach = window_reach(D) if combine == "window" else radius
    return plan_tiles(K, M, P, S, reach, D, combine != "window", sms)


def _launch_blocked(src, idx, wgt, act, combine, memory, iterations, scratch,
                    radius=None, form=None, grids=1):
    """One K4 launch on checked operands; idx is None for window. The form
    is `blocked_form`'s for 1/grids of the card's SMs and clusters (grids
    K4 launches at once on the card)."""
    tensors = (src, wgt, act) if idx is None else (src, wgt, act, idx)
    _require_card(tensors, (torch.float32,) * 3 + (torch.int32,))
    K, M, P = src.shape
    S, D = act.shape[1], wgt.shape[-1]
    src, wgt, act = src.contiguous(), wgt.contiguous(), act.contiguous()
    idx = None if idx is None else idx.contiguous()
    out = torch.empty_like(src)
    if not out.numel():
        return out
    dev = src.device.index or 0
    chosen = blocked_form(src.shape, wgt.shape, S, combine, memory, radius,
                          max(1, sm_count(dev) // grids),
                          share_clusters(resident_clusters(dev), grids), form)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    idx_ptr = None if idx is None else idx.data_ptr()
    with torch.cuda.device(src.device):
        if chosen.form != "cooperative" and K > 65535:
            raise ValueError(f"K = {K} members exceed the kernel's grid (65535)")
        if chosen.form == "tiled":
            plan = chosen.plan
            _build.launch("taskbench_blocked_tiled", src.data_ptr(), idx_ptr,
                          wgt.data_ptr(), act.data_ptr(), out.data_ptr(),
                          K, M, P, D, S, _MODE_CODE[combine],
                          window_reach(D) if combine == "window" else radius,
                          iterations, plan.tile_rows, plan.col_shift, stream,
                          ctas=plan.ctas)
        elif chosen.form == "resident":
            plan = chosen.plan
            vec = plan.col_shift >= 2 and P % 4 == 0 and aligned(src, out)
            _build.launch("taskbench_blocked_resident", src.data_ptr(), idx_ptr,
                          wgt.data_ptr(), act.data_ptr(), out.data_ptr(),
                          K, M, P, D, S, _MODE_CODE[combine], int(wgt.ndim == 4),
                          iterations, plan.rows, plan.col_shift, plan.cluster,
                          int(plan.tables_smem), int(vec), stream, ctas=plan.ctas)
        else:
            tmp = torch.empty_like(src)  # the depths' ping-pong partner of out
            _build.launch("taskbench_blocked", src.data_ptr(), idx_ptr,
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
                   out: Optional[torch.Tensor] = None,
                   form: Optional[str] = None,
                   grids: int = 1) -> torch.Tensor:
    """The step on the tensors' device: K3/K4 on a CUDA tensor (launch or
    raise); on a CPU tensor the plain version, after the same checks, a
    check that the tables reach no farther than a declared ``radius`` and
    that a pinned K4 ``form`` applies (copied into ``out`` where given,
    which K3 writes directly)."""
    kw = dict(kind=kind, iterations=iterations, scratch=scratch, combine=combine)
    if src.device.type == "cuda":
        return taskbench_step(src, idx, wgt, act, steps_per_launch=steps_per_launch,
                              radius=radius, wrap=wrap, out=out, form=form,
                              grids=grids, **kw)
    check_step_operands(src, idx, wgt, act, steps_per_launch=steps_per_launch,
                        radius=radius, wrap=wrap, **kw)
    _check_k4_options(form, grids, steps_per_launch)
    if form is not None:  # raises where the pinned form does not apply
        blocked_form(src.shape, wgt.shape, steps_per_launch, combine,
                     kind == "memory_bound" and iterations > 0, radius, form=form)
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


def _check_k4_options(form: Optional[str], grids: int, steps_per_launch: int) -> None:
    if form is not None and steps_per_launch <= 1:
        raise ValueError("form is K4's (steps_per_launch > 1)")
    if form is not None and form not in K4_FORMS:
        raise ValueError(f"unknown K4 form {form!r}; known {K4_FORMS}")
    if grids < 1:
        raise ValueError(f"grids must be >= 1, got {grids}")


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
