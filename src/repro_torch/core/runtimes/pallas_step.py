"""`pallas_step` runtime — fused megakernel launches, temporally blockable,
on one GPU and over D row shards.

Counterpart of ``repro.core.runtimes.pallas_step``. Every
timestep of every plan is one launch of the single-step megakernel K3
(``kernels/taskbench_step.py``: gather the dependency rows of the previous
state, take their masked mean, run the grain body, in one kernel), or S
timesteps are one launch of the blocked megakernel K4. Each schedule is
written as an eager loop (`_build_eager`); on the card ``Runtime.build``
captures the whole run as one CUDA graph, as the reference jits it.

The pattern -> plan dispatch (`plan_for`, `_schedule_for_graph`, the
reference's, resolved once and shared by the build methods and
`dispatches_per_run`):

  halo       halo-expressible period-1 patterns. One device makes the
             whole width one block, and the reference's ring halo exchange
             a wrap of the state onto itself: K3 folds it into its row
             index (``wrap=H``, the extended source's row p is state row
             (p - H) mod W, exact at W <= 2H), so a timestep is one launch.
             It combines through host-built (idx, wgt) operands, weights
             pre-normalized to 1 / live count and zero-dependency rows
             self-padded.
  stride     butterfly patterns (fft, tree) at W > 1. Step t pairs p with
             p XOR 2^k, the period slot's stride, chosen on the host from
             t (it takes the place of the reference's ``lax.switch``; the
             graph records the unrolled sequence). On one device every
             stride is in-block: the partner rows come from an XOR layout
             shuffle (`_xor_swap`: a reshape and a flip of the pair axis),
             and K3 combines the stacked [x | partner] halves with its
             ``pair`` mode, (a + b) * 0.5, bit for bit the ``fused``
             oracle's mean (gather/onehot over `_stride_slot_tables` stay
             selectable as ablations). The t = 0 launch is ``pair`` over
             [x | x]. Per step by construction: an explicit depth S > 1
             re-routes to the all-gather plan when the width is under the
             cap, and stays per step over it.
  allgather  global patterns (spread, all_to_all), W = 1 butterfly and
             blocked butterfly, for widths <= ``gather_width_cap``. On one
             device the gathered buffer is the state itself (the
             reference's ``gather_global`` is the identity), and the
             graph's own dependency arrays are the tables, in global rows:
             a period stack (`_global_slot_operands`) or spread's base
             table rotated by t - 1 (`_spread_base_operands`). Per step
             (S = 1): one K3 launch on timestep t's tables. all_to_all
             under ``psum_mean`` (default on) combines through the row
             mean instead, ``state.sum(rows) / W`` (the reference's
             ``_halo.global_mean``, XLA glue there too), then one K3
             launch that gathers that one mean row for every output row
             with weight 1 (the reference's self tables over the
             broadcast mean, without materializing it): within float32
             reduction tolerance of the gathered combine, not bit for bit.
             Blocked (S > 1): after the t = 0 K3 launch, ceil((T-1)/S)
             launches of K4 on the full W-row state with TIME-VARYING
             (1, S, W, D) tables (period-1 patterns keep one static (1, W,
             D) pair); every row advances exactly (no valid-span shrink),
             the masked tail comes from `_act_schedule`, and no radius is
             declared, so K4 takes its resident form (one cluster a column
             slice holding the whole buffer; the memory body: the
             cooperative form).

Every table a run reads is built on the host once per build and moved to
the card before the run; per timestep the loop only picks a slice (a view)
of a static tensor, so a captured graph equals its eager loop.

Temporal blocking of the halo plan (``steps_per_launch=S > 1``): after the
t = 0 body-only K3 launch, the loop makes ceil((T-1)/S) launches of K4,
each S timesteps on a buffer wrapped S*H rows deep per side, whose valid
span shrinks by H rows per side per depth; the owned rows are sliced out
after each launch. Every K4 launch declares ``radius=H``, the tables'
reach, so the fixed-table launches take K4's tiled form. Per-row weight
tables (and, for gather / onehot, signed offsets rebased onto the buffer)
are wrapped once per run. S is clamped to T - 1, as the reference clamps
an explicit depth (`kernels/schedule.py`'s `_resolve_depth`, every plan's
one option parser).

Pipelined schedule of the halo plan (``pipeline=True``, the default, when
the block keeps an interior: W > 2*S*H): each blocked launch splits into a
boundary phase (both 3*S*H-row edge buffers stacked into one K4 launch)
and an interior phase (the owned block, one K4 launch). On one device the
next launch's edge exchange is a self-wrap of the boundary outputs, so
what can overlap is the two phases themselves: the interior runs on a
second CUDA stream, ordered by events; the capture forks that stream from
the capturing one and joins it back at every launch, so the graph holds
the two phases as parallel branches. ``pipeline=False`` is the serial
ablation; both give the same bits.

Row shards (``devices=``, D > 1; the reference's per-device programs under
``shard_map``): the halo plan runs over D shards of B = W / D rows, each its
own tensor computing on its own stream (`_halo.ShardMesh`); a shard's
operand tables are its rows of the global tables, at its first global row
p0 = d*B (dom's asymmetry, random_nearest's keep set and the non-periodic
ends are global facts), the blocked ones extended by S*H rows a side once
per build. S = 1: per timestep the ring exchange of H rows
(``_halo.exchange_halos``, "ppermute", the reference's ``_extend_state``),
the (K, H + B + H) extended buffer, and one K3 launch on it unfolded (the
wrap is the one-device form). S > 1 serial: per launch the deep exchange
(multi-hop past the block), the extended buffer, one K4 launch. Pipelined
(B > 2*S*H): the boundary launch, the next launch's edge exchange started
on its outputs (``_halo.exchange_edges_start`` over ``halo_impl``), the
interior launch, which runs under the transfer; the next launch joins it,
and the prologue exchange feeds the first. The halo plan is written once
over a ring of shards, as a (t0, launch) pair for K stacked members
(`_halo_shard_steps`; a graph is K = 1), which the stacked and tuple
ensembles and the launch plans reuse; the one-device schedules keep the
folded wrap (K3's ``wrap=H``) and share the phase slicing and the
pipelined phases with it. One device keeps its own blocked schedules: on a
ring of one shard the pair gives the same bits and K4 launches in slower
steps (more graph nodes, and a pipelined interior that waits for the
boundary on one stream; ``benchmarks/torch_pipeline_trace.py --only
ring``). The stride and all-gather plans are written
once, as (t0, step) over a list of shard states (one device: a list of
one): the stride plan
takes an in-block partner (s < B) from the shard's own block and a block
partner (s >= B) from shard d XOR s/B through ``_halo.exchange_stride``
over ``halo_impl``, then one K3 launch a shard; the all-gather plan gathers
the W-row state for every shard (``_halo.gather_global`` over
``gather_impl``) and launches K3 on it with the shard's rows of the global
tables (cut once per build; global rows, so nothing is rebased), or,
blocked, K4 on all W rows, each shard keeping its own B (every shard does
all W rows' work, as the reference's); all_to_all's row mean sums the
shards' partial sums (``_halo.global_mean``). Every transfer moves exact
row copies, so a sharded run equals the one-device run bit for bit (the
row mean within f32 reduction tolerance). ``dispatches_per_run`` stays the
reference's per-shard count (a run launches D times as many).

Ensembles over D shards. A tuple ensemble runs each member's own plan over
the D shards (B_k = W_k / D): halo members through the pair at K = 1,
the others through their (t0, step). A stacked ensemble runs on the 2D
(row, member) mesh (``launch/mesh.py``) when ``member_shards`` = Dk > 1:
the D devices reshape to (Dr, Dk), row axis first, member slice j (K/Dk
members) runs on ring j of Dr shards at B = W / Dr, its exchanges inside
that ring, each ring's shards on streams of their own; member k's rows live
on its ring's devices only (`_member_devices`). The run and the stacked
launch plan build on one `_MemberSlices` per mesh. Every row a run moves is an
exact copy, so a member-sharded run equals the replicated run on Dr (and on
D) devices bit for bit. The pipeline gate of a member slice reads its block
W / Dr, and ``ensemble_dispatches_per_run`` counts those launches (the
reference's count reads W / D there, though its run pipelines too).

Ensembles (``build_ensemble``; the reference's ensemble section). An
ensemble is *stacked* when its members share (width, payload) and one
kernel and all take the halo plan (`stacking_verdict` names the failed
requirement otherwise): all K members then share each launch, K3 on the
(K, W, payload) state with ``wrap=H`` for H the largest radius (each
member's window operands built at that H; gather/onehot tables padded with
index 0 at weight 0, a valid row under the wrap), or K4 with ``radius=H``
and the (K, S) act rows of `_act_schedule` (member k runs depth d while its
own horizon lasts), serial or pipelined as for one graph; at S = 1 a member
past its horizon keeps its state through a ``torch.where`` on a slice of a
static (T-1, K) table. Any other ensemble is a *tuple*: each member launches
its own plan's kernel every step (halo members through `_operands`, stride
and all-gather members through `_plan_shard_fns`), frozen members included,
whose output the host then drops; when every member is on the halo plan,
the shared cadence blocks too, each member serial or pipelined by its own
gate. A member off the halo plan pins the cadence to one step a launch.
``build_ensemble_launches`` gives the host-steppable form
(`EnsembleLaunchPlan`): the stacked one captures its launch once on the
card and replays it per launch, with the act row staged into the graph (at
D > 1 the launch over every ring of the (row, member) mesh, on static shard
carries); the stepwise one issues the tuple's member fns eagerly.

Depth under ``steps_per_launch="auto"`` (or 0, "0"; `kernels/schedule.py`
and `kernels/probes.py`, the reference's policy): the halo plan takes the
deepest of (16, 8, 4, 2, 1), at most T - 1, whose K4 launch takes the tiled
form (the card's fit rule, in place of the reference's VMEM budget), and
pipelines it only where the cost model says the interior covers the
exchange (`_pipeline_active`); the all-gather plan's launches declare no
radius, so they never take the tiled form and "auto" resolves them to one
step a launch, and a butterfly keeps the stride plan unless a measured
model ranks the blocked all-gather plan ahead (`gathered_beats_strides`).
An ensemble takes its most conservative member's depth. Each "auto"
resolution carries its reason (`_ResolvedPlan.reason`). The model decides
which schedule runs, never what it computes: an "auto" run equals the
explicit run of the depth and schedule it resolved to, bit for bit.

Options: ``combine`` = "window" (default: the halo plan's shifted-row
sums; ``pair`` on the stride plan, ``gather`` on the all-gather plan) or
"gather" / "onehot" (the ablations, honoured on every plan);
``steps_per_launch`` = 1, an int > 1 or "auto" (0, "0"); ``cost_model`` =
the `probes.CostModel` "auto" is priced by (a CostModel, its ``to_dict()``,
or a cache-file path; default `probes.default_cost_model`: env > cache >
analytic); ``pipeline`` = True or False; ``gather_width_cap`` = the widest
state the all-gather plan takes (default 512,
`schedule.DEFAULT_GATHER_WIDTH_CAP`); ``psum_mean`` = True or False
(all_to_all's row-mean combine); ``halo_impl`` = "xla" (default) or
"ppermute", the transport of the pipelined edge exchange and of the stride
plan's block exchange at D > 1 (the same bits; nothing to exchange on one
device); ``gather_impl`` = "auto" (default: a non-default ``halo_impl``
that names a gather transport, else `schedule.choose_gather_impl` under the
cost model) or a ``_halo.GATHER_IMPLS`` name ("xla", "ppermute",
"chunked"), the all-gather plan's transport at D > 1 (the same bits);
``member_shards`` = 1 (default), an int Dk dividing K and D, or "auto" (0,
"0": `schedule.choose_member_shards` under the cost model), the stacked
ensembles' row x member mesh at D > 1 (the same bits); ``trace`` and
``trace_probe_reps``, as on every backend. The reference's ``block_rows``
and ``unroll`` (TPU tilings) are unknown options here.

Tracing (``trace_once``; the tracing section below): the traced twin of
every plan path at D = 1 and over row shards, built from the eager pieces.
Each step or launch that moves rows is a `_Phased` move then compute, and
the production loops call the composition, so the twin times the same
operations apart; the pipelined launch stays one span, its phases priced
by probes. The schedule's ``schedule.resolve`` record comes first, and an
ensemble off the stacked path records why (`_record_stacking_degradation`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import patterns as _patterns
from repro_torch.core.graph import GraphEnsemble, TaskGraph
from repro_torch.core.runtimes import _halo
from repro_torch.core.runtimes._capture import GraphRun
from repro_torch.core.runtimes.base import EnsembleLaunchPlan, Runtime, register
from repro_torch.kernels import _build
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import probes as _probes
from repro_torch.kernels import schedule as _schedule
from repro_torch.kernels.bodies import SMEM_LIMIT
from repro_torch.kernels.launch_plan import sm_count
from repro_torch.kernels.taskbench_step import (
    WEIGHT_ACCUM_DTYPE,
    WEIGHT_DTYPE,
    blocked_form,
    blocked_plan,
    default_clusters,
    finalize_weights,
    halo_rows,
    prepare_step_operands,
    resident_clusters,
    share_clusters,
    why_not_resident,
    why_not_tiled,
    wrap_rows,
)
from repro_torch.launch.mesh import RowMemberMesh, make_row_member_mesh

#: Execution-plan kinds the pattern -> plan dispatch resolves to.
PLAN_HALO = "halo"
PLAN_STRIDE = "stride"
PLAN_ALLGATHER = "allgather"
PLAN_KINDS = (PLAN_HALO, PLAN_STRIDE, PLAN_ALLGATHER)
COMBINE_OPTIONS = ("window", "gather", "onehot")


def _ext_dep_operands(
    graph: TaskGraph, block: int, halo: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(W, D) idx/wgt into the halo-extended local block, for one timestep.

    Local row i of a block starting at global row p0 gathers from an
    extended buffer ext = [p0-halo .. p0+B-1+halo] (mod W), so dependency q
    of global row p maps to extended position (p mod B) + halo + o where o
    is q's signed window offset from p. Halo patterns have period 1, so ONE
    slice serves every timestep t >= 1.
    """
    r = _patterns.halo_radius(graph)
    if r < 0:
        raise ValueError(f"{graph.pattern} is not halo-expressible")
    if graph.period != 1:
        raise ValueError(f"halo pattern {graph.pattern} must have period 1")
    W = graph.width

    def to_ext(p: int, q: int) -> int:
        for o in range(-r, r + 1):
            if (p + o) % W == q:
                return p % block + halo + o
        raise ValueError(f"dep {q} of point {p} outside halo radius {r}")

    ext_lists: List[List[int]] = [
        [to_ext(p, q) for q in graph.dependencies(1, p)] for p in range(W)
    ]
    selfs = [p % block + halo for p in range(W)]
    return prepare_step_operands(ext_lists, W, selfs)


def _rel_dep_operands(graph: TaskGraph) -> Tuple[np.ndarray, np.ndarray]:
    """(W, D) SIGNED-offset operands for the temporal-blocked gather modes.

    Row p's dependency q is stored as its window offset o (q == (p+o) mod
    W), not an absolute buffer position: offsets are a property of the
    global row alone, so the tables wrap like state and convert to absolute
    working-buffer rows with one ``+ arange(M)`` (`_rebase_rows`). Zero-dep
    rows self-pad at offset 0.
    """
    r = _patterns.halo_radius(graph)
    if r < 0 or graph.period != 1:
        raise ValueError(f"{graph.pattern} is not halo-expressible")
    W = graph.width
    rel_lists: List[List[int]] = []
    for p in range(W):
        offs: List[int] = []
        for q in graph.dependencies(1, p):
            for o in range(-r, r + 1):
                if (p + o) % W == q:
                    offs.append(o)
                    break
            else:
                raise ValueError(f"dep {q} of point {p} outside halo {r}")
        rel_lists.append(offs)
    return prepare_step_operands(rel_lists, W, [0] * W)


def _self_operands(width: int, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """(W, 1) identity operands (t=0: body only, src = raw local block)."""
    selfs = [p % block for p in range(width)]
    return prepare_step_operands([[] for _ in range(width)], width, selfs)


def _window_operands(
    graph: TaskGraph, halo: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(W, 2*halo+1) per-offset combine weights for the window kernel mode.

    Column halo + o carries the (pre-normalized) weight of the dependency
    at window offset o. Edge clipping (stencil_1d, dom), the per-row keep
    set (random_nearest), duplicate window wraps (nearest with W <= 2r)
    and the zero-dep self-keep rule are all encoded in the weights; idx is
    unused in this mode (returned as a (W, 1) column of zeros).
    """
    r = _patterns.halo_radius(graph)
    if r < 0 or graph.period != 1:
        raise ValueError(f"{graph.pattern} is not window-expressible")
    W = graph.width
    D = 2 * halo + 1
    idx = np.zeros((W, 1), dtype=np.int32)
    wgt = np.zeros((W, D), dtype=WEIGHT_ACCUM_DTYPE)
    for p in range(W):
        deps = graph.dependencies(1, p)
        if not deps:
            wgt[p, halo] = 1.0  # zero deps: keep own state (self weight 1)
            continue
        share = 1.0 / len(deps)
        for q in deps:
            for o in range(-r, r + 1):
                if (p + o) % W == q:
                    wgt[p, halo + o] += share
                    break
            else:
                raise ValueError(f"dep {q} of point {p} outside halo {r}")
    return idx, finalize_weights(wgt)


def _stride_slot_tables(
    block: int, stride: int
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(B, 2) idx/wgt tables for one butterfly period slot (the
    gather/onehot ablations of the stride plan; the default pair combine
    needs no tables).

    A power-of-two width (graph-validated) gives every point exactly the
    two dependencies {p, p XOR stride} at weight 1/2, so 0.5*a + 0.5*b is
    bit for bit the fused oracle's (a + b) / 2 under every combine.
    In-block strides (stride < block) address the local rows; block
    strides address a [local | partner] working buffer (partner block at
    rows [B, 2B)), which only a run over row shards has. Returns (idx, wgt,
    off_block)."""
    i = np.arange(block, dtype=np.int32)
    off_block = stride >= block
    partner = (block + i) if off_block else (i ^ stride)
    idx = np.stack([i, partner], axis=1).astype(np.int32)
    wgt = np.full((block, 2), 0.5, dtype=WEIGHT_ACCUM_DTYPE)
    return idx, finalize_weights(wgt), off_block


def _global_slot_operands(graph: TaskGraph) -> Tuple[np.ndarray, np.ndarray]:
    """(period, W, D) idx + pre-normalized wgt tables in GLOBAL row ids.

    The all-gather plan's working buffer is the full state in global
    order, so the graph's own dependency arrays ARE the gather tables.
    Weights follow the shared precision policy (mask / live count
    accumulated wide, rounded once); zero-dep rows self-gather at weight 1
    (the keep-own-state rule).
    """
    idx, mask = graph.dependency_arrays()
    acc = np.asarray(mask, WEIGHT_ACCUM_DTYPE)
    live = acc.sum(-1, keepdims=True)
    wgt = acc / np.maximum(live, 1.0)
    zero = live[..., 0] == 0  # (period, W)
    if zero.any():
        P, W, _ = idx.shape
        idx = idx.copy()
        selfs = np.broadcast_to(np.arange(W, dtype=np.int32), (P, W))
        idx[..., 0] = np.where(zero, selfs, idx[..., 0])
        wgt[..., 0] = np.where(zero, 1.0, wgt[..., 0])
    return idx, finalize_weights(wgt)


def _spread_base_operands(graph: TaskGraph) -> Tuple[np.ndarray, np.ndarray]:
    """(W, D) t = 1 tables for spread; timestep t rotates idx by +(t-1) mod W.

    spread's dependence set {(p + i*stride + (t-1)) mod W} shifts rigidly
    with t, so one base table and a rotation replace the period-W stack
    `_global_slot_operands` would build. The live count is point- and
    time-invariant, so the weight table never rotates."""
    W = graph.width
    lists = [graph.dependencies(1, p) for p in range(W)]
    D = max(1, max(len(l) for l in lists))
    idx = np.zeros((W, D), dtype=np.int32)
    acc = np.zeros((W, D), dtype=WEIGHT_ACCUM_DTYPE)
    for p, deps in enumerate(lists):
        share = 1.0 / len(deps)
        for j, q in enumerate(deps):
            idx[p, j] = q
            acc[p, j] = share
    return idx, finalize_weights(acc)


def _self_tables(block: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 1) identity tables for the t = 0 body-only launch."""
    return (torch.arange(block, dtype=torch.int32, device=device)[:, None],
            torch.ones((block, 1), dtype=torch.float32, device=device))


def _xor_swap(x: torch.Tensor, stride: int, row_axis: int = 0) -> torch.Tensor:
    """Rows (along ``row_axis``) permuted by i -> i XOR stride (a power of
    two dividing the row count): reshape to (pairs, 2, stride, ...) and
    flip the pair axis, a layout shuffle with no index table."""
    B = x.shape[row_axis]
    g = x.reshape(*x.shape[:row_axis], B // (2 * stride), 2, stride,
                  *x.shape[row_axis + 1:])
    return g.flip(row_axis + 1).reshape(x.shape)


def _stack_tables(tables_at: Callable[[int], Tuple[np.ndarray, np.ndarray]],
                  key_of: Callable[[int], int], groups: Sequence[Sequence[int]],
                  device) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """Host-built per-launch tables, deduplicated and moved to ``device``
    once: each group of timesteps (one launch's, in depth order) gets the
    (n, W, D) stack of ``tables_at(t)`` for its timesteps. Groups whose
    first timesteps share a ``key_of`` share tables (the pattern's tables
    depend on t through that key alone). Returns (idx, wgt), each (keys,
    n, W, D), and each group's row in them."""
    rows: dict = {}
    order: List[int] = []
    stacks_i, stacks_w = [], []
    for ts in groups:
        key = key_of(ts[0])
        if key not in rows:
            rows[key] = len(stacks_i)
            pairs = [tables_at(t) for t in ts]
            stacks_i.append(np.stack([i for i, _ in pairs]))
            stacks_w.append(np.stack([w for _, w in pairs]))
        order.append(rows[key])
    return (torch.from_numpy(np.stack(stacks_i)).to(device),
            torch.from_numpy(np.stack(stacks_w)).to(device), order)


def _extend_rows(width: int, halo: int) -> np.ndarray:
    """Global rows of the halo-extended source (`halo_rows`) as an array."""
    return halo_rows(width, halo).numpy()


def _extend_state(s: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    """Halo-extend a stacked (K, W, payload) state; identity at halo 0."""
    return s if rows is None else s.index_select(1, rows)


def _rebase_rows(rel: torch.Tensor, *, row_axis: int = 0) -> torch.Tensor:
    """Signed window offsets -> absolute rows of THIS working buffer
    (``+ arange(M)``, clipped; the clip only ever binds on edge-garbage
    rows, which are never consumed by valid rows)."""
    m = rel.shape[row_axis]
    shape = [1] * rel.ndim
    shape[row_axis] = m
    rows = torch.arange(m, dtype=torch.int32, device=rel.device).reshape(shape)
    return (rel + rows).clamp(0, m - 1)


def _extend_tables(idx: torch.Tensor, wgt: torch.Tensor, depth: int,
                   mode: str, *, row_axis: int = 0):
    """Wrap the per-row operand tables ONCE for a serial blocked run.

    Weights (per global row, depth-invariant) extend exactly like state.
    Gather/onehot offset tables additionally rebase from signed offsets to
    absolute working-buffer rows (`_rebase_rows`). Window mode returns idx
    untouched (the kernel reads no idx).
    """
    wext = wrap_rows(wgt, depth, row_axis)
    if mode == "window":
        return idx, wext
    return _rebase_rows(wrap_rows(idx, depth, row_axis), row_axis=row_axis), wext


class _PhaseTables(NamedTuple):
    """Per-phase operand tables for one pipelined run (leading K axis).

    ``i_int``/``w_int`` cover the interior working buffer (the owned B
    rows); ``i_bnd``/``w_bnd`` cover the stacked (K, 6*depth) boundary
    working buffer, rows [left buffer..., right buffer...], matching
    ``taskbench_step_boundary``'s layout.
    """

    i_int: torch.Tensor
    w_int: torch.Tensor
    i_bnd: torch.Tensor
    w_bnd: torch.Tensor


def _phase_tables(idx: torch.Tensor, wgt: torch.Tensor, depth: int,
                  mode: str) -> _PhaseTables:
    """One device: the tables wrapped once (`wrap_rows`, depth rows a side)
    and sliced per pipeline phase (`_phase_slices`)."""
    return _phase_slices(None if mode == "window" else wrap_rows(idx, depth),
                         wrap_rows(wgt, depth), depth, mode)


def _phase_slices(ext_idx: Optional[torch.Tensor], ext_wgt: torch.Tensor, depth: int,
                  mode: str) -> _PhaseTables:
    """Halo-extended tables sliced per pipeline phase.

    All tensors carry a leading K axis; rows live on axis 1. ``ext_wgt``
    (and, for gather / onehot, ``ext_idx``, signed offsets; None in window
    mode) holds B + 2*depth rows, the block's rows [-depth, B + depth): on
    one device the tables wrapped (`_phase_tables`), on a shard its rows of
    the global tables (`_shard_tables`). The interior buffer is
    ext[depth : depth + B], the left boundary buffer ext[:3*depth], the
    right one ext[B - depth:]. Gather/onehot offsets are rebased per buffer
    AFTER slicing: each phase's idx addresses its own working buffer.
    """
    K, B = ext_wgt.shape[0], ext_wgt.shape[1] - 2 * depth

    def phases(ext):
        interior = ext[:, depth:depth + B]
        boundary = torch.cat([ext[:, :3 * depth], ext[:, B - depth:B + 2 * depth]],
                             dim=1)
        return interior.contiguous(), boundary

    w_int, w_bnd = phases(ext_wgt)
    if mode == "window":  # the kernel reads no idx
        i_int = torch.zeros((K, 1, 1), dtype=torch.int32, device=ext_wgt.device)
        i_bnd = i_int
    else:
        rel_int, rel_bnd = phases(ext_idx)
        i_int = _rebase_rows(rel_int, row_axis=1)
        i_bnd = _rebase_rows(rel_bnd, row_axis=1)
    return _PhaseTables(i_int, w_int, i_bnd, w_bnd)


def _boundary_launch(s, hl, hr, a, ph: _PhaseTables, depth: int, kwb: dict):
    """A pipelined launch's boundary phase on stacked (K, B, payload) state:
    one K4 launch on both 3*depth-row edge buffers, each the halo received
    for this launch (``hl``/``hr``) and the block's first (last) 2*depth
    rows. Returns the (left, right) depth-row outputs, the rows the next
    launch's exchange sends."""
    B = s.shape[1]
    bl = torch.cat([hl, s[:, :2 * depth]], dim=1)
    br = torch.cat([s[:, B - 2 * depth:], hr], dim=1)
    return _kops.taskbench_boundary(bl, br, ph.i_bnd, ph.w_bnd, a, depth=depth, **kwb)


def _interior_launch(s, a, ph: _PhaseTables, depth: int, kwb: dict):
    """A pipelined launch's interior phase: one K4 launch on the owned
    block, which needs neither the halo nor the boundary phase."""
    return _kops.taskbench_interior(s, ph.i_int, ph.w_int, a, depth=depth, **kwb)


def _pipelined_launch(s, hl, hr, a, ph: _PhaseTables, depth: int, kwb: dict,
                      side: Optional["torch.cuda.Stream"] = None):
    """One software-pipelined blocked launch on one device: the boundary
    phase, then the interior phase. The next launch's exchange is a
    self-wrap: the left halo is the right boundary output and the right
    halo the left one. With ``side`` (a CUDA stream) the interior runs
    there, ordered after the state it reads and before the concatenation
    that reads it; without, both phases run in order.

    Returns (s_next, hl_next, hr_next).
    """
    if side is not None:
        main = torch.cuda.current_stream(s.device)
        side.wait_stream(main)
    bl_out, br_out = _boundary_launch(s, hl, hr, a, ph, depth, kwb)
    with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
        mid = _interior_launch(s, a, ph, depth, kwb)
    if side is not None:
        main.wait_stream(side)
        # the caching allocator must not hand these blocks to another
        # stream's work before the other stream is done with them
        s.record_stream(side)
        mid.record_stream(main)
    return torch.cat([bl_out, mid, br_out], dim=1), br_out, bl_out


def _prologue_exchange(state: torch.Tensor, depth: int):
    """The first blocked launch's halo (hl, hr) from the t = 0 state's edges:
    on one device the ring exchange wraps the state onto itself."""
    B = state.shape[1]
    return state[:, B - depth:], state[:, :depth]


def _act_schedule(
    member_steps: Sequence[int], lockstep_steps: int, s: int
) -> np.ndarray:
    """(L, K, S) per-depth activity masks for the blocked launch loop.

    Launch l's inner step d executes lockstep timestep t = 1 + l*S + d;
    member k is active iff t < T_k (its own horizon). The final launch of
    any run carries the masked tail ((T-1) mod S trailing zeros).
    """
    L = max(1, -(-(lockstep_steps - 1) // s)) if lockstep_steps > 1 else 0
    t = 1 + (np.arange(L)[:, None, None] * s + np.arange(s)[None, None, :])
    msteps = np.asarray(member_steps, np.int64)[None, :, None]
    return (t < msteps).astype(np.float32)


def _stack_operands(ops4):
    """Stack per-member (idx, wgt, idx0, wgt0) numpy operands on a leading K
    axis, padding every member's slot dim to the group max (idx 0 / weight
    0: a harmless gather of row 0 at weight zero)."""

    def stack(j):
        dmax = max(o[j].shape[1] for o in ops4)
        return np.stack([np.pad(o[j], ((0, 0), (0, dmax - o[j].shape[1])))
                         for o in ops4])

    return stack(0), stack(1), stack(2), stack(3)


def _memory_body(spec) -> bool:
    """Whether a launch of kernel ``spec`` runs the memory sweep (the body
    K4 runs only in its cooperative form)."""
    return spec.kind == "memory_bound" and spec.iterations > 0


def _time_varying(graph: TaskGraph) -> bool:
    """Whether the all-gather plan's blocked launch holds S per-depth tables
    (spread, period > 1) or one static pair."""
    return graph.pattern == "spread" or graph.period > 1


def _act_row(act_row) -> torch.Tensor:
    """A stacked launch's (K, S) act row as a float32 tensor: a host array
    converted on the host, a tensor (already on the card) as it is."""
    if torch.is_tensor(act_row):
        return act_row
    return torch.as_tensor(np.asarray(act_row, dtype=np.float32))


def _stacked(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Members' (B, payload) states stacked on a leading K axis (one member:
    a view)."""
    return torch.stack(tuple(xs)) if len(xs) > 1 else xs[0][None]


class _Phased(NamedTuple):
    """One step or launch as its two phases, which the traced twin times
    apart (`PallasStepRuntime._build_traced`): ``move(state, tracer=None,
    span=None)``, the transfer that brings the rows of other shards (or one
    device's deep wrap), which hands ``tracer`` and ``span`` to its
    transport (`_halo`); None where no rows move (the one-device wrap folded
    into K3, an in-block stride, the gather on one device, halo 0). Then
    ``compute(state, moved, item)``, the launches on what it moved. Called
    with (state, item), it is the step itself: the production loops call it
    so, and the traced twin calls the two phases in turn."""

    move: Optional[Callable]
    compute: Callable

    def __call__(self, state, item=None):
        return self.compute(state, None if self.move is None else self.move(state), item)


class _Blocked(NamedTuple):
    """The halo plan's blocked launches on one device
    (`PallasStepRuntime._blocked_launches`): ``begin(state)`` gives the
    carry and ``launch(carry, a)`` runs one launch under the (K, S) act
    rows ``a``: serial, a `_Phased` (the deep wrap, then K4 on the wrapped
    state); pipelined, one unit (boundary and interior phases), whose phase
    tables are ``phases``."""

    begin: Callable
    launch: Callable
    phases: Optional["_PhaseTables"] = None


class _ShardSteps(NamedTuple):
    """The halo plan's run over one ring of shards for K stacked members
    (`PallasStepRuntime._halo_shard_steps`), as lists over the ring's
    shards. ``t0(inits)``: each shard's (K, B, payload) initial state ->
    the carry after the t = 0 launch. ``launch(carry, item)`` -> the carry
    after one launch, ``item`` a list over the shards: at S = 1 None (every
    member steps) or each shard's (K, 1, 1) bool, the members that take
    the step (the others keep their state); at S > 1 each shard's (K, S)
    act rows. ``states(carry)``: each shard's (K, B, payload) state.
    ``admit(carry, slot, shards)``: member ``slot``'s rows replaced, in
    place, by the t = 0 launch on a fresh member's (B, payload) shards.
    For the traced twin: ``launch`` is a `_Phased` at S = 1 and serial, one
    unit when pipelined; ``t0`` is ``body`` followed, on the pipelined
    schedule, by ``prologue(carry, tracer=None, span=None)``, the prologue
    exchange (None elsewhere); ``phases``: each shard's pipelined phase
    tables."""

    t0: Callable
    launch: Callable
    states: Callable
    admit: Callable
    body: Optional[Callable] = None
    prologue: Optional[Callable] = None
    phases: Optional[List["_PhaseTables"]] = None


class _MemberSlices(NamedTuple):
    """K stacked members over the (row, member) mesh ``mesh`` of Dk member
    slices (`PallasStepRuntime._member_slices`): slice j, members [j*kj,
    (j+1)*kj), runs on ring j as one `_ShardSteps` pair. ``t0(inits)``:
    each member's shard tuple (over its ring's devices) -> the rings'
    carries. ``launch(carries, items)`` -> the next carries, ``items[j]``
    ring j's item (None: every member steps). ``split(x, axis)``: ring j's
    members of tensor ``x`` (member axis ``axis``) on each of its shards'
    devices, the rings' items. ``states(carries)``: each ring's shard
    states; ``members(states)``: each member's shard tuple.
    ``admit(carries, slot, init)``: a fresh member's global init written
    into ``slot`` on the ring that owns it, in place. ``t0`` and ``launch``
    issue on the rings' streams: call them between a fork and a join."""

    mesh: RowMemberMesh
    kj: int
    t0: Callable
    launch: Callable
    split: Callable
    states: Callable
    members: Callable
    admit: Callable


class _ResolvedPlan(NamedTuple):
    """What one graph will actually run: a plan kind and a launch depth;
    ``reason`` names why a plan was re-routed (empty for structural
    picks)."""

    kind: str
    steps_per_launch: int
    reason: str = ""


@register
class PallasStepRuntime(Runtime):
    name = "pallas_step"
    known_options = ("combine", "steps_per_launch", "pipeline", "gather_width_cap",
                     "psum_mean", "cost_model", "halo_impl", "gather_impl", "member_shards")
    sharded = True

    def __init__(self, device="cuda", devices=None, **options):
        super().__init__(device, devices, **options)
        s = self.options.get("steps_per_launch")
        if s is not None and not _schedule.is_auto(s) and int(s) < 1:
            raise ValueError(f"steps_per_launch must be >= 1 or 'auto', got {s!r}")
        self._combine_mode()
        gi = self.options.get("gather_impl", "auto")
        if gi != "auto" and gi not in _halo.GATHER_IMPLS:
            raise ValueError(
                f"unknown gather impl {gi!r}; known {sorted(_halo.GATHER_IMPLS)} or 'auto'")
        self._meshes: dict = {}  # Dk -> its (row, member) mesh, made once

    def _halo_impl(self) -> str:
        """The pipelined edge exchange's transport (``_halo.HALO_ASYNC_IMPLS``):
        "xla" (default, one packed ring buffer) or "ppermute" (one copy a
        direction); the same bits. On one device there is no exchange to
        make and the option changes nothing."""
        return str(self.options.get("halo_impl", "xla"))

    # ------------------------------------------------------ plan dispatch

    def _gather_width_cap(self) -> int:
        return int(self.options.get("gather_width_cap",
                                    _schedule.DEFAULT_GATHER_WIDTH_CAP))

    def plan_for(self, graph: TaskGraph) -> Tuple[Optional[str], str]:
        """pattern -> execution plan kind, or (None, reason).

        halo-expressible period-1 patterns take the halo plan; butterfly
        patterns the stride plan; anything else (and W = 1 butterfly, whose
        partner falls outside the width: a pure self-dependency the stride
        plan's two-dep tables cannot express) the all-gather plan, capped
        at ``gather_width_cap`` rows."""
        D = self.num_devices
        if graph.width % D != 0:
            return None, f"width {graph.width} not divisible by {D} devices"
        r = _patterns.halo_radius(graph)
        if r >= 0 and graph.period == 1:
            return PLAN_HALO, ""
        if graph.pattern in _patterns.BUTTERFLY_PATTERNS and graph.width > 1:
            return PLAN_STRIDE, ""
        cap = self._gather_width_cap()
        if graph.width <= cap:
            return PLAN_ALLGATHER, ""
        return None, (
            f"pattern {graph.pattern} at width {graph.width} fits no "
            f"pallas_step plan (halo: halo-expressible period-1 patterns "
            f"at any width; stride: butterfly fft/tree; allgather: any "
            f"pattern up to gather_width_cap={cap} rows) — fall back to "
            f"the `fused` backend, which runs every pattern at any width")

    def supports(self, graph: TaskGraph):
        plan, why = self.plan_for(graph)
        return (True, "") if plan is not None else (False, why)

    def _cost_model(self, payload: Optional[int] = None) -> _probes.CostModel:
        """The CostModel pricing this runtime's "auto" verdicts: the
        ``cost_model`` option (the explicit tier), else
        `probes.default_cost_model` (env > cached probes > analytic) for
        this device's platform and the runtime's device count. It ranks and sizes
        schedules only; the numerics do not depend on it."""
        return _probes.coerce_cost_model(
            self.options.get("cost_model"), devices=self.num_devices, payload=payload,
            platform=_probes._platform(self.device))

    def _schedule_for_graph(self, graph: TaskGraph) -> _ResolvedPlan:
        """The (plan, steps_per_launch) this runtime will execute, which
        the build methods and `dispatches_per_run` share. The stride plan is
        per step by construction. An explicit depth on a butterfly graph
        re-routes to the blocked all-gather plan when the width is under
        the cap and the resolved depth is > 1; "auto" re-routes only when a
        measured model ranks that plan ahead (`gathered_beats_strides`) at
        a resolved depth > 1, and stays per step otherwise."""
        plan, why = self.plan_for(graph)
        if plan is None:
            raise ValueError(
                f"runtime {self.name} cannot run {graph.describe()}: {why}")
        if plan == PLAN_HALO:
            H = _patterns.halo_radius(graph)
            return _ResolvedPlan(plan, *self._halo_depth(
                [graph], H, graph.steps))
        opt = self.options.get("steps_per_launch")
        if plan == PLAN_STRIDE:
            if opt in (None, 1):
                return _ResolvedPlan(plan, 1)
            cap = self._gather_width_cap()
            if _schedule.is_auto(opt):
                if graph.width > cap:
                    return _ResolvedPlan(plan, 1, (
                        f"auto keeps the stride plan, per step by construction: "
                        f"width {graph.width} is over gather_width_cap={cap}"))
                s, why = self._gathered_depth(graph)
                if s <= 1:
                    return _ResolvedPlan(plan, 1, f"auto keeps the stride plan ({why})")
                strides = _patterns.butterfly_slot_strides(graph)
                B = self._block(graph)
                beats, why = _schedule.gathered_beats_strides(
                    width=graph.width, block=B, steps_per_launch=s,
                    off_block_strides=sum(1 for st in strides if st >= B),
                    period=len(strides), model=self._cost_model(graph.payload),
                    impl=self._exchange_impl())
                return _ResolvedPlan(PLAN_ALLGATHER, s, why) if beats \
                    else _ResolvedPlan(plan, 1, why)
            if graph.width <= cap:
                s = self._gathered_depth(graph)[0]
                if s > 1:
                    return _ResolvedPlan(PLAN_ALLGATHER, s, "explicit blocked request")
            return _ResolvedPlan(plan, 1)
        return _ResolvedPlan(plan, *self._gathered_depth(graph))

    # ------------------------------------------------------- launch depth

    def _tile_sms(self) -> dict:
        """The SM count K4's tile cut is planned for: the card's on the
        card; on the CPU `blocked_plan`'s default, the H100's 132."""
        if self.device.type == "cuda":
            return {"sms": sm_count(self.device.index or 0)}
        return {}

    def _table_width(self, members: Sequence[TaskGraph], halo: int) -> int:
        """D of the halo plan's blocked (K, M, D) tables at halo ``halo``:
        the window's 2H + 1 slots, or the most dependencies of any member's
        row (gather / onehot, `_rel_dep_operands`, padded to the group's
        most by `_stack_operands`)."""
        if self._combine_mode() == "window":
            return 2 * halo + 1
        return max(max(1, max(len(g.dependencies(1, p)) for p in range(g.width)))
                   for g in members)

    def _halo_fit(self, K: int, width: int, payload: int, halo: int, table_width: int,
                  kernel) -> _schedule.HaloFit:
        """The card's fit rule for the halo plan: ``fits(S, pipelined)`` is
        whether every K4 launch of depth S on that schedule takes the tiled
        form (`blocked_plan` finds a cut under ``bodies.SMEM_LIMIT``): the
        serial launch on the (K, W + 2*S*H) wrapped state, or the pipelined
        boundary (K, 6*S*H) and interior (K, W) launches (at H = 0 the runtime
        runs the serial one, `_pipeline_active`)."""
        memory = _memory_body(kernel)
        combine, sms = self._combine_mode(), self._tile_sms()

        def fits(s: int, pipelined: bool) -> bool:
            depth = s * halo
            rows = (6 * depth, width) if pipelined and depth else (width + 2 * depth,)
            return all(blocked_plan((K, m, payload), (K, m, table_width), s, combine,
                                    memory, halo, **sms) is not None for m in rows)

        return fits

    def _exchange_impl(self) -> str:
        """The cost model's exchange key: the halo transport at D > 1, the
        one-device self-wrap's at D = 1."""
        return self._halo_impl() if self.mesh is not None else _probes.SELF_EXCHANGE

    def _halo_depth(self, members: Sequence[TaskGraph], halo: int,
                    total_steps: int) -> Tuple[int, str]:
        """(S, reason) of the halo plan for ``members`` stacked into one
        launch at halo ``halo`` (one graph: K = 1): an explicit depth
        through the plans' one option parser, clamped to T - 1 (reason
        empty); "auto" through `schedule.resolve_steps_per_launch` under
        the card's fit rule (`_halo_fit`) and this runtime's cost model."""
        opt = self.options.get("steps_per_launch")
        if not _schedule.is_auto(opt):  # explicit: the option parser alone
            return _schedule._resolve_depth(opt, None, total_steps), ""
        g = members[0]
        D = self._table_width(members, halo)
        B = self._block(g)
        fits = self._halo_fit(len(members), B, g.payload, halo, D, g.kernel)
        model = self._cost_model(g.payload)
        s = _schedule.resolve_steps_per_launch(
            opt, block=B, radius=halo, fits=fits, total_steps=total_steps,
            pipeline=self._pipeline_requested(), model=model)
        rule = ("a depth fits when its K4 launch takes the tiled form, a tile "
                f"under {SMEM_LIMIT} bytes of shared memory")
        if s == 1:
            why = (why_not_tiled(3, _memory_body(g.kernel), halo)
                   or (f"T = {total_steps} leaves one combine step" if total_steps <= 2
                       else "no depth > 1 finds such a tile"))
            return 1, f"auto -> S=1: no depth > 1 fits, since {why} ({rule})"
        if self._pipeline_active(B, s, halo, g.payload):
            sched = "pipelined: its interior covers the exchange and pays off"
        elif not self._pipeline_requested():
            sched = "serial (pipeline=False)"
        else:
            sched = ("serial: no depth's pipelined interior covers the exchange "
                     "and pays off")
        return s, (f"auto -> S={s}, the deepest candidate of {_schedule.CANDIDATES} "
                   f"under T - 1 = {total_steps - 1} that fits ({rule}), {sched}; "
                   f"cost model: {model.describe()}")

    def _grids(self) -> int:
        """K4 launches that run at once on one card: the shards that share
        it (D on ``devices=["cuda"] * D``), each planned for its share."""
        return max(self.devices.count(d) for d in self.devices)

    def _gathered_fit(self, graph: TaskGraph) -> _schedule.GatherFit:
        """The card's fit rule for the blocked all-gather plan, its
        counterpart of the reference's VMEM fit: ``fits(S)`` is whether its
        K4 launch on the (1, W) state, with the tables the launch holds
        ((1, S, W, D) time-varying, or one static (1, W, D) pair), takes
        the tiled or the resident form (`blocked_form`: the launch declares
        no radius, so the resident form, one cluster a column slice holding
        the whole buffer in shared memory), planned for the card's share of
        each of the shards that run at once. The memory body never fits."""
        W, P, D = graph.width, graph.payload, graph.max_deps
        memory, time_varying = _memory_body(graph.kernel), _time_varying(graph)
        combine, share = self._plan_combine(PLAN_ALLGATHER), self._card_share()

        def fits(s: int) -> bool:
            wgt = (1, s, W, D) if time_varying else (1, W, D)
            return blocked_form((1, W, P), wgt, s, combine, memory, None,
                                **share).form != "cooperative"

        return fits

    def _card_share(self) -> dict:
        """`blocked_form`'s SMs and co-resident clusters for one of the
        `_grids` K4 launches that share a card: the card's own divided on
        the card; on the CPU the H100's 132 SMs (`default_clusters`)."""
        sms, grids = self._tile_sms().get("sms", 132), self._grids()
        clusters = (resident_clusters(self.device.index or 0)
                    if self.device.type == "cuda" else default_clusters(sms))
        return {"sms": max(1, sms // grids), "clusters": share_clusters(clusters, grids)}

    def _gathered_depth(self, graph: TaskGraph) -> Tuple[int, str]:
        """(S, reason) of the all-gather plan: explicit depths through the
        shared option parser (reason empty); "auto" through
        `schedule.resolve_steps_per_launch_gathered` under `_gathered_fit`."""
        opt = self.options.get("steps_per_launch")
        if not _schedule.is_auto(opt):  # explicit: the option parser alone
            return _schedule._resolve_depth(opt, None, graph.steps), ""
        model = self._cost_model(graph.payload)
        fits = self._gathered_fit(graph)
        s = _schedule.resolve_steps_per_launch_gathered(
            opt, width=graph.width, block=self._block(graph), fits=fits,
            total_steps=graph.steps, model=model)
        rule = ("a depth fits when its K4 launch takes the tiled or the resident "
                "form, the card's counterpart of the reference's VMEM fit")
        if s > 1:
            return s, (f"auto -> S={s}: the deepest candidate of {_schedule.CANDIDATES} "
                       f"under T - 1 = {graph.steps - 1} whose gathered launch pays off "
                       f"and fits ({rule}); cost model: {model.describe(graph.width)}")
        memory = _memory_body(graph.kernel)
        if memory:
            why = why_not_resident(memory)
        elif graph.steps <= 2:
            why = f"T = {graph.steps} leaves one combine step"
        elif not any(fits(c) for c in _schedule.CANDIDATES if c > 1):
            why = blocked_form(
                (1, graph.width, graph.payload),
                (1, 2, graph.width, graph.max_deps) if _time_varying(graph)
                else (1, graph.width, graph.max_deps), 2,
                self._plan_combine(PLAN_ALLGATHER), False, None,
                **self._card_share()).reason
        else:
            why = (f"no depth's replication of W - B = {graph.width - self._block(graph)} "
                   f"rows pays off against the exchange it saves")
        return 1, (f"auto -> S=1 on the all-gather plan: no depth > 1 pays off and "
                   f"fits, since {why} ({rule})")

    def _gathered_steps_per_launch(self, graph: TaskGraph) -> int:
        return self._gathered_depth(graph)[0]

    # ------------------------------------------------------------ operands

    def _combine_mode(self) -> str:
        mode = str(self.options.get("combine", "window"))
        if mode not in COMBINE_OPTIONS:
            raise ValueError(
                f"unknown combine option {mode!r}: choose window, gather, "
                f"or onehot ('pair' is the stride plan's internal "
                f"lowering, selected automatically)")
        return mode

    def _plan_combine(self, plan: str) -> str:
        """Combine mode under a plan. halo honours the option as is; the
        stride and all-gather buffers are addressed by gathered rows, which
        the window combine cannot express, so the default resolves per
        plan: ``pair`` on the stride plan (the partner rows come from the
        XOR shuffle, so the combine is an elementwise (a + b) * 0.5),
        ``gather`` on the all-gather plan (the reference's choice off the
        TPU, where its onehot's (W, W) matrix is pure overhead). An
        explicit gather / onehot is honoured on both (the ablations); every
        choice gives the same bits per plan."""
        mode = self._combine_mode()
        if plan == PLAN_HALO or mode in ("gather", "onehot"):
            return mode
        return "pair" if plan == PLAN_STRIDE else "gather"

    def _pipeline_requested(self) -> bool:
        """``pipeline=False`` is the serial ablation; default on."""
        return bool(self.options.get("pipeline", True))

    def _pipeline_active(self, block: int, s: int, halo: int,
                         payload: Optional[int] = None) -> bool:
        """The pipelined schedule applies when blocking is on AND the owned
        block keeps a nonempty interior once 2*S*r edge rows belong to the
        boundary phase; otherwise the serial schedule runs. Under
        ``steps_per_launch="auto"`` the tuner's verdict also binds: the
        interior must cover the exchange under this runtime's cost model
        for ``payload`` (`schedule.pipeline_interior_covers_exchange`); an
        explicit S pipelines wherever it structurally can."""
        if not (s > 1 and halo > 0 and self._pipeline_requested()
                and block > 2 * s * halo):
            return False
        if _schedule.is_auto(self.options.get("steps_per_launch")):
            return _schedule.pipeline_interior_covers_exchange(
                block, halo, s, self._cost_model(payload))
        return True

    @staticmethod
    def _launches(total_steps: int, s: int) -> int:
        """Kernel launches for one run: the t=0 body-only launch plus
        ceil((T-1)/S) blocked combine launches."""
        if total_steps <= 1:
            return 1
        return 1 + -(-(total_steps - 1) // s)

    def _operands(self, graph: TaskGraph, halo: int, block: Optional[int] = None):
        """Host-built (idx, wgt, idx0, wgt0) for one graph, over its W
        global rows: the t >= 1 operands in the selected combine mode
        (gather / onehot as positions in the shard's halo-extended block of
        ``block`` rows, by default W / D), and the t = 0 (body only)
        1-column self operands."""
        B = block or self._block(graph)
        if self._combine_mode() == "window":
            idx, wgt = _window_operands(graph, halo)
        else:
            idx, wgt = _ext_dep_operands(graph, B, halo)
        idx0, wgt0 = _self_operands(graph.width, B)
        return idx, wgt, idx0, wgt0

    def _blocked_operands(self, graph: TaskGraph, halo: int, block: Optional[int] = None):
        """Host-built (idx, wgt, idx0, wgt0) for the blocked path: window
        mode reuses the per-global-row weight table; gather/onehot switch
        to SIGNED offsets (`_rel_dep_operands`), which wrap like state and
        are rebased onto each working buffer."""
        if self._combine_mode() == "window":
            idx, wgt = _window_operands(graph, halo)
        else:
            idx, wgt = _rel_dep_operands(graph)
        idx0, wgt0 = _self_operands(graph.width, block or self._block(graph))
        return idx, wgt, idx0, wgt0

    def _kernel_kw(self, graph: TaskGraph, combine: Optional[str] = None) -> dict:
        spec = graph.kernel
        return dict(kind=spec.kind, iterations=spec.iterations,
                    scratch=spec.scratch, combine=combine or self._combine_mode())

    # ------------------------------------------------------------- builds

    def _build_eager(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        plan = self._schedule_for_graph(graph)
        S = plan.steps_per_launch
        if self.mesh is not None and plan.kind == PLAN_HALO:
            run = self._sharded_stacked_run((graph,), S)
            return lambda shards: run((shards,))[0]
        if S == 1:
            return self._build_plan_stepper(graph, plan.kind)
        if plan.kind == PLAN_ALLGATHER:
            return self._build_allgather_blocked(graph, S)
        return self._build_blocked(graph, S)  # the halo plan on one device

    def _halo_step_fns(self, graph: TaskGraph) -> Tuple[Callable, Callable]:
        """(t0, step) for the halo plan at S = 1 on (1, W, P) states: the
        t = 0 body-only K3 launch on the self operands, then one K3 launch a
        timestep with the halo wrap folded in (``wrap=H``)."""
        H = _patterns.halo_radius(graph)
        kw = self._kernel_kw(graph)
        idx, wgt, idx0, wgt0 = (
            torch.from_numpy(a)[None].to(self.device)
            for a in self._operands(graph, H))

        def t0(x):
            return _kops.taskbench_step(x, idx0, wgt0, **kw)

        def step(x, t: int):
            return _kops.taskbench_step(x, idx, wgt, wrap=H, **kw)

        return t0, step

    def _blocked_launches(self, idx, wgt, B: int, S: int, H: int, kwb: dict,
                          pipelined: bool) -> _Blocked:
        """The halo plan's blocked launches (`_Blocked`) on a stacked (K, B,
        payload) state with (K, B, D) tables: ``begin(state)`` gives the
        carry, ``launch(carry, a)`` runs one blocked launch under the (K, S)
        act rows ``a`` and gives the next; the state is ``carry[0]``.
        Pipelined: boundary + interior phases (two K4 launches, the interior
        on a second stream on the card). Serial: one deep wrap (the
        one-device exchange, a row gather of the state) and one K4 launch on
        the wrapped state, the owned rows sliced out after it."""
        depth = S * H
        mode = self._combine_mode()
        if pipelined:
            ph = _phase_tables(idx, wgt, depth, mode)
            side = (torch.cuda.Stream(self.device)
                    if self.device.type == "cuda" else None)

            def begin(state):
                return (state, *_prologue_exchange(state, depth))

            def launch(carry, a):
                return _pipelined_launch(*carry, a, ph, depth, kwb, side)

            return _Blocked(begin, launch, ph)
        iext, wext = _extend_tables(idx, wgt, depth, mode, row_axis=1)
        rows = halo_rows(B, depth, self.device) if depth else None

        def wrap(carry, tracer=None, span=None):
            with _halo.transport_span(tracer, "deep_exchange", impl=_probes.SELF_EXCHANGE,
                                      depth=depth, **(span or {})):
                ext = _extend_state(carry[0], rows)
                if tracer is not None and tracer.enabled:
                    self._drain()
            return ext

        def kernel(carry, ext, a):
            src = carry[0] if ext is None else ext
            return (_kops.taskbench_step(src, iext, wext, a, **kwb)[:, depth:depth + B],)

        return _Blocked(lambda state: (state,), _Phased(wrap if depth else None, kernel))

    def _blocked_parts(self, graph: TaskGraph, S: int):
        """(t0, acts, launches, kwb) of the halo plan's blocked run on one
        device: the t = 0 K3 launch on a (1, W, P) state, the (L, 1, S) act
        rows, the `_Blocked` launches and their K4 keywords."""
        H = _patterns.halo_radius(graph)
        T = graph.steps
        kw0 = self._kernel_kw(graph)
        # the tables reach at most H rows (window: D = 2H + 1; gather/onehot:
        # offsets in [-H, H], which `_rebase_rows`' clamp only moves toward
        # the row itself), so K4 may take its tiled form
        kwb = dict(kw0, steps_per_launch=S, radius=H)
        idx, wgt, idx0, wgt0 = (
            torch.from_numpy(a)[None].to(self.device)
            for a in self._blocked_operands(graph, H))
        acts = torch.from_numpy(_act_schedule((T,), T, S)).to(self.device)  # (L, 1, S)
        blk = self._blocked_launches(
            idx, wgt, graph.width, S, H, kwb,
            self._pipeline_active(graph.width, S, H, graph.payload))
        return (lambda x: _kops.taskbench_step(x, idx0, wgt0, **kw0)), acts, blk, kwb

    def _build_blocked(self, graph: TaskGraph, S: int) -> Callable:
        """ceil((T-1)/S) launches of K4 after the t = 0 K3 launch. When the
        pipeline applies, each launch splits into boundary + interior
        phases (two K4 launches); otherwise one deep wrap and one K4 launch
        on the wrapped state."""
        t0, acts, blk, _ = self._blocked_parts(graph, S)

        def run(init):
            carry = blk.begin(t0(init[None]))  # t=0
            for a in acts:
                carry = blk.launch(carry, a)
            return carry[0][0]

        return run

    # -------------------------------------------------- the halo plan, D > 1

    @staticmethod
    def _shard_tables(table: np.ndarray, depth: int, d: int, B: int, device,
                      rebase: bool = False) -> torch.Tensor:
        """Shard d's rows of a (K, W, Dt) global table, halo-extended by
        ``depth`` rows a side: global rows [d*B - depth, (d+1)*B + depth)
        mod W, exactly the rows the ring exchange would bring (multi-hop
        past the block included). The tables are constant, so they are cut
        once per build from the global table rather than exchanged each
        run. ``rebase``: signed offsets -> rows of this buffer."""
        W = table.shape[1]
        rows = np.arange(d * B - depth, (d + 1) * B + depth) % W
        t = torch.from_numpy(np.ascontiguousarray(table[:, rows]))
        if rebase:
            t = _rebase_rows(t, row_axis=1)
        return t.to(device)

    def _halo_shard_steps(self, members: Sequence[TaskGraph], S: int,
                          mesh: _halo.ShardMesh, steps: Optional[int] = None,
                          pipelined: Optional[bool] = None) -> _ShardSteps:
        """The halo plan over the shards of ``mesh`` (a ring of Dr shards,
        B = W / Dr rows each) for K members stacked into one (K, B, payload)
        state a shard, as a `_ShardSteps` (t0, launch) pair; every shard
        computes on its own stream of ``mesh``. ``steps``: the run's
        lockstep T (default the members' longest); ``pipelined``: the
        schedule at S > 1 (default the gate, `_pipeline_active` at B).

        S = 1: each shard keeps two persistent (K, H + B + H) extended
        buffers, the carry, and alternates between them. A launch is the
        ring exchange of H rows (``_halo.exchange_halos``, the "ppermute"
        transport, the reference's ``_extend_state``), which writes the
        neighbours' edge rows into the current buffer's head and tail, and
        one K3 launch that reads that buffer, unfolded (``wrap`` is the
        one-device form), and writes the owned rows of the other (``out=``;
        for K > 1 members, whose owned rows are not contiguous, or a frozen
        member, a copy). S > 1, serial: per launch the deep exchange of S*H
        rows (multi-hop past the block), the extended buffer, one K4 launch
        on it and the owned rows sliced out. S > 1, pipelined (B > 2*S*H):
        per launch the boundary K4 launch on both 3*S*H-row edge buffers,
        the next launch's edge exchange started on its outputs
        (``exchange_edges_start`` over ``halo_impl``), then the interior K4
        launch, which runs under the transfer; the next launch joins it (the
        one-device phase slicing and phases, `_phase_slices`,
        `_boundary_launch`, `_interior_launch`). The t = 0 launch is K3 on
        the self operands."""
        devs, K = mesh.devices, len(members)
        g0 = members[0]
        B, P = g0.width // mesh.size, g0.payload
        T = steps or max(g.steps for g in members)
        H = max(_patterns.halo_radius(g) for g in members)
        kw0 = self._kernel_kw(g0)
        mode = self._combine_mode()
        window = mode == "window"
        build = self._blocked_operands if S > 1 else self._operands
        idx, wgt, idx0, wgt0 = _stack_operands([build(g, H, block=B) for g in members])

        def mp(fn, *lists):
            return self._map(fn, *lists, mesh=mesh)

        def cut(table: np.ndarray, d: int, dev) -> torch.Tensor:  # shard d's B rows
            return self._shard_tables(table, 0, d, B, dev)

        t0_ops = [(cut(idx0, d, dev), cut(wgt0, d, dev)) for d, dev in enumerate(devs)]

        def body0(d, x, slots=slice(None), out=None):
            """The t = 0 K3 (the body alone) on shard d's (k, B, P) ``x``,
            members ``slots`` of the stack."""
            return _kops.taskbench_step(x, t0_ops[d][0][slots], t0_ops[d][1][slots], out=out,
                                        **kw0)

        def admit(carry, slot, shards):
            mp(lambda d, s, x: s[slot:slot + 1].copy_(body0(d, x[None], slice(slot, slot + 1))),
               states(carry), shards)
            return carry

        if S == 1:
            i_d = [cut(idx, 0 if window else d, dev) for d, dev in enumerate(devs)]
            w_d = [cut(wgt, d, dev) for d, dev in enumerate(devs)]

            def step_into(x, ops, dst, keep=None):
                """K3 on ``x`` into ``dst``, the owned rows of the next buffer
                (``keep``: the members that take the step, and their rows)."""
                direct = keep is None and dst.is_contiguous()
                nxt = _kops.taskbench_step(x, *ops, out=dst if direct else None, **kw0)
                if not direct:
                    dst.copy_(nxt if keep is None else torch.where(keep[0], nxt, keep[1]))

            def t0(inits):
                bufs = tuple(mp(lambda d, x: x.new_empty((K, B + 2 * H, P)), inits)
                             for _ in range(2))
                mp(lambda d, x, y: step_into(x, t0_ops[d], y[:, H:H + B]), inits, bufs[0])
                return bufs

            def move(carry, tracer=None, span=None):
                """The ring exchange into the current buffers' heads and tails."""
                cur = carry[0]
                _halo.exchange_halos([c[:, H:H + B] for c in cur], H, mesh, row_axis=1,
                                     out=([c[:, :H] for c in cur], [c[:, H + B:] for c in cur]),
                                     tracer=tracer, span=span)

            def compute(carry, _, keep=None):
                cur, nxt = carry
                mp(lambda d, x, y: step_into(
                    x, (i_d[d], w_d[d]), y[:, H:H + B],
                    None if keep is None else (keep[d], x[:, H:H + B])), cur, nxt)
                return nxt, cur

            def states(carry):
                return [c[:, H:H + B] for c in carry[0]]

            return _ShardSteps(t0, _Phased(move if H else None, compute), states, admit, body=t0)

        depth = S * H
        kwb = dict(kw0, steps_per_launch=S, radius=H)
        ext_w = [self._shard_tables(wgt, depth, d, B, dev) for d, dev in enumerate(devs)]
        if pipelined is None:
            pipelined = self._pipeline_active(B, S, H, P)
        if pipelined:
            ph = [_phase_slices(None if window else self._shard_tables(idx, depth, d, B, dev),
                                ext_w[d], depth, mode) for d, dev in enumerate(devs)]
            impl = self._halo_impl()

            def body(inits):
                return mp(lambda d, x: body0(d, x), inits)

            def prologue(states_, tracer=None, span=None):
                if T <= 1:
                    return states_, None
                return states_, _halo.exchange_edges_start(
                    mesh, [s[:, :depth] for s in states_], [s[:, B - depth:] for s in states_],
                    row_axis=1, impl=impl, tracer=tracer, span=span)

            def t0(inits):
                return prologue(body(inits))

            def launch(carry, a):
                states_, handle = carry
                lefts, rights = handle.join()
                outs = mp(lambda d, s, hl, hr: _boundary_launch(s, hl, hr, a[d], ph[d], depth,
                                                                kwb), states_, lefts, rights)
                nxt = _halo.exchange_edges_start(mesh, [o[0] for o in outs],
                                                 [o[1] for o in outs], row_axis=1, impl=impl)
                mids = mp(lambda d, s: _interior_launch(s, a[d], ph[d], depth, kwb), states_)
                return mp(lambda d, o, m: torch.cat([o[0], m, o[1]], dim=1), outs, mids), nxt

            def states(carry):
                return carry[0]

            return _ShardSteps(t0, launch, states, admit, body=body, prologue=prologue,
                               phases=ph)

        ext_i = [self._shard_tables(idx, depth, d, B, dev, rebase=True) if not window
                 else torch.from_numpy(idx[:, :1]).to(dev) for d, dev in enumerate(devs)]

        def t0(inits):
            return mp(lambda d, x: body0(d, x), inits)

        def move(states_, tracer=None, span=None):
            """The deep exchange: each shard's (left, right) halos."""
            return _halo.exchange_halos(states_, depth, mesh, row_axis=1, tracer=tracer,
                                        span=span)

        def compute(states_, halos, a):
            src = states_
            if halos is not None:
                src = mp(lambda d, s, l, r: torch.cat([l, s, r], dim=1), states_, *halos)
            return mp(lambda d, x: _kops.taskbench_step(
                x, ext_i[d], ext_w[d], a[d], **kwb)[:, depth:depth + B], src)

        def states(carry):
            return carry

        return _ShardSteps(t0, _Phased(move if depth else None, compute), states, admit,
                           body=t0)

    def _stacked_shards(self, ring: _halo.ShardMesh, members) -> List[torch.Tensor]:
        """Each shard of ``ring``'s (K, B, payload) stack of ``members``'
        shard tuples, stacked on the shard's own stream (after a fork, so
        the shard's launches come after it)."""
        return self._map(lambda d, *xs: _stacked(xs), *members, mesh=ring)

    def _row_member_mesh(self, dk: int) -> RowMemberMesh:
        """The (row, member) mesh of this runtime's D devices at Dk = ``dk``
        (Dk = 1: the row mesh itself), made once per Dk, so every build
        issues on the same streams."""
        if dk == 1:
            return RowMemberMesh([self.mesh])
        if dk not in self._meshes:
            self._meshes[dk] = make_row_member_mesh(self.devices, dk)
        return self._meshes[dk]

    def _member_slices(self, members: Sequence[TaskGraph], S: int, dk: int,
                       steps: int, pipelined: Optional[bool] = None) -> _MemberSlices:
        """The halo plan over D row shards for K members stacked into one
        state, on the (row, member) mesh of ``dk`` member slices, as a
        `_MemberSlices`: slice j runs on ring j at B = W/Dr
        (`_halo_shard_steps` at lockstep T ``steps``, ``pipelined`` its
        schedule at S > 1), its exchanges inside that ring; every shard on
        its own stream. The run and the stacked launch plan over shards
        are both built on it."""
        rmesh = self._row_member_mesh(dk)
        rings, kj = rmesh.rings, len(members) // dk
        Dr = rings[0].size
        pairs = [self._halo_shard_steps(members[j * kj:(j + 1) * kj], S, ring, steps, pipelined)
                 for j, ring in enumerate(rings)]

        def t0(inits):
            return tuple(p.t0(self._stacked_shards(ring, inits[j * kj:(j + 1) * kj]))
                         for j, (p, ring) in enumerate(zip(pairs, rings)))

        def launch(carries, items=None):
            items = [None] * dk if items is None else items
            return tuple(p.launch(c, it) for p, c, it in zip(pairs, carries, items))

        def split(x: torch.Tensor, axis: int = 0):
            return [self._per_device(lambda dev, j=j: x.narrow(axis, j * kj, kj).to(dev),
                                     ring.devices) for j, ring in enumerate(rings)]

        def states(carries):
            return [p.states(c) for p, c in zip(pairs, carries)]

        def by_member(finals):
            return tuple(tuple(finals[k // kj][d][k % kj] for d in range(Dr))
                         for k in range(len(members)))

        def admit(carries, slot, init):
            j, local = divmod(slot, kj)
            shards = self._split(init, rings[j].devices)
            self._issued(rings[j], lambda: pairs[j].admit(carries[j], local, shards))
            return carries

        return _MemberSlices(rmesh, kj, t0, launch, split, states, by_member, admit)

    def _sharded_stacked_run(self, members: Sequence[TaskGraph], S: int,
                             dk: int = 1) -> Callable:
        """The halo plan over D row shards for K members stacked into one
        state (a graph: K = 1), on the (row, member) mesh of ``dk`` member
        slices (`_member_slices`). The run takes and gives a tuple of K
        members' shard tuples, member k's over its ring's Dr devices; the
        rings' launches are issued in turn each launch, every shard on its
        own stream. Members past their own horizon keep their state (a
        ``torch.where`` at S = 1, the act rows at S > 1)."""
        T = max(g.steps for g in members)
        sl = self._member_slices(members, S, dk, T)
        if S == 1:
            L = T - 1
            live = (GraphEnsemble(members).active_table()[1:, :, None, None]
                    if len({g.steps for g in members}) > 1 else None)  # (T - 1, K, 1, 1)
        else:
            live = _act_schedule([g.steps for g in members], T, S)  # (L, K, S)
            L = live.shape[0]
        items = None if live is None else sl.split(
            torch.from_numpy(np.ascontiguousarray(live)), axis=1)

        def run(inits):
            sl.mesh.fork()
            carries = sl.t0(inits)
            for l in range(L):
                carries = sl.launch(carries, None if items is None else
                                    [[x[l] for x in ring] for ring in items])
            finals = sl.states(carries)
            sl.mesh.join(finals)
            return sl.members(finals)

        return run

    # ------------------------------------------- stride / all-gather plans

    def _per_device(self, make: Callable, devices: Optional[Sequence] = None) -> List:
        """``make(device)`` once per distinct device of ``devices`` (default
        the row shards'), listed per shard (read only constants: shards on
        one card share one)."""
        made: dict = {}
        devices = self.devices if devices is None else devices
        for dev in devices:
            if dev not in made:
                made[dev] = make(dev)
        return [made[dev] for dev in devices]

    def _stride_step_fns(self, graph: TaskGraph) -> Tuple[Callable, Callable]:
        """(t0, step) for the stride plan (butterfly) over a list of D shard
        states, each (1, B, P) (one device: [the (1, W, P) state]): ``step
        (shards, t)`` runs timestep t's branch (`_stride_branches`)."""
        t0, branch_at = self._stride_branches(graph)
        return t0, (lambda shards, t: branch_at(t)(shards))

    def _stride_branches(self, graph: TaskGraph) -> Tuple[Callable, Callable]:
        """(t0, branch_at) for the stride plan over shard lists:
        ``branch_at(t)`` is timestep t's branch, a `_Phased` step. The
        period slot's stride, chosen on the host from t, selects it, and
        one K3 launch a shard combines {p, partner} and runs the body. An in-block stride (s < B,
        every stride on one device) takes the partner rows from the shard's
        own block (`_xor_swap`); a block stride (s >= B) takes shard d XOR
        s/B's block through ``_halo.exchange_stride`` over ``halo_impl``.
        With ``pair`` K3 reads [local | partner]; with the gather / onehot
        ablations it reads the local block (in-block) or [local | partner]
        (block strides) through the slot's (B, 2) tables. Every partner row
        is an exact copy, so the bits are the one-device run's."""
        mesh, B = self.mesh, self._block(graph)
        mode = self._plan_combine(PLAN_STRIDE)
        kw = self._kernel_kw(graph, combine=mode)
        impl = self._halo_impl()
        period = graph.period
        strides = _patterns.butterfly_slot_strides(graph)
        # pair's idx/wgt are dummies: wgt's row count declares the output
        # width, B rows of the shard (not W)
        dummy_i = self._per_device(lambda dev: torch.zeros((1, 1, 1), dtype=torch.int32,
                                                           device=dev))
        dummy_w = self._per_device(lambda dev: torch.zeros((1, B, 1), dtype=torch.float32,
                                                           device=dev))

        def exchange(s: int) -> Callable:
            """A block stride's move: shard d XOR s/B's block for each shard."""
            def move(shards, tracer=None, span=None):
                return _halo.exchange_stride(mesh, shards, (s // B,), row_axis=1, impl=impl,
                                             tracer=tracer, span=span)[0]

            return move

        def make_branch(s: int) -> _Phased:
            move = exchange(s) if s >= B else None  # an in-block stride moves no rows
            if mode == "pair":
                def compute(shards, partners, _=None):
                    if partners is None:  # in-block: the XOR shuffle of the shard's rows
                        partners = self._map(lambda d, x: _xor_swap(x, s, row_axis=1), shards)
                    return self._map(lambda d, x, p: _kops.taskbench_step(
                        torch.cat([x, p], dim=1), dummy_i[d], dummy_w[d], **kw),
                        shards, partners)

                return _Phased(move, compute)
            idx_np, wgt_np, off_block = _stride_slot_tables(B, s)
            idx = self._per_device(lambda dev: torch.from_numpy(idx_np)[None].to(dev))
            wgt = self._per_device(lambda dev: torch.from_numpy(wgt_np)[None].to(dev))
            if not off_block:
                def compute(shards, _p, _=None):
                    return self._map(lambda d, x: _kops.taskbench_step(x, idx[d], wgt[d], **kw),
                                     shards)

                return _Phased(None, compute)

            def compute(shards, partners, _=None):
                return self._map(lambda d, x, p: _kops.taskbench_step(
                    torch.cat([x, p], dim=1), idx[d], wgt[d], **kw), shards, partners)

            return _Phased(move, compute)

        branches = {s: make_branch(s) for s in sorted(set(strides))}
        if mode == "pair":
            # t = 0 (body only) through pair itself: [x | x] halves give
            # (a + a) * 0.5 == a bit for bit
            def t0(shards):
                return self._map(lambda d, x: _kops.taskbench_step(
                    torch.cat([x, x], dim=1), dummy_i[d], dummy_w[d], **kw), shards)
        else:
            selfs = self._per_device(lambda dev: tuple(a[None] for a in _self_tables(B, dev)))

            def t0(shards):
                return self._map(lambda d, x: _kops.taskbench_step(x, *selfs[d], **kw), shards)

        return t0, (lambda t: branches[strides[(t - 1) % period]])

    def _global_table_fn(self, graph: TaskGraph):
        """(tables_at, key_of, time_varying): the global-table policy,
        shared by the per-step and blocked all-gather build methods so the two
        schedules cannot diverge. ``tables_at(t)`` gives timestep t's (W,
        D) idx / wgt numpy tables: spread rotates its base table by +(t-1)
        (weights never rotate), other patterns take their period stack at
        slot (t-1) mod period. ``key_of(t)`` is what the tables depend on
        (the rotation or the slot). time_varying is False for period-1
        patterns (e.g. all_to_all): one static (W, D) pair."""
        W = graph.width
        if graph.pattern == "spread":
            base_i, base_w = _spread_base_operands(graph)

            def tables_at(t: int):
                return np.mod(base_i + (t - 1), W).astype(np.int32), base_w

            return tables_at, (lambda t: (t - 1) % W), True
        gi, gw = _global_slot_operands(graph)
        period = gi.shape[0]

        def tables_at(t: int):
            slot = (t - 1) % period
            return gi[slot], gw[slot]

        return tables_at, (lambda t: (t - 1) % period), period > 1

    def _gather_impl(self, width: int) -> str:
        """The all-gather plan's transport (``_halo.GATHER_IMPLS``), the
        ``gather_impl`` option: an explicit name wins; "auto" (the default)
        follows a non-default ``halo_impl`` that names a gather transport
        too ("ppermute"), and otherwise asks `schedule.choose_gather_impl`
        at (D, ``width``) under this runtime's cost model. Every transport
        gives the same bits; on one device nothing is gathered. (An unknown
        name is refused at construction.)"""
        opt = self.options.get("gather_impl", "auto")
        if opt != "auto":
            return opt
        halo = self._halo_impl()
        if halo != "xla" and halo in _halo.GATHER_IMPLS:
            return halo
        return _schedule.choose_gather_impl(width=width, devices=self.num_devices,
                                            model=self._cost_model())[0]

    def _gather_fn(self, graph: TaskGraph) -> Callable[..., List]:
        """The all-gather plan's gather over D > 1 shards, a `_Phased` move:
        each shard's (1, W, P) global-order buffer (`_halo.gather_global`
        over `_gather_impl`; shards on one card share one). One device
        gathers nothing: the state is the buffer."""
        mesh, impl, group = self.mesh, self._gather_impl(graph.width), None
        if impl == "chunked":  # G resolved once a build, under this runtime's model
            group = _schedule.choose_gather_chunk_group(
                devices=self.num_devices, width=graph.width, model=self._cost_model())[0]
        return lambda shards, tracer=None, span=None: _halo.gather_global(
            shards, mesh, row_axis=1, impl=impl, chunk_group=group, tracer=tracer, span=span)

    def _psum_mean(self, graph: TaskGraph) -> bool:
        """Whether the all-gather plan combines ``graph`` through the row
        mean (all_to_all under ``psum_mean``, default on)."""
        return graph.pattern == "all_to_all" and bool(self.options.get("psum_mean", True))

    def _allgather_step_fns(self, graph: TaskGraph,
                            steps: Optional[int] = None) -> Tuple[Callable, _Phased]:
        """(t0, step) for the all-gather plan, per step, over a list of D
        shard states, each (1, B, P) (one device: [the (1, W, P) state]);
        ``step`` is a `_Phased` step.

        ``step(shards, t)``: the gather (`_gather_fn`; its move at D > 1,
        none on one device), then one K3 launch a
        shard on the gathered W-row buffer with its rows [d*B, (d+1)*B) of
        timestep t's global tables: global rows into the gathered buffer,
        so nothing is rebased. The tables are a stack built once, on the
        host, for t < ``steps`` (by default the graph's T; an ensemble's
        lockstep T is longer for a member that freezes early), and cut into
        each shard's rows once per build. all_to_all under ``psum_mean``
        (default on) takes the row mean instead (`_halo.global_mean`, see
        the module docstring), then one K3 launch a shard."""
        W, B, T = graph.width, self._block(graph), steps or graph.steps
        kw = self._kernel_kw(graph, combine=self._plan_combine(PLAN_ALLGATHER))
        selfs = self._per_device(lambda dev: tuple(a[None] for a in _self_tables(B, dev)))

        def t0(shards):
            return self._map(lambda d, x: _kops.taskbench_step(x, *selfs[d], **kw), shards)

        if self._psum_mean(graph):
            # every output row gathers the one mean row at weight 1
            i_mean = self._per_device(lambda dev: torch.zeros((1, B, 1), dtype=torch.int32,
                                                              device=dev))
            mesh = self.mesh

            def mean_step(shards, _, t: int):
                means = ([_halo.global_mean(shards[0], W, row_axis=1)] if mesh is None
                         else _halo.global_mean(shards, W, mesh, row_axis=1))
                return self._map(lambda d, m: _kops.taskbench_step(
                    m[:, None], i_mean[d], selfs[d][1], **kw), means)

            return t0, _Phased(None, mean_step)

        tables_at, key_of, time_varying = self._global_table_fn(graph)
        ts = range(1, T) if time_varying and T > 1 else (1,)
        idx, wgt, rows = _stack_tables(tables_at, key_of, [[t] for t in ts], "cpu")
        row_of = dict(zip(ts, rows))
        # each shard's rows of every (1, W, Dt) table, cut once: (keys, 1, B, Dt)
        mine = [tuple(a[:, :, d * B:(d + 1) * B].contiguous().to(dev) for a in (idx, wgt))
                for d, dev in enumerate(self.devices)]
        def compute(shards, fulls, t: int):
            r = row_of[t] if time_varying else 0
            return self._map(lambda d, f: _kops.taskbench_step(
                f, mine[d][0][r], mine[d][1][r], **kw), shards if fulls is None else fulls)

        return t0, _Phased(None if self.mesh is None else self._gather_fn(graph), compute)

    def _plan_shard_fns(self, graph: TaskGraph, plan: str,
                        steps: Optional[int] = None) -> Tuple[Callable, Callable]:
        """(t0, step) of ``plan`` at S = 1 over shard lists, valid for t <
        ``steps`` (default the graph's T); the halo plan's on one device
        only (its sharded run is `_halo_shard_steps`)."""
        if plan == PLAN_HALO:  # one device: the wrap folded into K3
            t0, step = self._halo_step_fns(graph)
            return (lambda shards: [t0(shards[0])]), (lambda shards, t: [step(shards[0], t)])
        if plan == PLAN_STRIDE:
            return self._stride_step_fns(graph)
        return self._allgather_step_fns(graph, steps)

    def _shard_loop(self, t0: Callable, launches: Sequence, launch: Callable) -> Callable:
        """The run of a plan over shard lists: ``t0`` on the initial shards,
        then ``launch(states, item)`` for each of ``launches``. One device:
        (W, P) -> (W, P); D shards: a tuple of (B, P) shards -> a tuple,
        their streams forked from the caller's and joined back."""
        mesh = self.mesh

        def run(init):
            if mesh is None:
                init = (init,)
            else:
                mesh.fork()
            states = t0([x[None] for x in init])
            for item in launches:
                states = launch(states, item)
            if mesh is None:
                return states[0][0]
            mesh.join(states)
            return tuple(s[0] for s in states)

        return run

    def _build_plan_stepper(self, graph: TaskGraph, plan: str) -> Callable:
        """Any plan per step (the halo plan on one device): one K3 launch a
        timestep a shard (and the plan's transfer and glue: the XOR shuffle
        or block exchange, the gather, or all_to_all's row mean)."""
        t0, step = self._plan_shard_fns(graph, plan)
        return self._shard_loop(t0, range(1, graph.steps), step)

    def _build_allgather_blocked(self, graph: TaskGraph, S: int) -> Callable:
        """The blocked all-gather plan's run (`_allgather_blocked_parts`)."""
        t0, L, launch = self._allgather_blocked_parts(graph, S)
        return self._shard_loop(t0, range(L), launch)

    def _allgather_blocked_parts(self, graph: TaskGraph, S: int):
        """(t0, L, launch) of the blocked all-gather plan over shard lists,
        ``launch(states, l)`` a `_Phased` step (None at T = 1): after the
        t = 0 K3 launch a shard,
        ceil((T-1)/S) launches, each the gather (`_gather_fn`) and one K4
        launch a shard on the gathered (1, W, P) buffer, with the S
        timesteps' (1, S, W, D) tables (time-varying: a per-launch stack
        built once on the host, launches with the same key sharing one) or
        the one static (1, W, D) pair; each shard then keeps its own B rows,
        so every shard does all W rows' work, as the reference's does. Every
        row advances exactly; the final launch carries the masked tail. No
        radius is declared: K4 takes its resident form, or the cooperative
        one for the memory body (at D > 1 on one card, D grids at once on
        the shards' streams, each planned for 1/D of the card: ``grids``)."""
        T, B = graph.steps, self._block(graph)
        kw0 = self._kernel_kw(graph, combine=self._plan_combine(PLAN_ALLGATHER))
        kwb = dict(kw0, steps_per_launch=S, grids=self._grids())
        selfs = self._per_device(lambda dev: tuple(a[None] for a in _self_tables(B, dev)))
        acts_np = _act_schedule((T,), T, S)[:, 0]  # (L, S)
        acts = self._per_device(lambda dev: torch.from_numpy(acts_np).to(dev))

        def t0(shards):
            return self._map(lambda d, x: _kops.taskbench_step(x, *selfs[d], **kw0), shards)

        if not len(acts_np):  # T = 1: the body alone
            return t0, 0, None
        tables_at, key_of, time_varying = self._global_table_fn(graph)
        # first timestep of each launch, and its S timesteps
        groups = [[1 + l * S + d for d in range(S)] for l in range(len(acts_np))]
        if not time_varying:
            groups = groups[:1]
        idx, wgt, rows = _stack_tables(tables_at, key_of, groups, "cpu")
        if not time_varying:  # one (1, W, D) pair for every launch
            idx, wgt, rows = idx[:, 0], wgt[:, 0], [0] * len(acts_np)
        tables = self._per_device(lambda dev: (idx.to(dev), wgt.to(dev)))

        def compute(states, fulls, l: int):
            r = rows[l]
            return self._map(lambda d, f: _kops.taskbench_step(
                f, tables[d][0][r:r + 1], tables[d][1][r:r + 1], acts[d][l][None],
                **kwb)[:, d * B:(d + 1) * B], states if fulls is None else fulls)

        move = None if self.mesh is None else self._gather_fn(graph)
        return t0, len(acts_np), _Phased(move, compute)

    # ------------------------------------------------------------ ensembles

    def _ensemble_steps_per_launch(self, ensemble: GraphEnsemble) -> int:
        """One launch cadence for all members (launch boundaries are
        shared), so the most conservative member's resolved depth, at the
        lockstep T: a stacked ensemble resolves once, for its one (K, W)
        launch at the largest radius; a tuple takes the least of its
        members' own depths. A member on the stride or all-gather plan pins
        the cadence to one step a launch (its exchanges are per step)."""
        members = ensemble.members
        if any(self.plan_for(g)[0] != PLAN_HALO for g in members):
            return 1
        if self._is_stacked(ensemble):
            H = max(_patterns.halo_radius(g) for g in members)
            return self._halo_depth(members, H, ensemble.steps)[0]
        return min(self._halo_depth([g], _patterns.halo_radius(g), ensemble.steps)[0]
                   for g in members)

    def stacking_verdict(self, ensemble: GraphEnsemble) -> Tuple[bool, str]:
        """``supports()``-style verdict for the stacked fast path: (ok,
        reason). Stacked launches share one (K, W, ...) operand set built by
        the halo-plan machinery, so they require uniform (width, payload),
        one kernel, and every member on the halo plan; anything else takes
        the per-member tuple path. The reason names each requirement that
        failed, as the reference's does."""
        members = ensemble.members
        reasons = []
        if not ensemble.stackable:
            widths = sorted({g.width for g in members})
            payloads = sorted({g.payload for g in members})
            reasons.append(
                f"members do not stack into one (K, W, payload) state: "
                f"widths {widths}, payloads {payloads}")
        kernels = {g.kernel for g in members}
        if len(kernels) != 1:
            reasons.append("mixed kernels: " + ", ".join(sorted(
                f"{k.kind}@it{k.iterations}" for k in kernels)))
        off_plan = []
        for i, g in enumerate(members):
            plan, _ = self.plan_for(g)
            if plan != PLAN_HALO:
                off_plan.append(
                    f"member {i} ({g.pattern}) resolves the "
                    f"{plan or 'un-supported'} plan")
        if off_plan:
            reasons.append(
                "stacked operands are built by the halo-plan machinery: "
                + "; ".join(off_plan))
        if reasons:
            return False, "; ".join(reasons)
        return True, ("stacked: uniform (width, payload, kernel) and "
                      "every member on the halo plan")

    def _is_stacked(self, ensemble: GraphEnsemble) -> bool:
        return self.stacking_verdict(ensemble)[0]

    def _member_shards(self, ensemble: GraphEnsemble) -> int:
        """Dk, the member slices of a stacked ensemble (the ``member_shards``
        option; default 1, the 1D row mesh): "auto" (or 0, "0") asks
        `schedule.choose_member_shards` to price the (Dr, Dk) split under
        this runtime's cost model. An explicit Dk that does not divide K,
        or the device count, is refused loudly, with the reference's
        words."""
        raw = self.options.get("member_shards", 1)
        K, D = len(ensemble.members), self.num_devices
        if _schedule.is_auto(raw):
            return self._auto_member_shards(ensemble)[0]
        dk = int(raw)
        if dk < 1:
            raise ValueError(f"member_shards must be >= 1, got {dk}")
        if dk == 1:
            return 1
        if K % dk:
            raise ValueError(
                f"member_shards={dk} does not divide this ensemble's "
                f"K={K} members — each member-axis shard needs an equal "
                f"K/Dk slice of the stacked (K, B, payload) state. Pass "
                f"member_shards=1 (or a divisor of {K}) to fall back to "
                f"the replicated 1D row mesh.")
        if D % dk:
            make_row_member_mesh(self.devices, dk)  # raises, naming the fallback
        return dk

    def _auto_member_shards(self, ensemble: GraphEnsemble) -> Tuple[int, str]:
        """(Dk, reason) of ``member_shards="auto"`` for a stacked ensemble
        (`schedule.choose_member_shards` at the ensemble's launch depth and
        largest radius)."""
        g = ensemble.members[0]
        return _schedule.choose_member_shards(
            devices=self.num_devices, num_members=len(ensemble.members), width=g.width,
            steps_per_launch=self._ensemble_steps_per_launch(ensemble),
            radius=max(_patterns.halo_radius(m) for m in ensemble.members),
            model=self._cost_model(g.payload))

    def _member_devices(self, ensemble: GraphEnsemble) -> List[List[torch.device]]:
        """At Dk > 1 member k's rows live on its ring's Dr devices only (the
        ring of member slice k // (K/Dk)); otherwise on every row shard."""
        if self.mesh is None or not self._is_stacked(ensemble):
            return super()._member_devices(ensemble)
        dk = self._member_shards(ensemble)
        rings = self._row_member_mesh(dk).rings
        kj = len(ensemble.members) // dk
        return [list(rings[k // kj].devices) for k in range(len(ensemble.members))]

    def _stacked_operands(self, ensemble: GraphEnsemble, H: int, blocked: bool):
        """The members' (idx, wgt, idx0, wgt0) at the shared halo H, stacked
        (`_stack_operands`) and moved to the device."""
        build = self._blocked_operands if blocked else self._operands
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in _stack_operands([build(g, H) for g in ensemble.members]))

    def _build_ensemble_eager(self, ensemble: GraphEnsemble) -> Callable:
        S = self._ensemble_steps_per_launch(ensemble)
        if self._is_stacked(ensemble):
            dk = self._member_shards(ensemble)
            if self.mesh is not None:
                return self._sharded_stacked_run(ensemble.members, S, dk)
            if S > 1:
                return self._build_ensemble_stacked_blocked(ensemble, S)
            return self._build_ensemble_stacked(ensemble)
        self._record_stacking_degradation(ensemble, S, "tuple")
        if S > 1:
            return self._build_ensemble_tuple_blocked(ensemble, S)
        return self._build_ensemble_tuple(ensemble)

    def _record_stacking_degradation(self, ensemble: GraphEnsemble, S: int,
                                     plan_kind: str) -> None:
        """The decision record of a multi-member ensemble off the stacked
        path (the tuple fallback, the stepwise launch plan): one
        ``schedule.resolve`` instant naming the failed requirement
        (`stacking_verdict`'s reason), the reference's record. Nothing with
        tracing off."""
        if len(ensemble.members) <= 1 or not self.tracer.enabled:
            return
        ok, why = self.stacking_verdict(ensemble)
        if ok:
            return
        _schedule.record_resolution(
            self.tracer, plan=plan_kind, steps_per_launch=S, pipeline=False,
            model=self._cost_model(ensemble.members[0].payload),
            reason=f"ensemble off the stacked fast path: {why}", runtime=self.name,
            members=len(ensemble.members), stacked=False)

    def _build_ensemble_stacked(self, ensemble: GraphEnsemble) -> Callable:
        """All K members' combines and bodies in one K3 launch a timestep,
        on the (K, W, payload) state with the wrap folded in at H, the
        largest radius; the t = 0 launch on the stacked (K, W, 1) self
        operands. With mixed horizons a member past its own T keeps its
        state (``torch.where`` on a slice of a static table)."""
        T = ensemble.steps
        t0, step = self._stacked_step_fns(ensemble)
        live = (torch.from_numpy(ensemble.active_table()[:, :, None, None]).to(self.device)
                if ensemble.heterogeneous_steps else None)

        def run(inits):
            state = t0(inits)
            for t in range(1, T):
                state = step(state, None if live is None else live[t])
            return state.unbind(0)

        return run

    def _stacked_step_fns(self, ensemble: GraphEnsemble):
        """The stacked S = 1 (t0, step) fns: ``t0(inits, slots)`` is the
        t = 0 K3 on the stacked self operands of the members ``slots`` (all
        by default); ``step(state, live)`` one K3 for all K
        members with the wrap folded in at H, the largest radius, and, when
        ``live`` is a (K, 1, 1) bool, a member that is not live keeps its
        state (``torch.where``)."""
        members = ensemble.members
        H = max(_patterns.halo_radius(g) for g in members)
        kw = self._kernel_kw(members[0])
        idx, wgt, idx0, wgt0 = self._stacked_operands(ensemble, H, blocked=False)

        def t0(inits, slots=slice(None)):
            return _kops.taskbench_step(torch.stack(tuple(inits)), idx0[slots], wgt0[slots],
                                        **kw)

        def step(state, live=None):
            nxt = _kops.taskbench_step(state, idx, wgt, wrap=H, **kw)
            return nxt if live is None else torch.where(live, nxt, state)

        return t0, step

    def _build_ensemble_stacked_blocked(self, ensemble: GraphEnsemble, S: int) -> Callable:
        """All K members share each blocked launch (two when pipelined: one
        boundary launch for both edges of every member, one interior
        launch), K4 with ``radius=H`` and member k's act row freezing it at
        its own horizon."""
        members = ensemble.members
        W, T = members[0].width, ensemble.steps
        H = max(_patterns.halo_radius(g) for g in members)
        kw0 = self._kernel_kw(members[0])
        kwb = dict(kw0, steps_per_launch=S, radius=H)
        idx, wgt, idx0, wgt0 = self._stacked_operands(ensemble, H, blocked=True)
        acts = torch.from_numpy(
            _act_schedule(ensemble.member_steps, T, S)).to(self.device)  # (L, K, S)
        begin, launch, _ = self._blocked_launches(
            idx, wgt, W, S, H, kwb, self._pipeline_active(W, S, H, members[0].payload))

        def run(inits):
            carry = begin(_kops.taskbench_step(torch.stack(inits), idx0, wgt0, **kw0))
            for a in acts:
                carry = launch(carry, a)
            return carry[0].unbind(0)

        return run

    def _shard_list(self, x) -> List[torch.Tensor]:
        """A member's state as a list of (1, B, payload) shards: on one
        device [the (1, W, payload) state]; over D shards its shard tuple,
        or a global state split first."""
        if self.mesh is None:
            return [x[None]]
        if isinstance(x, torch.Tensor):
            x = self._split(x)
        return [s[None] for s in x]

    def _member_out(self, shards: Sequence[torch.Tensor], gather: bool = False):
        """The inverse of `_shard_list`: one device's state, or the shard
        tuple (``gather``: the global state)."""
        if self.mesh is None:
            return shards[0][0]
        out = tuple(s[0] for s in shards)
        return self._gather(out) if gather else out

    @staticmethod
    def _issued(mesh, fn: Callable, mark: bool = False):
        """``fn()`` with the shards' streams of ``mesh`` (a `ShardMesh` or a
        `RowMemberMesh`; None on one device) forked from the caller's
        stream before it and joined back after it; ``mark``: ``fn`` gives
        states over the shards (a list of shard lists), which the join marks
        as used on the caller's stream."""
        if mesh is None:
            return fn()
        mesh.fork()
        out = fn()
        mesh.join(*(out if mark else ()))
        return out

    def _member_fns(self, graph: TaskGraph, steps: int) -> Tuple[Callable, Callable, Callable]:
        """(t0, step, states) of one tuple member, one step a launch, over
        shard lists (`_shard_list`) valid for t < ``steps``: ``step(carry,
        t)``. A halo member over D shards runs the stacked pair at K = 1
        (`_halo_shard_steps`), its carry the pair's; any other member its
        plan's (t0, step) (`_plan_shard_fns`), its carry the shard list."""
        plan = self.plan_for(graph)[0]
        if plan == PLAN_HALO and self.mesh is not None:
            pair = self._halo_shard_steps([graph], 1, self.mesh, steps)
            return pair.t0, (lambda carry, t: pair.launch(carry)), pair.states
        t0, step = self._plan_shard_fns(graph, plan, steps)
        return t0, step, (lambda carry: carry)

    def _build_ensemble_tuple(self, ensemble: GraphEnsemble) -> Callable:
        """Mixed specs, shapes or plans, one step a launch: every member's
        (t0, step) of its own plan over its own shards (`_member_fns`; B_k
        = W_k / D), each member launched every lockstep step. A frozen
        member is launched too (the reference's accounting) and its output
        dropped on the host: t is a host int."""
        members, T, mesh = ensemble.members, ensemble.steps, self.mesh
        fns = [self._member_fns(g, T) for g in members]

        def run(inits):
            def issue():
                carries = [t0(self._shard_list(x)) for (t0, _, _), x in zip(fns, inits)]
                for t in range(1, T):
                    for k, (g, (_, step, _)) in enumerate(zip(members, fns)):
                        nxt = step(carries[k], t)
                        if t < g.steps:
                            carries[k] = nxt
                return [states(c) for (_, _, states), c in zip(fns, carries)]

            return tuple(self._member_out(f) for f in self._issued(mesh, issue, mark=True))

        return run

    def _member_blocked(self, graph: TaskGraph, S: int, steps: int):
        """(t0, launch, states) of one halo member's blocked launches over
        shard lists, under the member's own pipeline gate: ``launch(carry,
        a)`` with ``a`` each shard's (1, S) act rows. Over D shards the
        stacked pair at K = 1; on one device `_blocked_launches` after the
        t = 0 K3 launch."""
        h = _patterns.halo_radius(graph)
        if self.mesh is not None:
            pair = self._halo_shard_steps([graph], S, self.mesh, steps)
            return pair.t0, pair.launch, pair.states
        kw0 = self._kernel_kw(graph)
        idx, wgt, idx0, wgt0 = (torch.from_numpy(a)[None].to(self.device)
                                for a in self._blocked_operands(graph, h))
        begin, launch, _ = self._blocked_launches(
            idx, wgt, graph.width, S, h, dict(kw0, steps_per_launch=S, radius=h),
            self._pipeline_active(graph.width, S, h, graph.payload))
        return ((lambda shards: begin(_kops.taskbench_step(shards[0], idx0, wgt0, **kw0))),
                (lambda carry, a: launch(carry, a[0])), (lambda carry: [carry[0]]))

    def _build_ensemble_tuple_blocked(self, ensemble: GraphEnsemble, S: int) -> Callable:
        """Mixed specs or shapes, every member on the halo plan, blocked:
        one S-step launch per member per lockstep launch (the cadence and
        the act schedule shared), each member serial or pipelined by its
        own gate (one with no interior at depth S * h_k stays serial)."""
        members, T, mesh = ensemble.members, ensemble.steps, self.mesh
        acts_np = _act_schedule(ensemble.member_steps, T, S)  # (L, K, S)
        acts = self._per_device(lambda dev: torch.from_numpy(acts_np).to(dev))
        runners = [self._member_blocked(g, S, T) for g in members]

        def run(inits):
            def issue():
                carries = [t0(self._shard_list(x)) for (t0, _, _), x in zip(runners, inits)]
                for l in range(acts[0].shape[0]):
                    for k, (_, launch, _) in enumerate(runners):
                        carries[k] = launch(carries[k], [a[l, k:k + 1] for a in acts])
                return [states(c) for (_, _, states), c in zip(runners, carries)]

            return tuple(self._member_out(f) for f in self._issued(mesh, issue, mark=True))

        return run

    # ----------------------------------------------------------- launch plans

    def build_ensemble_launches(self, ensemble: GraphEnsemble) -> EnsembleLaunchPlan:
        """The ensemble's launch structure, stepped from the host: a
        stacked ensemble keeps its blocked cadence on the serial schedule
        (equal to the pipelined one bit for bit), over D shards on its
        (row, member) mesh; any other runs the tuple path's step fns one
        step a launch. Each launch is a deterministic
        function of (carry, act row). ``expected_launch_us`` is the cost
        model's wall of one launch (`schedule.expected_launch_wall_us` over
        K x W rows, or the members' rows summed at S = 1): a number under a
        measured model, None under the analytic one."""
        self._require_ensemble_support(ensemble)
        if self._is_stacked(ensemble):
            S = self._ensemble_steps_per_launch(ensemble)
            dk = self._member_shards(ensemble)
            if self.mesh is not None:
                return self._launch_plan_stacked_sharded(ensemble, S, dk)
            return self._launch_plan_stacked(ensemble, S)
        self._record_stacking_degradation(ensemble, 1, "stepwise")
        return self._launch_plan_stepwise(ensemble)

    def _launch_plan_stacked(self, ensemble: GraphEnsemble, S: int) -> EnsembleLaunchPlan:
        """Host-stepped twin of the stacked builds: the same kernels,
        operands and act predicate. At S = 1 a launch is one K3 step and a
        ``torch.where`` on act row column 0 (member k runs while it is 1);
        at S > 1 one serial K4 launch. On the card the launch is captured
        once, over a static carry and a static act row, and each call
        stages both and replays it, so editing ``acts`` or admitting a
        member captures nothing. ``admit_fn`` runs the t = 0 K3 on the new
        init and writes its rows into the carry's slot, in place."""
        members = ensemble.members
        K, B, P, T = len(members), members[0].width, members[0].payload, ensemble.steps
        first, step = self._stacked_step_fns(ensemble)
        if S > 1:
            H = max(_patterns.halo_radius(g) for g in members)
            idx, wgt, _, _ = self._stacked_operands(ensemble, H, blocked=True)
            blocked = self._blocked_launches(
                idx, wgt, B, S, H, dict(self._kernel_kw(members[0]), steps_per_launch=S,
                                        radius=H), False)

            def launch(xs):
                s, a = xs
                return blocked.launch((s,), a)[0]
        else:
            def launch(xs):
                s, a = xs
                return step(s, a[:, :1, None] > 0)

        dev = self.device
        graphed = (GraphRun(launch, (torch.zeros((K, B, P), device=dev),
                                     torch.zeros((K, S), device=dev)))
                   if dev.type == "cuda" else None)

        def launch_fn(carry, act_row, t0):
            del t0  # the stacked halo tables are time-invariant
            a = _act_row(act_row)
            if graphed is None:
                return launch((carry, a.to(dev)))
            return graphed((carry, a))

        def admit_fn(carry, slot, init):
            carry[slot].copy_(first((init,), slice(slot, slot + 1))[0])
            return carry

        return EnsembleLaunchPlan(
            steps_per_launch=S, member_steps=tuple(ensemble.member_steps),
            acts=_act_schedule(ensemble.member_steps, T, S), init_fn=first,
            launch_fn=launch_fn, finalize=lambda carry: carry.unbind(0),
            admit_fn=admit_fn,
            expected_launch_us=_schedule.expected_launch_wall_us(
                rows=K * B, steps_per_launch=S, model=self._cost_model(P),
                impl=self._exchange_impl()),
            kind="stacked", compile_counter=lambda: _build.CAPTURES["graphs"],
            act_device=dev, replayed=graphed is not None)

    def _launch_plan_stacked_sharded(self, ensemble: GraphEnsemble, S: int,
                                     dk: int) -> EnsembleLaunchPlan:
        """The stacked launch plan over D row shards: member slice j on ring
        j of the (row, member) mesh of ``dk`` slices, each ring's launch
        the serial schedule of `_halo_shard_steps` (at S = 1 one K3 step, a
        member taking it while its act row's column 0 is 1). On one card the
        launch over every ring is captured once, over static shard carries
        and a static act row, and each call stages both and replays it, so
        editing ``acts`` or admitting a member captures nothing; each ring
        reads its members' rows of the act row. ``admit_fn`` writes the t =
        0 K3 of the fresh member's rows into its slot, on the member slice
        that owns the slot only, in place. The plan takes and gives global
        (W, payload) states."""
        members = ensemble.members
        K, W, P, T = len(members), members[0].width, members[0].payload, ensemble.steps
        sl = self._member_slices(members, S, dk, T, pipelined=False)
        rings = sl.mesh.rings

        def launch(xs):
            carries, a = xs
            if S == 1:
                a = a[:, :1, None] > 0
            items = sl.split(a)  # each ring's rows of the act row, before the fork
            return self._issued(sl.mesh, lambda: sl.launch(carries, items))

        def init_fn(inits):
            cols = [self._split(x, rings[k // sl.kj].devices) for k, x in enumerate(inits)]
            return self._issued(sl.mesh, lambda: sl.t0(cols))

        dev = self.device
        graphed = None
        if dev.type == "cuda" and self.mesh.one_card:
            with _build.building():  # a static carry: the t = 0 launch on zeros
                example = init_fn([torch.zeros((W, P), device=dev) for _ in members])
            graphed = GraphRun(launch, (example, torch.zeros((K, S), device=dev)))

        def launch_fn(carry, act_row, t0):
            del t0  # the stacked halo tables are time-invariant
            a = _act_row(act_row)
            if graphed is None:
                return launch((carry, a.to(dev)))
            return graphed((carry, a))

        def finalize(carry):
            return tuple(self._gather(shards) for shards in sl.members(sl.states(carry)))

        return EnsembleLaunchPlan(
            steps_per_launch=S, member_steps=tuple(ensemble.member_steps),
            acts=_act_schedule(ensemble.member_steps, T, S), init_fn=init_fn,
            launch_fn=launch_fn, finalize=finalize, admit_fn=sl.admit,
            expected_launch_us=_schedule.expected_launch_wall_us(
                rows=sl.kj * (W // rings[0].size), steps_per_launch=S,
                model=self._cost_model(P),
                impl=self._exchange_impl()),
            kind="stacked", compile_counter=lambda: _build.CAPTURES["graphs"],
            act_device=dev, replayed=graphed is not None)

    def _launch_plan_stepwise(self, ensemble: GraphEnsemble) -> EnsembleLaunchPlan:
        """One step a launch for mixed ensembles: the tuple path's member
        fns (`_member_fns`), issued eagerly from the host at each launch (t
        picks each member's branch or table slice), every member launched
        and a frozen one's output dropped by its act row, so eviction is the
        same edit of ``acts`` as for the stacked plan. Nothing is captured.
        The plan takes and gives global (W, payload) states."""
        members, T, mesh = ensemble.members, ensemble.steps, self.mesh
        fns = [self._member_fns(g, T) for g in members]

        def init_fn(inits):
            shards = [self._shard_list(x) for x in inits]  # split before the fork
            return self._issued(mesh, lambda: tuple(
                t0(x) for (t0, _, _), x in zip(fns, shards)))

        def launch_fn(carry, act_row, t0):
            act = np.asarray(act_row)

            def issue():
                out = []
                for k, (c, (_, step, _)) in enumerate(zip(carry, fns)):
                    nxt = step(c, t0)  # launched also when frozen
                    out.append(nxt if act[k, 0] > 0 else c)
                return tuple(out)

            return self._issued(mesh, issue)

        def admit_fn(carry, slot, init):
            out = list(carry)
            shards = self._shard_list(init)  # split before the fork
            out[slot] = self._issued(mesh, lambda: fns[slot][0](shards))
            return tuple(out)

        return EnsembleLaunchPlan(
            steps_per_launch=1, member_steps=tuple(ensemble.member_steps),
            acts=_act_schedule(ensemble.member_steps, T, 1), init_fn=init_fn,
            launch_fn=launch_fn,
            finalize=lambda carry: tuple(self._member_out(states(c), gather=True)
                                         for (_, _, states), c in zip(fns, carry)),
            admit_fn=admit_fn,
            expected_launch_us=_schedule.expected_launch_wall_us(
                rows=sum(self._block(g) for g in members), steps_per_launch=1,
                model=self._cost_model(members[0].payload), impl=self._exchange_impl()),
            kind="stepwise", compile_counter=lambda: _build.CAPTURES["graphs"])

    # ------------------------------------------------------------- tracing
    #
    # The traced twin (`Runtime.trace_once`) runs each schedule from the
    # host with a device synchronize at the end of every span (at D > 1 on
    # every shard's device), so span boundaries exist: the production run
    # is one CUDA graph replay, opaque to host timing. It is built from the
    # eager pieces, never from a captured run. Two rules carry over from the
    # reference:
    #
    #   1. it computes what production computes: the same operands, kernels
    #      and transports (the production step is the composition of the
    #      `_Phased` move and compute the twin times apart), only the loop
    #      stepped from the host; on the card its output equals the replay's
    #      bit for bit;
    #   2. the pipelined launch stays one unit: its boundary K4, edge
    #      exchange and interior K4 run concurrently, so timing them apart
    #      would serialize the overlap being measured. The launch is one
    #      "launch" span and its phases are priced by separate probes
    #      (``probe.boundary``, ``probe.exchange``, ``probe.interior``: R =
    #      ``trace_probe_reps`` loop-carried repetitions each, after the
    #      launch loop), from which `obs.decompose` splits each launch wall
    #      and derives the overlap verdict.
    #
    # The port records the operations it performs. On one device no rows
    # move between shards, so where the one-device form moves none there is
    # no transport span: the S = 1 step (the wrap folded into K3), the
    # pipelined prologue and edge exchange (views of the state; so no
    # exchange probe, and the verdict says "unavailable") and the gather
    # (the state itself). The serial schedule's deep wrap is a row gather,
    # and keeps its ``deep_exchange`` span. The extended tables are cut once
    # per build, so no run records the reference's ``table_exchange``.

    def _record_schedule(self, graph: TaskGraph, plan: _ResolvedPlan,
                         pipelined: bool) -> None:
        _schedule.record_resolution(
            self.tracer, plan=plan.kind, steps_per_launch=plan.steps_per_launch,
            pipeline=pipelined, model=self._cost_model(graph.payload), reason=plan.reason,
            runtime=self.name, pattern=graph.pattern, width=graph.width,
            launches=self._launches(graph.steps, plan.steps_per_launch))

    def _build_traced(self, graph: TaskGraph) -> Callable:
        """The traced twin of `_build_eager`'s run, over the same input (the
        state, or at D > 1 its shard tuple), chosen among the plan paths as
        `_build_eager` chooses; the schedule's decision record first."""
        self._require_support(graph)
        plan = self._schedule_for_graph(graph)
        S = plan.steps_per_launch
        pipelined = plan.kind == PLAN_HALO and S > 1 and self._pipeline_active(
            self._block(graph), S, _patterns.halo_radius(graph), graph.payload)
        self._record_schedule(graph, plan, pipelined)
        if plan.kind == PLAN_STRIDE:
            return self._trace_stride_steps(graph)
        if plan.kind == PLAN_ALLGATHER:
            if S > 1:
                return self._trace_allgather_blocked(graph, S)
            return self._trace_allgather_steps(graph)
        if self.mesh is not None:
            return self._trace_halo_shards(graph, S, pipelined)
        if S > 1:
            return self._trace_blocked(graph, S, pipelined)
        return self._trace_halo_steps(graph)

    @contextlib.contextmanager
    def _phase(self, name: str, category: str, **attrs):
        """A span that ends once the work issued inside it has finished."""
        with self.tracer.span(name, category, **attrs):
            yield
            self._drain()

    def _trace_t0(self, t0: Callable, x):
        """The t = 0 launch: ``t0_launch`` (dispatch) while the host issues
        it, ``t0_kernel`` (compute.interior) while the device finishes it."""
        with self.tracer.span("t0_launch", "dispatch", step=0):
            st = t0(x)
        with self.tracer.span("t0_kernel", "compute.interior", step=0):
            self._drain()
        return st

    def _trace_steps(self, t0: Callable, items: Sequence, phased_at: Callable,
                     kernel: str, move: Optional[str], attrs_at: Callable) -> Callable:
        """The traced twin of a `_shard_loop` run: the t = 0 launch, then for
        each of ``items`` the `_Phased` step ``phased_at(item)``: its move,
        where rows move, as the transport's span ``move`` (the transport
        records it, joined and drained), and its compute as the span
        ``kernel`` (category gather where the name says so, else
        compute.interior), each with ``attrs_at(item)``."""
        tr, mesh = self.tracer, self.mesh
        category = "gather" if "gather" in kernel else "compute.interior"

        def run(init):
            if mesh is None:
                init = (init,)
            else:
                mesh.fork()
            st = self._trace_t0(t0, [x[None] for x in init])
            for item in items:
                step, attrs = phased_at(item), attrs_at(item)
                moved = None if step.move is None else step.move(
                    st, tracer=tr, span=dict(attrs, name=move))
                with self._phase(kernel, category, **attrs):
                    st = step.compute(st, moved, item)
            if mesh is None:
                return st[0][0]
            mesh.join(st)
            return tuple(s[0] for s in st)

        return run

    def _trace_halo_steps(self, graph: TaskGraph) -> Callable:
        """One device, S = 1: a ``megakernel`` span a step, the K3 launch
        with the halo wrap folded in (no exchange span: no rows move)."""
        t0, step = self._plan_shard_fns(graph, PLAN_HALO)
        phased = _Phased(None, lambda shards, _, t: step(shards, t))
        return self._trace_steps(t0, range(1, graph.steps), lambda t: phased, "megakernel",
                                 None, lambda t: dict(step=t, pattern=graph.pattern))

    def _trace_stride_steps(self, graph: TaskGraph) -> Callable:
        """The stride plan: a step's stride picks, on the host, an in-block
        XOR shuffle (in the ``stride_kernel`` span) or, at D > 1, a block
        exchange (its ``stride_exchange`` span), then the K3 span."""
        t0, branch_at = self._stride_branches(graph)
        strides, period = _patterns.butterfly_slot_strides(graph), graph.period
        return self._trace_steps(t0, range(1, graph.steps), branch_at, "stride_kernel",
                                 "stride_exchange",
                                 lambda t: dict(step=t, stride=strides[(t - 1) % period]))

    def _trace_allgather_steps(self, graph: TaskGraph) -> Callable:
        """The per-step all-gather plan: at D > 1 a ``gather_global`` span
        (the transport) and a ``global_kernel`` span a step; on one device
        the kernel span alone. all_to_all under ``psum_mean``: one
        ``gather_psum_mean`` span a step (category gather), the row mean and
        its K3 launch, as the reference records its reduction step."""
        t0, step = self._allgather_step_fns(graph)
        W = graph.width
        if self._psum_mean(graph):
            return self._trace_steps(t0, range(1, graph.steps), lambda t: step,
                                     "gather_psum_mean", None,
                                     lambda t: dict(step=t, width=W, impl="psum"))
        return self._trace_steps(t0, range(1, graph.steps), lambda t: step, "global_kernel",
                                 "gather_global", lambda t: dict(step=t, width=W))

    def _trace_allgather_blocked(self, graph: TaskGraph, S: int) -> Callable:
        """The blocked all-gather plan: a launch's ``gather_global`` span
        (D > 1) and its ``blocked_global_kernel`` span, K4 on the gathered
        state."""
        t0, L, launch = self._allgather_blocked_parts(graph, S)
        return self._trace_steps(t0, range(L), lambda l: launch, "blocked_global_kernel",
                                 "gather_global",
                                 lambda l: dict(launch=l, steps_per_launch=S,
                                                width=graph.width))

    def _trace_blocked(self, graph: TaskGraph, S: int, pipelined: bool) -> Callable:
        """The halo plan's blocked schedules on one device. Serial: per
        launch the deep wrap (``deep_exchange``) and the K4 launch
        (``blocked_kernel``), the pair the pipelined schedule exists to
        break. Pipelined: per launch one ``pipelined_launch`` span (category
        launch: the boundary and interior K4), then the boundary and
        interior probes (`_trace_probes`; the self-wrap moves no rows, so
        there is no exchange probe)."""
        t0, acts, blk, kwb = self._blocked_parts(graph, S)
        depth = S * _patterns.halo_radius(graph)
        tr, impl = self.tracer, self._exchange_impl()

        def run(init):
            carry = blk.begin(self._trace_t0(t0, init[None]))
            for l, a in enumerate(acts):
                if pipelined:
                    with self._phase("pipelined_launch", "launch", launch=l,
                                     steps_per_launch=S, impl=impl, depth=depth,
                                     kernel_launches=2):
                        carry = blk.launch(carry, a)
                    continue
                step = blk.launch
                moved = None if step.move is None else step.move(
                    carry, tracer=tr, span=dict(launch=l))
                with self._phase("blocked_kernel", "compute.interior", launch=l,
                                 steps_per_launch=S):
                    carry = step.compute(carry, moved, a)
            if pipelined and len(acts):
                s, hl, hr = carry
                self._trace_probes([s], [hl], [hr], [acts[0]], [blk.phases], depth, kwb, impl)
            return carry[0][0]

        return run

    def _trace_halo_shards(self, graph: TaskGraph, S: int, pipelined: bool) -> Callable:
        """The halo plan over D row shards (`_halo_shard_steps`, the run
        `_sharded_stacked_run` makes for one graph). Each span covers a
        phase across every shard: it ends when every shard's device has
        finished it. S = 1: per step the ring exchange (``halo_exchange``,
        the transport's span) and the K3 launch a shard (``megakernel``).
        Serial: per launch the deep exchange (``deep_exchange``) and the K4
        launch a shard, on the buffer it extends (``blocked_kernel``).
        Pipelined: the prologue exchange (``prologue_exchange``), a
        ``pipelined_launch`` span a launch (the boundary K4, the next edge
        exchange started on its outputs, the interior K4 under it), then
        the exchange, boundary and interior probes (`_trace_probes`)."""
        T, H, mesh, tr = graph.steps, _patterns.halo_radius(graph), self.mesh, self.tracer
        steps = self._halo_shard_steps([graph], S, mesh)
        depth, impl = S * H, self._halo_impl()
        if S == 1:
            items: List = [None] * (T - 1)
        else:
            live = _act_schedule((T,), T, S)  # (L, 1, S)
            acts = self._per_device(lambda dev: torch.from_numpy(live).to(dev))
            items = [[a[l] for a in acts] for l in range(live.shape[0])]

        def run(shards):
            mesh.fork()
            carry = self._trace_t0(steps.body, self._map(lambda d, x: x[None], shards))
            if steps.prologue is not None:
                carry = steps.prologue(carry, tracer=tr,
                                       span=dict(name="prologue_exchange", setup=True))
            for l, item in enumerate(items):
                key = dict(step=l + 1) if S == 1 else dict(launch=l, steps_per_launch=S)
                if pipelined:
                    with self._phase("pipelined_launch", "launch", impl=impl, depth=depth,
                                     kernel_launches=2, **key):
                        carry = steps.launch(carry, item)
                    continue
                step = steps.launch
                moved = None if step.move is None else step.move(
                    carry, tracer=tr,
                    span=dict(key, name="halo_exchange" if S == 1 else "deep_exchange"))
                with self._phase("megakernel" if S == 1 else "blocked_kernel",
                                 "compute.interior", **key):
                    carry = step.compute(carry, moved, item)
            if pipelined and items:
                lefts, rights = carry[1].join()
                self._trace_probes(carry[0], lefts, rights, items[0], steps.phases, depth,
                                   dict(self._kernel_kw(graph), steps_per_launch=S, radius=H),
                                   impl)
            finals = steps.states(carry)
            mesh.join(finals)
            return tuple(s[0] for s in finals)

        return run

    def _trace_probes(self, states: Sequence[torch.Tensor], lefts, rights, act,
                      phases: Sequence[_PhaseTables], depth: int, kwb: dict,
                      impl: str) -> None:
        """The pipelined launch's phase probes, after the launch loop, over
        the shards' final states, halos received and first act rows: at D >
        1 ``probe.exchange`` (the edge exchange's start and join, at the
        launch's depth, over ``halo_impl``), then ``probe.boundary`` (the
        boundary K4 on both edge buffers) and ``probe.interior`` (the
        interior K4 on the block). Each is R = ``trace_probe_reps`` (16)
        repetitions whose outputs feed the next one's inputs, so no
        repetition can be skipped or hoisted, timed as the best of 2
        (`probes.time_best_us`: on the card each R-repetition chain one CUDA
        graph replay between CUDA events), and recorded with ``probe=True``,
        its ``phase`` and ``per_launch_us``, the best over R."""
        R = int(self.options.get("trace_probe_reps", 16))
        mesh, tr, B = self.mesh, self.tracer, states[0].shape[1]

        def chained(step, carry):
            def thunk():
                if mesh is not None:
                    mesh.fork()
                c = carry
                for _ in range(R):
                    c = step(c)
                if mesh is not None:
                    mesh.join()
                return c

            return thunk

        def exchange(c):
            return _halo.exchange_edges_start(mesh, c[0], c[1], row_axis=1, impl=impl).join()

        def boundary(c):
            out = []
            for d, (bl, br) in enumerate(c):
                with self._on(d):
                    lo, ro = _kops.taskbench_boundary(bl, br, phases[d].i_bnd, phases[d].w_bnd,
                                                      act[d], depth=depth, **kwb)
                    out.append((torch.cat([lo, ro, lo], dim=1), torch.cat([ro, lo, ro], dim=1)))
            return out

        def interior(c):
            out = []
            for d, s in enumerate(c):
                with self._on(d):
                    mid = _interior_launch(s, act[d], phases[d], depth, kwb)
                    out.append(torch.cat([s[:, :depth], mid, s[:, B - depth:]], dim=1))
            return out

        edges = [(torch.cat([hl, s[:, :2 * depth]], dim=1),
                  torch.cat([s[:, B - 2 * depth:], hr], dim=1))
                 for s, hl, hr in zip(states, lefts, rights)]
        self._drain()
        probes = [("boundary", "compute.boundary", chained(boundary, edges)),
                  ("interior", "compute.interior", chained(interior, list(states)))]
        if mesh is not None:
            probes.insert(0, ("exchange", "exchange",
                              chained(exchange, (list(lefts), list(rights)))))
        for phase, category, thunk in probes:
            start = tr.now_us()
            best = _probes.time_best_us(thunk, self.device, reps=2)
            tr.add(f"probe.{phase}", category, start, tr.now_us(), probe=True, phase=phase,
                   per_launch_us=best / R, reps=R, impl=impl, depth=depth)

    # ---------------------------------------------------------- accounting

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Kernel launches of one run, as `_schedule_for_graph` resolves it:
        the t = 0 launch plus ceil((T-1)/S) launches (S = 1: T in all, each
        one K3 launch). The halo plan's pipelined schedule splits every
        blocked launch into a boundary and an interior launch. The stride
        plan is per step (T K3 launches); so is the per-step all-gather
        plan; the blocked all-gather plan is 1 K3 + ceil((T-1)/S) K4.
        Glue is not counted: at halo > 0 each serial blocked launch also
        issues the deep halo wrap (a row gather of the state) and each
        pipelined launch three concatenations; a stride step with ``pair``
        also issues the XOR shuffle's flip and the concatenation, and
        all_to_all's row mean a sum and a division."""
        plan = self._schedule_for_graph(graph)
        L = self._launches(graph.steps, plan.steps_per_launch)
        if plan.kind == PLAN_HALO and self._pipeline_active(
                self._block(graph), plan.steps_per_launch, _patterns.halo_radius(graph),
                graph.payload):
            return 1 + 2 * (L - 1)
        return L

    def ensemble_dispatches_per_run(self, ensemble: GraphEnsemble) -> int:
        """Kernel launches of one ensemble run. A stacked ensemble launches
        once for all K members: the t = 0 launch plus ceil((T-1)/S), two a
        blocked launch when pipelined (the boundary launch covers both
        edges of every member). A tuple ensemble launches every member at
        every lockstep launch, frozen members included, so it pays each
        member's own count at the shared cadence, summed; glue is not
        counted, as in `dispatches_per_run`."""
        S = self._ensemble_steps_per_launch(ensemble)
        L = self._launches(ensemble.steps, S)
        members = ensemble.members
        if self._is_stacked(ensemble):
            H = max(_patterns.halo_radius(g) for g in members)
            dk = self._member_shards(ensemble) if self.mesh is not None else 1
            B = members[0].width // (self.num_devices // dk)
            piped = self._pipeline_active(B, S, H, members[0].payload)
            return 1 + (2 if piped else 1) * (L - 1)
        return sum(
            1 + (2 if self._pipeline_active(self._block(g), S, _patterns.halo_radius(g),
                                            g.payload) else 1)
            * (L - 1) for g in members)
