"""The tiled form of K4 on the CPU: its cut of the buffer and its contract.

The tiled form (``csrc/taskbench_blocked.cu``, ``taskbench_blocked_tiled``)
gives each CTA output rows [t0, t1) and a slice of the columns, loads rows
[t0 - S*r, t1 + S*r) into shared memory once and runs all S depths there.
No CUDA kernel runs here; these tests hold what the card relies on:
``plan_tiles`` covers every row once within the shared-memory budget; the
plain version run tile by tile on each tile's loaded span (and column
slice) equals the full plain run bit for bit (``torch.equal``), so no
output row needs anything outside its tile's span; a table that reaches
past its declared radius is refused; and the tile-by-tile result agrees
with the JAX reference's ``_blocked_call`` in interpret mode within
``rtol=1e-5, atol=1e-6`` (its sums taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.taskbench_step import taskbench_step_pallas
from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.kernels import ops
from repro_torch.kernels import taskbench_step as k34
from repro_torch.kernels.bodies import SMEM_LIMIT
from repro_torch.kernels.taskbench_step import (
    blocked_plan,
    plan_tiles,
    table_reach,
    taskbench_step_blocked_plain,
    tile_spans,
    tiled_smem_bytes,
    window_reach,
)

REF_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("K,M,P,S,reach,D,uses_idx,sms", [
    (1, 2144, 64, 8, 2, 5, False, 132),   # the serial main path's buffer
    (1, 2112, 64, 8, 2, 5, False, 132),   # its pipelined interior
    (1, 96, 64, 8, 2, 5, False, 132),     # its pipelined boundary
    (1, 2144, 64, 2, 2, 5, True, 132),    # gather/onehot tables
    (3, 70, 13, 5, 2, 5, False, 132),     # a ragged column slice
    (1, 11, 5, 3, 1, 3, True, 4),
    (2, 301, 64, 2, 2, 3, True, 16),
    (1, 1000, 7, 8, 3, 7, True, 16),
    (4, 64, 16, 3, 0, 1, False, 132),     # reach 0: no halo
])
def test_plan_covers_every_row_once(K, M, P, S, reach, D, uses_idx, sms):
    plan = plan_tiles(K, M, P, S, reach, D, uses_idx, sms)
    assert plan is not None
    width = 1 << plan.col_shift
    assert (plan.n_slices - 1) * width < P <= plan.n_slices * width
    assert plan.ctas == K * plan.n_tiles * plan.n_slices
    spans = tile_spans(plan, M, S, reach)
    assert len(spans) == plan.n_tiles
    owner = np.zeros(M, np.int64)
    for t0, t1, lo, hi in spans:
        assert 0 <= t0 < t1 <= M and t1 - t0 <= plan.tile_rows
        owner[t0:t1] += 1
        # the halo: S * reach rows each side, clipped to the buffer
        assert (lo, hi) == (max(0, t0 - S * reach), min(M, t1 + S * reach))
        assert hi - lo <= plan.loaded_rows
    assert (owner == 1).all()
    assert plan.loaded_rows == min(M, plan.tile_rows + 2 * S * reach)
    assert plan.smem_bytes == tiled_smem_bytes(plan.loaded_rows, plan.col_shift, D,
                                               uses_idx) <= SMEM_LIMIT


def test_plan_keeps_to_the_shared_memory_budget():
    """A budget too small for any tile gives no plan (the cooperative form);
    a tighter one than the default gives taller-than-needed tiles no more."""
    assert plan_tiles(1, 2144, 64, 8, 2, 5, False, 132, smem_limit=64) is None
    plan = plan_tiles(1, 2144, 64, 8, 2, 5, False, 132, smem_limit=4096)
    assert plan is not None and plan.smem_bytes <= 4096


def _tables(combine, K, M, r, seed):
    """Fixed (K, M, D) tables of reach <= r: a window of D = 2r + 1, or
    gather/onehot slots at offsets in [-r, r] clamped into the buffer
    (the runtime's `_rebase_rows`), every third row's first two slots
    equal (onehot merges them)."""
    rng = np.random.default_rng(seed)
    D = 2 * r + 1 if combine == "window" else 3
    wgt = torch.from_numpy((rng.uniform(0, 1, (K, M, D)) / D).astype(np.float32))
    if combine == "window":
        return torch.zeros((K, 1, 1), dtype=torch.int32), wgt
    off = rng.integers(-r, r + 1, (K, M, D))
    idx = np.clip(np.arange(M)[:, None] + off, 0, M - 1).astype(np.int32)
    idx[:, ::3, 1] = idx[:, ::3, 0]
    return torch.from_numpy(idx), wgt


def _operands(combine, K, M, P, S, r, seed, tail=True):
    """Random operands; with ``tail`` the act mask has a masked tail and
    (K > 1) a frozen member, else every depth is active (every halo row
    reaches the tile's own rows)."""
    rng = np.random.default_rng(seed + 100)
    src = torch.from_numpy(rng.uniform(0.1, 1.0, (K, M, P)).astype(np.float32))
    idx, wgt = _tables(combine, K, M, r, seed)
    act = torch.ones((K, S))
    if tail:
        act[:, -1] = 0.0  # the masked tail of a run's last launch
        if K > 1:
            act[1] = 0.0  # a frozen member
    return src, idx, wgt, act


def _tiled_plain(src, idx, wgt, act, r, combine, cut, **kw):
    """The plain version run as the tiled form cuts the work: per tile, per
    column slice, on the tile's loaded rows alone (its indices rebased onto
    them), keeping the tile's own rows. ``cut`` is (tile rows, log2 of the
    slice width), or an SM count for `plan_tiles` to cut for."""
    K, M, P = src.shape
    S, D = act.shape[1], wgt.shape[-1]
    reach = window_reach(D) if combine == "window" else r
    plan = plan_tiles(K, M, P, S, reach, D, combine != "window",
                      cut if isinstance(cut, int) else 132)
    if not isinstance(cut, int):
        rows, sh = cut
        plan = plan._replace(tile_rows=rows, col_shift=sh, n_tiles=-(-M // rows),
                             n_slices=-(-P // (1 << sh)))
    width = 1 << plan.col_shift
    out = torch.full_like(src, float("nan"))
    for t0, t1, lo, hi in tile_spans(plan, M, S, reach):
        for c0 in range(0, P, width):
            part = src[:, lo:hi, c0:c0 + width]
            local = idx if combine == "window" else idx[:, lo:hi] - lo
            got = taskbench_step_blocked_plain(part, local, wgt[:, lo:hi], act,
                                               combine=combine, **kw)
            out[:, t0:t1, c0:c0 + width] = got[:, t0 - lo:t1 - lo]
    return out, plan


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 3), ("empty", 0)])
@pytest.mark.parametrize("cut", [132, (9, 1)])  # the planner's; 8 ragged tiles, 3 slices
@pytest.mark.parametrize("tail", [False, True])
def test_tile_by_tile_plain_equals_the_full_plain_run(combine, S, kind, iterations, cut,
                                                      tail):
    K, M, P, r = 3, 70, 5, 2
    src, idx, wgt, act = _operands(combine, K, M, P, S, r, S, tail)
    kw = dict(kind=kind, iterations=iterations, scratch=20)
    got, plan = _tiled_plain(src, idx, wgt, act, r, combine, cut, **kw)
    assert plan.n_tiles > 1  # the cut really tiles the rows
    want = taskbench_step_blocked_plain(src, idx, wgt, act, combine=combine, **kw)
    assert torch.equal(got, want)
    if tail:
        assert torch.equal(got[1], src[1])  # the frozen member


def test_a_tile_one_halo_row_short_differs():
    """The control: loading one halo row less on a tile's high side changes
    the tile's last row after S active depths, so the tests above see a
    halo too short."""
    K, M, P, S, r = 1, 70, 5, 3, 2
    src, idx, wgt, act = _operands("window", K, M, P, S, r, 1, tail=False)
    kw = dict(kind="empty", iterations=0, scratch=20, combine="window")
    want = taskbench_step_blocked_plain(src, idx, wgt, act, **kw)
    t0, t1 = 20, 30
    lo, hi = t0 - S * r, t1 + S * r - 1  # one row short of [t0 - S r, t1 + S r)
    got = taskbench_step_blocked_plain(src[:, lo:hi], idx, wgt[:, lo:hi], act, **kw)
    assert torch.equal(got[:, t0 - lo:t1 - lo - 1], want[:, t0:t1 - 1])
    assert not torch.equal(got[:, t1 - 1 - lo], want[:, t1 - 1])


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("S", [2, 5])
def test_tiled_cut_agrees_with_the_reference(combine, S):
    """The tile-by-tile run and the port's wrapper with a declared radius
    against the JAX reference's blocked kernel in interpret mode."""
    K, M, P, r = 2, 40, 6, 2
    src, idx, wgt, act = _operands(combine, K, M, P, S, r, 10 + S)
    kw = dict(kind="compute_bound", iterations=2, scratch=20)
    got, _ = _tiled_plain(src, idx, wgt, act, r, combine, (7, 1), **kw)
    j = jnp.asarray
    want = np.asarray(taskbench_step_pallas(
        j(src.numpy()), j(idx.numpy()), j(wgt.numpy()), j(act.numpy()),
        steps_per_launch=S, combine=combine, interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)
    via_ops = ops.taskbench_step(src, idx, wgt, act, steps_per_launch=S, radius=r,
                                 combine=combine, **kw)
    np.testing.assert_allclose(via_ops.numpy(), want, **REF_TOL)


@pytest.mark.parametrize("combine", ["gather", "onehot"])
@pytest.mark.parametrize("time_varying", [False, True])
def test_wrapper_refuses_a_table_past_its_radius(combine, time_varying):
    K, M, P, S, r = 1, 30, 4, 3, 2
    src, idx, wgt, act = _operands(combine, K, M, P, S, r, 5)
    if time_varying:
        idx, wgt = (t[:, None].expand(K, S, M, t.shape[-1]).contiguous()
                    for t in (idx, wgt))
    kw = dict(kind="compute_bound", iterations=1, combine=combine,
              steps_per_launch=S)
    ops.taskbench_step(src, idx, wgt, act, radius=r, **kw)  # within reach
    idx[..., 17, 0] = 17 + r + 1
    with pytest.raises(ValueError, match="beyond the declared radius"):
        ops.taskbench_step(src, idx, wgt, act, radius=r, **kw)
    ops.taskbench_step(src, idx, wgt, act, radius=r + 1, **kw)
    ops.taskbench_step(src, idx, wgt, act, **kw)  # no radius: no promise


def test_wrapper_refuses_a_window_wider_than_its_radius_and_bad_radii():
    K, M, P, S, r = 1, 30, 4, 3, 2
    src, idx, wgt, act = _operands("window", K, M, P, S, r + 1, 5)  # D = 2r + 3
    kw = dict(kind="compute_bound", iterations=1, combine="window")
    with pytest.raises(ValueError, match="beyond radius"):
        ops.taskbench_step(src, idx, wgt, act, steps_per_launch=S, radius=r, **kw)
    with pytest.raises(ValueError, match="radius must be >= 0"):
        ops.taskbench_step(src, idx, wgt, act, steps_per_launch=S, radius=-1, **kw)
    g_src, g_idx = torch.ones((1, 6, 4)), torch.zeros((1, 6, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="steps_per_launch > 1"):
        ops.taskbench_step(g_src, g_idx, torch.ones((1, 6, 2)), kind="compute_bound",
                           iterations=1, combine="gather", radius=r)


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
def test_table_reach_follows_the_index_rule(combine):
    M, D = 12, 4
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(-M - 2, 2 * M, (2, M, D)).astype(np.int32))
    wgt = torch.ones((2, M, D))
    want = 0
    for k in range(2):
        for i in range(M):
            for j in range(D):
                v = int(idx[k, i, j])
                if combine == "gather":
                    v = min(max(v + M if v < 0 else v, 0), M - 1)
                elif not 0 <= v < M:
                    continue  # an onehot slot outside the buffer reads nothing
                want = max(want, abs(v - i))
    if combine == "window":
        want = window_reach(D)
    assert table_reach(idx, wgt, combine) == want
    assert [window_reach(d) for d in (1, 2, 3, 4, 5)] == [0, 1, 1, 2, 2]


def test_form_rule():
    """The tiled form takes fixed tables with a declared radius and the
    compute or empty body; the cooperative form everything else."""
    src, wgt, tv = (1, 2144, 64), (1, 2144, 5), (1, 8, 2144, 5)
    assert blocked_plan(src, wgt, 8, "window", False, 2) is not None
    assert blocked_plan(src, wgt, 8, "gather", False, 2) is not None
    assert blocked_plan(src, wgt, 8, "window", False, None) is None
    assert blocked_plan(src, wgt, 8, "window", True, 2) is None
    assert blocked_plan(src, tv, 8, "gather", False, 2) is None


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("combine", ["window", "gather"])
def test_blocked_runtime_declares_the_halo_radius(monkeypatch, pipeline, combine):
    """Every K4 launch of pallas_step's blocked schedules declares the
    pattern's halo radius, so the fixed-table launches take the tiled form."""
    seen = []
    step = k34.step_on_device

    def record(*a, **kw):
        seen.append((kw.get("steps_per_launch", 1), kw.get("radius")))
        return step(*a, **kw)

    monkeypatch.setattr(k34, "step_on_device", record)
    monkeypatch.setattr(ops, "step_on_device", record)
    g = TaskGraph(steps=9, width=24, pattern="nearest", payload=4,
                  kernel=KernelSpec("compute_bound", 1), radius=2, seed=1)
    rt = get_runtime("pallas_step", device="cpu", combine=combine, steps_per_launch=3,
                     pipeline=pipeline)
    rt.execute(g)
    blocked = [r for s, r in seen if s > 1]
    assert blocked and all(r == 2 for r in blocked)
    assert len(blocked) + 1 == rt.dispatches_per_run(g)
