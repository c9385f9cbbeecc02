"""The resident form of K4 on the CPU: its cut of the buffer and its contract.

The resident form (``csrc/taskbench_blocked.cu``,
``taskbench_blocked_resident``) gives one thread block cluster of C CTAs
each (member, column slice); CTA ``rank`` owns rows [rank * R, (rank + 1)
* R) of the slice in shared memory for all S depths and reads the rows
the other CTAs of its cluster own through distributed shared memory. No
CUDA kernel runs here; these tests hold what the card relies on:
``plan_resident`` covers every (member, column, row) exactly once within
the shared-memory budget and refuses what no cluster holds; the plain
version run as the kernel cuts the work (per cluster column slice, zero
padded as the kernel pads it, per CTA rank over its own rows with every
other row's tables poisoned, reading only its cluster's buffers) equals
the full plain run bit for bit (``torch.equal``); the form rule takes the
tiled form where it applies, the resident form for any other table with
the compute or empty body, and the cooperative form for the memory body or
a buffer no cluster holds, naming why; and the sliced run agrees with the
JAX reference's ``_blocked_call`` in interpret mode within ``rtol=1e-5,
atol=1e-6`` (its sums taken in another order). The states run at grain 1
and S <= 7, so that none sits at the FMA's fixed point 0.2, where a wrong
dataflow would pass.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.taskbench_step import taskbench_step_pallas
from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import pallas_step as ps
from repro_torch.kernels import ops
from repro_torch.kernels import taskbench_step as k34
from repro_torch.kernels.bodies import SMEM_LIMIT
from repro_torch.kernels.taskbench_step import (
    CLUSTER_SIZES,
    blocked_form,
    default_clusters,
    plan_resident,
    resident_smem_bytes,
    resident_spans,
    share_clusters,
    taskbench_step_blocked_plain,
)

REF_TOL = dict(rtol=1e-5, atol=1e-6)
#: grain 1: a step halves a row's distance from the FMA's fixed point 0.2
KW = dict(kind="compute_bound", iterations=1, scratch=20)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("K,M,P,S,D,tv,uses_idx,sms", [
    (1, 2144, 64, 8, 5, False, False, 132),  # the blocked main path's buffer
    (1, 512, 64, 8, 2, True, True, 132),     # a blocked fft launch's tables
    (1, 2048, 64, 8, 2, True, True, 132),    # fft at full width
    (1, 512, 64, 8, 512, False, True, 132),  # all_to_all at D = W
    (1, 2048, 64, 8, 512, True, True, 132),  # tables past the budget: from L2
    (1, 512, 64, 16, 3, True, True, 33),     # a quarter of the card (D = 4)
    (3, 70, 13, 5, 3, False, True, 16),      # a ragged column slice
    (2, 9, 5, 3, 3, False, False, 132),      # a tiny buffer: one CTA a slice
    (1, 301, 64, 8, 3, False, True, 132),    # rows not a multiple of the cluster
    (1, 1000, 64, 8, 3, True, True, 132),    # 16 ranks of 63 rows, the last 55
    (1, 1, 64, 2, 1, False, True, 132),      # W = 1
])
def test_plan_covers_every_element_once(K, M, P, S, D, tv, uses_idx, sms):
    plan = plan_resident(K, M, P, S, D, tv, uses_idx, sms)
    assert plan is not None and plan.cluster in CLUSTER_SIZES
    width = 1 << plan.col_shift
    assert (plan.n_slices - 1) * width < P <= plan.n_slices * width
    assert plan.ctas == K * plan.n_slices * plan.cluster
    assert plan.rows == -(-M // plan.cluster)
    owner = np.zeros((K, M, P), np.int64)
    for k in range(K):
        for c0 in range(0, P, width):
            for r0, r1 in resident_spans(plan, M):
                assert r1 - r0 <= plan.rows
                owner[k, r0:r1, c0:c0 + width] += 1
    assert (owner == 1).all()
    tables = S if tv else 1
    assert plan.smem_bytes == resident_smem_bytes(plan.rows, plan.col_shift, D, tables,
                                                  uses_idx, plan.tables_smem) <= SMEM_LIMIT
    # the tables stay in shared memory exactly where they fit beside the buffers
    assert plan.tables_smem == (resident_smem_bytes(
        plan.rows, plan.col_shift, D, tables, uses_idx, True) <= SMEM_LIMIT)
    # a sector-wide slice where the payload allows
    assert width >= min(8, 1 << max(0, (P - 1).bit_length()))
    # the clusters of one wave fit the ones the SMs hold at once
    cap = dict(zip(CLUSTER_SIZES, default_clusters(sms)))[plan.cluster]
    assert cap >= 1


def test_plan_refuses_what_no_cluster_holds():
    """Two copies of a slice's rows past 16 CTAs' budget: no plan, and the
    form rule takes the cooperative form, naming why; a smaller budget, a
    card with no room for a cluster, the same."""
    M = 16 * SMEM_LIMIT // (2 * 4 * 8) + 16
    assert plan_resident(1, M, 64, 8, 3, True, True) is None
    assert plan_resident(1, M - 32, 64, 8, 3, True, True) is not None
    assert plan_resident(1, 2144, 64, 8, 5, False, False, smem_limit=64) is None
    assert plan_resident(1, 2144, 64, 8, 5, False, False, clusters=(0,) * 5) is None
    chosen = blocked_form((1, M, 64), (1, 8, M, 3), 8, "gather", False, None)
    assert chosen.form == "cooperative" and chosen.plan is None
    assert "no cluster of up to 16 CTAs holds" in chosen.reason
    assert "declares no radius" in chosen.reason
    with pytest.raises(ValueError, match="resident form does not apply"):
        blocked_form((1, M, 64), (1, 8, M, 3), 8, "gather", False, None, form="resident")


def test_plan_shares_the_card_among_its_grids():
    """At D grids on one card each plan gets 1/D of the SMs and clusters:
    no more CTAs in one wave than its share holds."""
    full = plan_resident(1, 512, 64, 8, 2, True, True, 132)
    quarter = plan_resident(1, 512, 64, 8, 2, True, True, 33,
                            share_clusters(default_clusters(132), 4))
    assert full.ctas <= 132 and quarter.ctas <= 33
    rt = get_runtime("pallas_step", devices=["cpu"] * 4)
    assert rt._grids() == 4
    assert rt._card_share() == {"sms": 33,
                                "clusters": share_clusters(default_clusters(132), 4)}
    assert share_clusters(default_clusters(132), 4) == (33, 16, 8, 4, 2)
    assert get_runtime("pallas_step", device="cpu")._grids() == 1


def test_form_rule():
    """Tiled where it applies; else resident for the compute and empty
    bodies, whatever the table; else cooperative (the memory body). Each
    choice names why the faster forms were passed over; a pinned form that
    does not apply raises."""
    src, wgt, tv = (1, 2144, 64), (1, 2144, 5), (1, 8, 2144, 5)
    got = blocked_form(src, wgt, 8, "window", False, 2)
    assert (got.form, got.reason, got.entry) == ("tiled", "", "taskbench_blocked_tiled")
    got = blocked_form(src, wgt, 8, "window", False, None)
    assert got.form == "resident" and got.entry == "taskbench_blocked_resident"
    assert got.reason == "not tiled: the launch declares no radius (its tables may reach any row)"
    got = blocked_form(src, tv, 8, "gather", False, 2)
    assert got.form == "resident" and "time-varying" in got.reason
    got = blocked_form((1, 512, 64), (1, 512, 512), 8, "onehot", False, None)
    assert got.form == "resident"
    for radius in (None, 2):
        got = blocked_form(src, wgt, 8, "window", True, radius)
        assert (got.form, got.entry) == ("cooperative", "taskbench_blocked")
        assert "not resident: the memory body runs only in K4's cooperative form" in got.reason
    # a tile too tall for shared memory: resident, naming the tiled budget
    got = blocked_form((1, 4096, 64), (1, 4096, 129), 8, "window", False, 64)
    assert got.form == "resident" and "no tile fits" in got.reason
    # pinned forms
    assert blocked_form(src, wgt, 8, "window", False, 2, form="resident").form == "resident"
    assert blocked_form(src, wgt, 8, "window", False, 2,
                        form="cooperative").form == "cooperative"
    with pytest.raises(ValueError, match="tiled form does not apply"):
        blocked_form(src, tv, 8, "gather", False, 2, form="tiled")
    with pytest.raises(ValueError, match="resident form does not apply: the memory body"):
        blocked_form(src, wgt, 8, "window", True, None, form="resident")
    with pytest.raises(ValueError, match="unknown K4 form"):
        blocked_form(src, wgt, 8, "window", False, None, form="persistent")


def test_wrapper_checks_the_pinned_form_and_grids_on_the_cpu():
    src, idx, wgt, act = _operands("gather", 1, 12, 4, 3, 5)
    kw = dict(KW, combine="gather", steps_per_launch=3)
    want = taskbench_step_blocked_plain(src, idx, wgt, act, **KW, combine="gather")
    for form in ("resident", "cooperative"):
        assert torch.equal(ops.taskbench_step(src, idx, wgt, act, form=form, **kw), want)
    with pytest.raises(ValueError, match="tiled form does not apply"):
        ops.taskbench_step(src, idx, wgt, act, form="tiled", **kw)
    with pytest.raises(ValueError, match="resident form does not apply"):
        ops.taskbench_step(src, idx, wgt, act, form="resident",
                           **dict(kw, kind="memory_bound", iterations=2))
    with pytest.raises(ValueError, match="grids must be >= 1"):
        ops.taskbench_step(src, idx, wgt, act, grids=0, **kw)
    with pytest.raises(ValueError, match="form is K4's"):
        ops.taskbench_step(src, idx, wgt, form="resident", **dict(KW, combine="gather"))


def _operands(combine, K, M, P, S, seed, tv=False, D=3):
    """Random operands: tables of any reach (indices anywhere in and a
    little past the buffer, every third row's first two slots equal, so
    onehot merges them), fixed or time-varying; an act mask with a masked
    tail and, at K > 1, a member frozen at depth 1 and one frozen
    throughout."""
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.uniform(0.3, 1.0, (K, M, P)).astype(np.float32))
    lead = (K, S, M) if tv else (K, M)
    D = 2 * (D // 2) + 1 if combine == "window" else D
    wgt = torch.from_numpy((rng.uniform(0, 1, lead + (D,)) / D).astype(np.float32))
    idx = rng.integers(-2, M + 2, lead + (D,)).astype(np.int32)
    idx[..., ::3, 1] = idx[..., ::3, 0]
    act = torch.ones((K, S))
    act[:, -1] = 0.0
    if K > 1:
        act[1, 1] = 0.0
    if K > 2:
        act[2] = 0.0
    idx = torch.zeros((K, 1, 1), dtype=torch.int32) if combine == "window" \
        else torch.from_numpy(idx)
    return src, idx, wgt, act


def _resident_plain(src, idx, wgt, act, combine, plan, **kw):
    """The plain version run as the resident form cuts the work: per
    member, per column slice (zero padded to the slice's width, as the
    kernel pads it), per depth, each CTA rank computes its own rows from
    its cluster's buffers alone (the ranks' buffers of this slice, stacked),
    every other row's weights poisoned with NaN and its indices pointed
    past the buffer, so that a rank that read another row's tables would
    show; an inactive depth carries the ranks' buffers through."""
    K, M, P = src.shape
    S = act.shape[1]
    tv = wgt.ndim == 4
    width = 1 << plan.col_shift
    spans = resident_spans(plan, M)
    out = torch.full_like(src, float("nan"))
    for k in range(K):
        for c0 in range(0, P, width):
            part = torch.zeros((1, M, width))
            cols = min(width, P - c0)
            part[0, :, :cols] = src[k, :, c0:c0 + cols]
            bufs = [part[:, r0:r1].clone() for r0, r1 in spans]
            for d in range(S):
                if act[k, d] <= 0.5:
                    continue
                cluster = torch.cat(bufs, dim=1)  # what the ranks hold
                w_d = (wgt[k:k + 1, d] if tv else wgt[k:k + 1]).clone()
                i_d = None if combine == "window" else \
                    (idx[k:k + 1, d] if tv else idx[k:k + 1]).clone()
                nxt = []
                for r0, r1 in spans:
                    w = torch.full_like(w_d, float("nan"))
                    w[:, r0:r1] = w_d[:, r0:r1]
                    i = None
                    if i_d is not None:
                        i = torch.full_like(i_d, M + 7)
                        i[:, r0:r1] = i_d[:, r0:r1]
                    one = taskbench_step_blocked_plain(
                        cluster, i if i is not None else idx, w, torch.ones((1, 1)),
                        combine=combine, **kw)
                    nxt.append(one[:, r0:r1])
                bufs = nxt
            out[k, :, c0:c0 + cols] = torch.cat(bufs, dim=1)[0, :, :cols]
    return out


def _slices_plain(src, idx, wgt, act, combine, plan, **kw):
    """The plain version run on each cluster's zero-padded column slice
    whole, its rows not split among ranks."""
    P = src.shape[2]
    width = 1 << plan.col_shift
    out = torch.empty_like(src)
    for c0 in range(0, P, width):
        cols = min(width, P - c0)
        part = torch.zeros(src.shape[:2] + (width,))
        part[..., :cols] = src[..., c0:c0 + cols]
        out[..., c0:c0 + cols] = taskbench_step_blocked_plain(
            part, idx, wgt, act, combine=combine, **kw)[..., :cols]
    return out


def _plan_of(src, wgt, act, combine, cut):
    K, M, P = src.shape
    plan = plan_resident(K, M, P, act.shape[1], wgt.shape[-1], wgt.ndim == 4,
                         combine != "window", cut if isinstance(cut, int) else 132)
    if not isinstance(cut, int):  # (cluster, log2 of the slice width)
        C, sh = cut
        plan = plan._replace(cluster=C, rows=-(-M // C), col_shift=sh,
                             n_slices=-(-P // (1 << sh)))
    return plan


#: (combine, time-varying): window has no time-varying form
TABLES = [("window", False), ("gather", False), ("onehot", False), ("gather", True),
          ("onehot", True)]


@pytest.mark.parametrize("combine,tv", TABLES)
@pytest.mark.parametrize("K,M,P,S", [(3, 37, 5, 4), (1, 64, 16, 7)])
@pytest.mark.parametrize("cut", [132, (4, 1), (16, 3)])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 1), ("empty", 0)])
def test_cluster_by_cluster_plain_equals_the_full_plain_run(combine, tv, K, M, P, S, cut,
                                                            kind, iterations):
    src, idx, wgt, act = _operands(combine, K, M, P, S, M + S, tv)
    kw = dict(kind=kind, iterations=iterations, scratch=20)
    plan = _plan_of(src, wgt, act, combine, cut)
    got = _resident_plain(src, idx, wgt, act, combine, plan, **kw)
    want = taskbench_step_blocked_plain(src, idx, wgt, act, combine=combine, **kw)
    assert torch.equal(got, want)
    if K > 2:
        assert torch.equal(got[2], src[2])  # the member frozen throughout


def _plan_tables(pattern, W, S):
    """The blocked all-gather plan's (1, S, W, D) tables of a launch, as the
    runtime builds them (all_to_all: its one static (1, W, W) pair)."""
    g = TaskGraph(steps=S + 1, width=W, pattern=pattern, payload=6,
                  kernel=KernelSpec("compute_bound", 1), seed=2)
    tables_at, key_of, tv = get_runtime("pallas_step", device="cpu")._global_table_fn(g)
    idx, wgt, _ = ps._stack_tables(tables_at, key_of, [list(range(1, S + 1))], "cpu")
    return (idx, wgt) if tv else (idx[:, 0], wgt[:, 0])


@pytest.mark.parametrize("pattern,W,S,cut", [
    ("fft", 32, 5, 132), ("fft", 64, 6, (8, 2)), ("tree", 32, 5, 132),
    ("tree", 16, 4, (16, 3)), ("spread", 32, 7, 132), ("spread", 48, 3, (2, 1)),
    ("all_to_all", 32, 4, 132), ("all_to_all", 24, 3, (4, 2))])
@pytest.mark.parametrize("combine", ["gather", "onehot"])
def test_the_plans_tables_cut_by_cluster_agree_with_the_reference(pattern, W, S, cut,
                                                                  combine):
    """The all-gather plan's real tables (fft, tree and spread time-varying;
    all_to_all static at D = W), run as the resident form cuts them: bit
    for bit the plain run on each whole column slice, and the full plain
    run too where its slot sum is sequential (a few slots: the plain
    version sums all_to_all's D = W slots vectorised, in an order that
    follows the column count, so there within tolerance), and within
    tolerance of the JAX reference's blocked kernel in interpret mode, as
    is the port's wrapper."""
    idx, wgt = _plan_tables(pattern, W, S)
    P = 6
    src = torch.from_numpy(np.random.default_rng(W + S).uniform(0.3, 1.0, (1, W, P))
                           .astype(np.float32))
    act = torch.ones((1, S))
    act[0, -1] = 0.0
    plan = _plan_of(src, wgt, act, combine, cut)
    got = _resident_plain(src, idx, wgt, act, combine, plan, **KW)
    full = taskbench_step_blocked_plain(src, idx, wgt, act, combine=combine, **KW)
    assert torch.equal(got, _slices_plain(src, idx, wgt, act, combine, plan, **KW))
    if pattern == "all_to_all":
        np.testing.assert_allclose(got.numpy(), full.numpy(), **REF_TOL)
    else:
        assert torch.equal(got, full)
    assert (got - 0.2).abs().min() > 1e-3  # away from the FMA's fixed point
    j = jnp.asarray
    want = np.asarray(taskbench_step_pallas(
        j(src.numpy()), j(idx.numpy()), j(wgt.numpy()), j(act.numpy()),
        steps_per_launch=S, combine=combine, interpret=True, **KW))
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)
    via_ops = ops.taskbench_step(src, idx, wgt, act, steps_per_launch=S,
                                 combine=combine, form="resident", **KW)
    np.testing.assert_allclose(via_ops.numpy(), want, **REF_TOL)


@pytest.mark.parametrize("combine,tv", TABLES)
def test_random_tables_cut_by_cluster_agree_with_the_reference(combine, tv):
    """Random tables of any reach, K = 3 members (one frozen at a depth, one
    throughout), against the JAX reference in interpret mode."""
    K, M, P, S = 3, 40, 6, 5
    src, idx, wgt, act = _operands(combine, K, M, P, S, 11, tv)
    plan = _plan_of(src, wgt, act, combine, (4, 1))
    got = _resident_plain(src, idx, wgt, act, combine, plan, **KW)
    j = jnp.asarray
    want = np.asarray(taskbench_step_pallas(
        j(src.numpy()), j(idx.numpy()), j(wgt.numpy()), j(act.numpy()),
        steps_per_launch=S, combine=combine, interpret=True, **KW))
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)


def test_a_rank_that_reads_only_its_own_rows_differs():
    """The control: a rank that combines from its own buffer alone (the
    other ranks' rows read as zeros) gives other rows than the cluster's,
    so the tests above see a rank that skips its cluster's rows."""
    src, idx, wgt, act = _operands("gather", 1, 40, 4, 3, 3)
    plan = _plan_of(src, wgt, act, "gather", (4, 2))
    want = _resident_plain(src, idx, wgt, act, "gather", plan, **KW)
    lonely = torch.zeros_like(src)
    for r0, r1 in resident_spans(plan, 40):
        alone = torch.zeros_like(src)
        alone[:, r0:r1] = src[:, r0:r1]
        lonely[:, r0:r1] = taskbench_step_blocked_plain(
            alone, idx, wgt, act, combine="gather", **KW)[:, r0:r1]
    assert not torch.equal(lonely, want)


@pytest.mark.parametrize("devices", [1, 4])
def test_the_blocked_all_gather_plan_plans_for_its_share(monkeypatch, devices):
    """Every K4 launch of the blocked all-gather plan declares no radius and
    passes the grids that share the card (D shards on one card: D), so
    each grid is planned for its share."""
    seen = []
    step = k34.step_on_device

    def record(*a, **kw):
        seen.append((kw.get("steps_per_launch", 1), kw.get("radius"), kw.get("grids", 1)))
        return step(*a, **kw)

    monkeypatch.setattr(k34, "step_on_device", record)
    monkeypatch.setattr(ops, "step_on_device", record)
    g = TaskGraph(steps=7, width=32, pattern="spread", payload=4,
                  kernel=KernelSpec("compute_bound", 1), seed=1)
    rt = get_runtime("pallas_step", devices=["cpu"] * devices, steps_per_launch=3) \
        if devices > 1 else get_runtime("pallas_step", device="cpu", steps_per_launch=3)
    rt.execute(g)
    blocked = [(r, n) for s, r, n in seen if s > 1]
    assert blocked and all(b == (None, devices) for b in blocked)
    assert len(blocked) == devices * (rt.dispatches_per_run(g) - 1)
