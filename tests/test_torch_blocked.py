"""Parity of the port's temporal-blocked path with the JAX package, on the CPU.

K4's plain version against ``taskbench_step_pallas(..., steps_per_launch=S)``
in interpret mode; the pipelined phase wrappers against the reference's;
the blocked runtime's host operand builders byte-equal to the reference's;
``pallas_step`` with ``steps_per_launch=S`` and ``pipeline`` on or off
against the reference runtime with the same options, and pipelined equal
to serial bit for bit within the port. Tolerances: compute_bound and empty
``rtol=1e-5, atol=1e-6``; memory_bound ``atol=1e-5`` (the sweep's mean is
summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.core import KernelSpec as RefSpec
from repro.core import TaskGraph as RefGraph
from repro.core import get_runtime as ref_runtime
from repro.core.runtimes import pallas_step as ref_ps
from repro.core.runtimes.bsp import AXIS
from repro.core.task_kernels import initial_state as ref_initial_state
from repro.kernels import ops as ref_ops
from repro.kernels.taskbench_step import taskbench_step_pallas
from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import pallas_step as ps
from repro_torch.kernels import ops
from repro_torch.kernels.taskbench_step import taskbench_step_blocked_plain

HALO = ("trivial", "no_comm", "stencil_1d", "stencil_1d_periodic", "dom",
        "nearest", "random_nearest")
COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=0, atol=1e-5)
KINDS = [("compute_bound", 5), ("memory_bound", 3), ("empty", 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tol(kind):
    return MEMORY_TOL if kind == "memory_bound" else COMPUTE_TOL


def _blocked_operands(combine, K, S, M, D, time_varying, seed):
    """Random K4 operands: duplicate slots, slots outside [0, M), and an act
    mask with a masked tail and (K > 1) one frozen member."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.1, 1.0, (K, M, 5)).astype(np.float32)
    shape = (K, S, M, D) if time_varying else (K, M, D)
    idx = rng.integers(-2, M + 2, shape).astype(np.int32)
    idx[..., ::3, 1] = idx[..., ::3, 0]
    wgt = (rng.uniform(0, 1, shape) / D).astype(np.float32)
    act = np.ones((K, S), np.float32)
    act[:, -1] = 0.0
    if K > 1:
        act[1] = 0.0
    return src, idx, wgt, act


def _reference_blocked(src, idx, wgt, act, **kw):
    return np.asarray(taskbench_step_pallas(
        jnp.asarray(src), jnp.asarray(idx), jnp.asarray(wgt), jnp.asarray(act),
        steps_per_launch=act.shape[1], interpret=True, **kw))


# fixed tables at every kind; time-varying (gather/onehot only) at the
# two kinds with a body
_TABLES = [(c, False, k) for c in ("window", "gather", "onehot") for k in KINDS] + [
    (c, True, k) for c in ("gather", "onehot") for k in KINDS[:2]]


@pytest.mark.parametrize("combine,time_varying,kind_iters", _TABLES)
@pytest.mark.parametrize("S", [2, 5])
@pytest.mark.parametrize("K", [1, 3])
def test_blocked_plain_matches_reference_kernel(combine, time_varying, kind_iters,
                                                S, K):
    kind, iters = kind_iters
    D = 5 if combine == "window" else 3
    src, idx, wgt, act = _blocked_operands(combine, K, S, 11, D, time_varying, S + K)
    kw = dict(kind=kind, iterations=iters, scratch=20, combine=combine)
    want = _reference_blocked(src, idx, wgt, act, **kw)
    got = ops.taskbench_step(_t(src), _t(idx), _t(wgt), _t(act), steps_per_launch=S,
                             **kw)
    np.testing.assert_allclose(got.numpy(), want, **_tol(kind))
    assert torch.equal(got, taskbench_step_blocked_plain(
        _t(src), _t(idx), _t(wgt), _t(act), **kw))


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("K", [1, 3])
def test_phase_wrappers_match_reference(combine, K):
    S, depth, B = 3, 6, 16
    rng = np.random.default_rng(K)
    src, idx, wgt, act = _blocked_operands(combine, K, S, B, 5, False, K)
    left, right = (rng.uniform(0.1, 1, (K, 3 * depth, 5)).astype(np.float32)
                   for _ in range(2))
    bidx = rng.integers(0, 6 * depth, (K, 6 * depth, 5)).astype(np.int32)
    bwgt = (rng.uniform(0, 1, (K, 6 * depth, 5)) / 5).astype(np.float32)
    kw = dict(kind="compute_bound", iterations=2, scratch=20, combine=combine,
              steps_per_launch=S)
    j = jnp.asarray
    want = np.asarray(ref_ops.taskbench_interior(j(src), j(idx), j(wgt), j(act),
                                                 depth=depth, **kw))
    got = ops.taskbench_interior(_t(src), _t(idx), _t(wgt), _t(act), depth=depth, **kw)
    assert got.shape == (K, B - 2 * depth, 5)
    np.testing.assert_allclose(got.numpy(), want, **COMPUTE_TOL)
    want = ref_ops.taskbench_boundary(j(left), j(right), j(bidx), j(bwgt), j(act),
                                      depth=depth, **kw)
    got = ops.taskbench_boundary(_t(left), _t(right), _t(bidx), _t(bwgt), _t(act),
                                 depth=depth, **kw)
    for g, w in zip(got, want):
        assert g.shape == (K, depth, 5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **COMPUTE_TOL)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("case", [
    # (combine, src, idx, wgt, act) shapes; S = 3 unless act says otherwise
    ("gather", (1, 6, 4), (1, 6, 2), (1, 6, 2), None),          # no act
    ("gather", (1, 6, 4), (1, 6, 2), (1, 6, 2), (1, 2)),        # act (K, S')
    ("gather", (1, 6, 4), (1, 6, 2), (1, 6, 2), (3,)),          # act rank
    ("pair", (1, 6, 4), (1, 6, 1), (1, 6, 1), (1, 3)),          # pair
    ("window", (1, 6, 4), (1, 3, 6, 1), (1, 3, 6, 3), (1, 3)),  # window, TV
    ("gather", (1, 6, 4), (1, 3, 5, 2), (1, 3, 5, 2), (1, 3)),  # TV shape
    ("onehot", (1, 6, 4), (1, 3, 6, 1), (1, 3, 6, 2), (1, 3)),  # TV mismatch
    ("gather", (1, 6, 4), (1, 5, 2), (1, 5, 2), (1, 3)),        # not square
    ("window", (2, 6, 4), (1, 1, 1), (1, 6, 3), (2, 3)),        # not square (K)
    ("onehot", (1, 6, 4), (1, 6, 1), (1, 6, 2), (1, 3)),        # idx/wgt
    ("gather", (1, 6, 4), (1, 6, 2), (1, 6, 2), (2, 3)),        # act K
])
def test_blocked_checks_match_reference(case):
    combine, s, i, w, a = case
    src, idx, wgt = np.zeros(s, np.float32), np.zeros(i, np.int32), np.ones(w, np.float32)
    act = None if a is None else np.ones(a, np.float32)
    kw = dict(combine=combine, steps_per_launch=3)
    want = _error(lambda: ref_ops.taskbench_step(
        jnp.asarray(src), jnp.asarray(idx), jnp.asarray(wgt),
        None if act is None else jnp.asarray(act), **kw))
    got = _error(lambda: ops.taskbench_step(
        _t(src), _t(idx), _t(wgt), None if act is None else _t(act), **kw))
    assert got == want


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("combine", ["gather", "onehot"])
def test_out_of_range_indices_follow_the_reference(combine, S):
    """gather wraps a negative index once, then clamps; an onehot slot
    outside the source adds nothing (K3 at S = 1, K4 at S > 1)."""
    n = 6  # source rows
    bad = [-1, -2, n, n + 3, -n - 1]
    idx = np.array([[[b, r % n] for r, b in enumerate(bad)]
                    + [[bad[i], bad[(i + 2) % 5]] for i in range(n - 5)]], np.int32)
    rng = np.random.default_rng(S)
    wgt = np.full(idx.shape, 0.5, np.float32)
    kw = dict(kind="compute_bound", iterations=1, scratch=20, combine=combine)
    if S == 1:
        src = rng.uniform(0.1, 1, (1, n, 4)).astype(np.float32)
        want = np.asarray(ref_ops.taskbench_step(
            jnp.asarray(src), jnp.asarray(idx), jnp.asarray(wgt), **kw))
        got = ops.taskbench_step(_t(src), _t(idx), _t(wgt), **kw)
    else:
        src = rng.uniform(0.1, 1, (1, n, 4)).astype(np.float32)
        act = np.ones((1, S), np.float32)
        want = _reference_blocked(src, idx, wgt, act, **kw)
        got = ops.taskbench_step(_t(src), _t(idx), _t(wgt), _t(act),
                                 steps_per_launch=S, **kw)
    np.testing.assert_allclose(got.numpy(), want, **COMPUTE_TOL)


def _graphs(pattern, width=24, steps=9, kind="compute_bound", iters=2, **kw):
    kw = dict(dict(radius=2, seed=3), **kw)
    spec = dict(kind=kind, iterations=iters, scratch=30)
    g = TaskGraph(steps=steps, width=width, pattern=pattern, payload=5,
                  kernel=KernelSpec(**spec), **kw)
    r = RefGraph(steps=steps, width=width, pattern=pattern, payload=5,
                 kernel=RefSpec(**spec), **kw)
    return g, r


def _one_device(fn, n_in):
    mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(),) * n_in, out_specs=P(),
                             check_vma=False))


@pytest.mark.parametrize("pattern,width,radius", [
    ("dom", 12, 2), ("nearest", 5, 3), ("random_nearest", 12, 3),
    ("trivial", 7, 1)])
@pytest.mark.parametrize("mode", ["window", "gather"])
def test_blocked_host_tables_match_reference(pattern, width, radius, mode):
    g, r = _graphs(pattern, width, radius=radius)
    H = ps._patterns.halo_radius(g)
    for a, b in zip(ps._rel_dep_operands(g), ref_ps._rel_dep_operands(r)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rt = get_runtime("pallas_step", device="cpu", combine=mode, steps_per_launch=3)
    ref_rt = ref_runtime("pallas_step", combine=mode, steps_per_launch=3)
    idx, wgt, idx0, wgt0 = rt._blocked_operands(g, H)
    for a, b in zip((idx, wgt, idx0, wgt0), ref_rt._blocked_operands(r, H)):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))
    it, wt = _t(idx)[None], _t(wgt)[None]
    ij, wj = jnp.asarray(idx)[None], jnp.asarray(wgt)[None]
    for depth in (3 * H, 2 * width + 1):
        got = ps._extend_tables(it, wt, depth, mode, row_axis=1)
        want = _one_device(lambda i, w: ref_ps._extend_tables(
            i, w, depth, 1, mode, row_axis=1), 2)(ij, wj)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
        if depth and width > 2 * depth:
            got = ps._phase_tables(it, wt, depth, mode)
            want = _one_device(lambda i, w: tuple(ref_ps._phase_tables(
                i, w, depth, 1, mode)), 2)(ij, wj)
            for a, b in zip(got, want):
                assert a.dtype == _t(np.asarray(b)).dtype
                assert np.array_equal(a.numpy(), np.asarray(b))
    rel = np.random.default_rng(0).integers(-4, 5, (3, 9, 2)).astype(np.int32)
    for axis in (0, 1):
        assert np.array_equal(ps._rebase_rows(_t(rel), row_axis=axis).numpy(),
                              np.asarray(ref_ps._rebase_rows(jnp.asarray(rel),
                                                             row_axis=axis)))


@pytest.mark.parametrize("member_steps,lockstep,s", [
    ((9,), 9, 3), ((9,), 9, 8), ((2,), 2, 4), ((1,), 1, 3), ((5, 9, 1), 9, 4)])
def test_act_schedule_matches_reference(member_steps, lockstep, s):
    a = ps._act_schedule(member_steps, lockstep, s)
    b = ref_ps._act_schedule(member_steps, lockstep, s)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _run_both(g, r, **opts):
    init = np.asarray(ref_initial_state(g.width, g.payload, r.seed))
    want = np.asarray(ref_runtime("pallas_step", **opts).execute(r, init))
    rt = get_runtime("pallas_step", device="cpu", **opts)
    assert rt.dispatches_per_run(g) == \
        ref_runtime("pallas_step", **opts).dispatches_per_run(r)
    return rt.execute(g, init), want


@pytest.mark.parametrize("pattern", HALO)
@pytest.mark.parametrize("S", [2, 3, 8])
def test_blocked_pallas_step_matches_reference(pattern, S):
    g, r = _graphs(pattern)
    outs = {}
    for pipeline in (True, False):
        got, want = _run_both(g, r, steps_per_launch=S, pipeline=pipeline)
        np.testing.assert_allclose(got, want, err_msg=str(pipeline), **COMPUTE_TOL)
        outs[pipeline] = got
    assert np.array_equal(outs[True], outs[False])


@pytest.mark.parametrize("pattern,width,steps,S,opts", [
    ("stencil_1d", 24, 1, 3, {}),                     # T = 1: the body alone
    ("stencil_1d", 24, 2, 8, {}),                     # T = 2: S clamps to 1
    ("dom", 24, 6, 3, {}),                            # (T-1) mod S != 0
    ("nearest", 10, 7, 2, dict(radius=3)),            # W <= 2*S*r: serial
    ("nearest", 5, 9, 3, dict(radius=3)),             # W <= 2r: multi-hop wrap
    ("random_nearest", 24, 9, 3, dict(combine="gather")),
    ("random_nearest", 24, 9, 2, dict(combine="onehot")),
    ("stencil_1d", 24, 9, 3, dict(combine="onehot", kind="memory_bound")),
    ("nearest", 24, 9, 2, dict(kind="memory_bound")),
    ("stencil_1d_periodic", 24, 9, 3, dict(kind="empty")),
])
def test_blocked_edge_cases_match_reference(pattern, width, steps, S, opts):
    opts = dict(opts)
    graph_kw = {k: opts.pop(k) for k in ("radius", "kind") if k in opts}
    kind = graph_kw.pop("kind", "compute_bound")
    g, r = _graphs(pattern, width, steps, kind=kind,
                   iters=0 if kind == "empty" else 2, **graph_kw)
    outs = {}
    for pipeline in (True, False):
        got, want = _run_both(g, r, steps_per_launch=S, pipeline=pipeline, **opts)
        np.testing.assert_allclose(got, want, **_tol(kind))
        outs[pipeline] = got
    assert np.array_equal(outs[True], outs[False])


def test_blocked_dispatches_count_the_launches():
    """1 + ceil((T-1)/S) serial, 1 + 2*ceil((T-1)/S) pipelined: the counts
    the card's launch counters are held to."""
    g = TaskGraph(steps=1000, width=2112, pattern="stencil_1d", payload=4,
                  kernel=KernelSpec("compute_bound", 1))
    assert get_runtime("pallas_step", device="cpu", steps_per_launch=8,
                       pipeline=False).dispatches_per_run(g) == 126
    assert get_runtime("pallas_step", device="cpu",
                       steps_per_launch=8).dispatches_per_run(g) == 251
    assert get_runtime("pallas_step", device="cpu").dispatches_per_run(g) == 1000
