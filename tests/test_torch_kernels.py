"""Kernel-module parity of the PyTorch port with the JAX package, on the CPU.

Each plain body and the megakernel's plain version are held against
``repro.kernels.ops`` (Pallas in interpret mode) and the ``ref.py`` oracles
of both packages, on the same numpy inputs. The CUDA kernels themselves run
only on the card (tests/test_torch_gpu.py). Tolerances: compute_bound
``rtol=1e-5, atol=1e-6``; memory_bound ``atol=1e-5`` (the sweep's mean is
summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.bodies import (
    apply_body,
    fma_body,
    memory_bound,
    memory_sweep_body,
)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_chunk
from repro_torch.core.runtimes.pallas_step import _extend_rows, _extend_state
from repro_torch.kernels.launch_plan import FILL, VEC, cut_ctas
from repro_torch.kernels.taskbench_compute import compute_plan, taskbench_compute
from repro_torch.kernels.taskbench_step import (
    step_plan,
    taskbench_step,
    taskbench_step_plain,
    wrap_rows,
)

COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(0.1, 1.0, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("rows,payload", [(7, 5), (33, 70)])
@pytest.mark.parametrize("iters", [0, 1, 7, 64])
def test_compute_body_matches_reference(rows, payload, iters):
    x = _x((rows, payload))
    want = np.asarray(ref_ops.taskbench_compute(jnp.asarray(x), iters))
    np.testing.assert_allclose(ops.taskbench_compute(_t(x), iters).numpy(), want,
                               **COMPUTE_TOL)
    np.testing.assert_allclose(fma_body(_t(x), iters).numpy(), want, **COMPUTE_TOL)
    np.testing.assert_allclose(ref.taskbench_compute_ref(_t(x), iters).numpy(),
                               np.asarray(jref.taskbench_compute_ref(jnp.asarray(x), iters)),
                               **COMPUTE_TOL)


@pytest.mark.parametrize("rows,payload", [(4, 16), (33, 7)])
@pytest.mark.parametrize("iters,scratch", [(0, 64), (3, 64), (7, 100), (2, 5)])
def test_memory_body_matches_reference(rows, payload, iters, scratch):
    x = _x((rows, payload), 1)
    want = np.asarray(ref_ops.taskbench_memory(jnp.asarray(x), iters, scratch))
    got = ops.taskbench_memory(_t(x), iters, scratch).numpy()
    np.testing.assert_allclose(got, want, **MEMORY_TOL)
    np.testing.assert_allclose(apply_body(_t(x), "memory_bound", iters, scratch).numpy(),
                               want, **MEMORY_TOL)
    np.testing.assert_allclose(ref.taskbench_memory_ref(_t(x), iters, scratch).numpy(),
                               np.asarray(jref.taskbench_memory_ref(jnp.asarray(x), iters,
                                                                    scratch)),
                               **MEMORY_TOL)
    if iters:
        np.testing.assert_allclose(memory_sweep_body(_t(x), iters, scratch).numpy(),
                                   want, **MEMORY_TOL)


def _step_operands(combine, K, W, D, seed):
    """Random (src, idx, wgt) in the layout each combine mode reads, with
    duplicate slots (the onehot merge) and self-padded zero-dep rows."""
    rng = np.random.default_rng(seed)
    S = 2 * W if combine == "pair" else W + D - 1
    src = _x((K, S, 6), seed)
    idx = rng.integers(0, S, (K, W, D)).astype(np.int32)
    idx[:, ::3, 1] = idx[:, ::3, 0]
    wgt = (rng.uniform(0, 1, (K, W, D)) / D).astype(np.float32)
    wgt[:, 1::4, 1:] = 0.0
    return src, idx, wgt


@pytest.mark.parametrize("combine", ["window", "gather", "onehot", "pair"])
@pytest.mark.parametrize("kind,iters", [("compute_bound", 5), ("memory_bound", 3),
                                        ("empty", 0)])
@pytest.mark.parametrize("K", [1, 3])
def test_step_plain_matches_reference_megakernel(combine, kind, iters, K):
    src, idx, wgt = _step_operands(combine, K, 9, 3, seed=K)
    kw = dict(kind=kind, iterations=iters, scratch=20, combine=combine)
    want = np.asarray(ref_ops.taskbench_step(
        jnp.asarray(src), jnp.asarray(idx), jnp.asarray(wgt), **kw))
    got = ops.taskbench_step(_t(src), _t(idx), _t(wgt), **kw).numpy()
    tol = MEMORY_TOL if kind == "memory_bound" else COMPUTE_TOL
    np.testing.assert_allclose(got, want, **tol)
    if combine == "gather":
        oracle = ref.taskbench_step_ref(_t(src), _t(idx), _t(wgt), kind=kind,
                                        iterations=iters, scratch=20).numpy()
        np.testing.assert_allclose(oracle, np.asarray(jref.taskbench_step_ref(
            jnp.asarray(src), jnp.asarray(idx), jnp.asarray(wgt), kind=kind,
            iterations=iters, scratch=20)), **tol)
        np.testing.assert_allclose(got, oracle, **tol)


def _wrap_operands(combine, K, W, H, seed):
    """(state (K, W, 6), idx, wgt) for a step on the state's halo extension
    of W + 2H rows: a window of D = 2H + 1, or D = 2H + 1 slots drawn from
    past both ends of the extended length (the index rule's wrap, clamp and
    drop), every third row's first two slots equal."""
    rng = np.random.default_rng(seed)
    D, S = 2 * H + 1, W + 2 * H
    state = _x((K, W, 6), seed)
    idx = rng.integers(-S - 2, S + 3, (K, W, D)).astype(np.int32)
    idx[:, ::3, 1] = idx[:, ::3, 0]
    wgt = (rng.uniform(0, 1, (K, W, D)) / D).astype(np.float32)
    return state, idx, wgt


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("kind,iters", [("compute_bound", 5), ("memory_bound", 3),
                                        ("empty", 0)])
@pytest.mark.parametrize("W,H", [(9, 1), (7, 2), (4, 2), (3, 2), (2, 2), (1, 2), (1, 1)])
def test_step_with_wrap_equals_extend_then_step(combine, kind, iters, W, H):
    """The plain K3 with ``wrap=H`` on the state is `_extend_state` and the
    plain K3, bit for bit, also at W <= 2H and on out-of-range indices; and
    both match the reference's step on the extended source."""
    state, idx, wgt = _wrap_operands(combine, 2, W, H, W + H)
    kw = dict(kind=kind, iterations=iters, scratch=20, combine=combine)
    rows = torch.from_numpy(_extend_rows(W, H))
    ext = _extend_state(_t(state), rows)
    want = taskbench_step_plain(ext, _t(idx), _t(wgt), **kw)
    assert torch.equal(taskbench_step_plain(_t(state), _t(idx), _t(wgt), wrap=H, **kw),
                       want)
    assert torch.equal(ops.taskbench_step(_t(state), _t(idx), _t(wgt), wrap=H, **kw),
                       want)
    ref_out = np.asarray(ref_ops.taskbench_step(
        jnp.asarray(ext.numpy()), jnp.asarray(idx), jnp.asarray(wgt), **kw))
    tol = MEMORY_TOL if kind == "memory_bound" else COMPUTE_TOL
    np.testing.assert_allclose(want.numpy(), ref_out, **tol)


@pytest.mark.parametrize("case,match", [
    (dict(steps_per_launch=3), "steps_per_launch = 1"),
    (dict(wrap=-1), "wrap must be >= 0"),
    (dict(combine="pair"), "pair combine takes no wrap"),
    (dict(width=5), "src rows 5 != table rows W = 4"),
    (dict(D=5), "window combine needs src rows >= W \\+ D - 1 = 8"),
])
def test_step_wrap_refusals(case, match):
    """``wrap`` is K3's: refused at steps_per_launch > 1, below 0, with
    pair, on a src whose rows are not the tables' W, and where the window
    reaches past the W + 2 * wrap extended rows."""
    W, D = 4, case.pop("D", 3)
    src = torch.ones((1, case.pop("width", W), 6))
    idx = torch.zeros((1, W, D), dtype=torch.int32)
    wgt = torch.ones((1, W, D))
    kw = dict(dict(combine="window", wrap=1), **case)
    act = torch.ones((1, 3)) if kw.get("steps_per_launch", 1) > 1 else None
    with pytest.raises(ValueError, match=match):
        ops.taskbench_step(src, idx, wgt, act, **kw)


@pytest.mark.parametrize("W,H,axis", [(5, 1, 1), (5, 1, 0), (3, 4, 1), (1, 2, 0),
                                    (6, 0, 1)])
def test_wrap_rows_extends_along_either_axis(W, H, axis):
    """`wrap_rows`: position p of the W + 2H extended rows is row (p - H) mod
    W, along the state's row axis (1) or a table's (0), past one ring too."""
    x = _x((W, W, 3), W + H)
    want = np.take(x, [(p - H) % W for p in range(W + 2 * H)], axis=axis)
    assert torch.equal(wrap_rows(_t(x), H, axis), _t(want))


@pytest.mark.parametrize("items,groups", [(2112, 1), (33792, 1), (1048576, 1), (121, 1),
                                          (2112, 3), (1, 1), (131, 1), (2200, 1),
                                          (40000, 2)])
def test_cut_covers_every_thread_once_and_fills_the_sms(items, groups):
    """`cut_ctas`: each group's threads cut into CTAs that cover [0, items)
    exactly once; at least one CTA an SM whenever there are threads for
    every SM; at most 256 threads a CTA."""
    sms = 132
    threads, ctas = cut_ctas(items, sms, groups)
    per_group = ctas // groups
    assert ctas == groups * per_group and 1 <= threads <= 256
    ids = (np.arange(per_group)[:, None] * threads + np.arange(threads)[None, :]).ravel()
    assert np.array_equal(np.sort(ids[ids < items]), np.arange(items))
    assert (per_group - 1) * threads < items  # no CTA without work
    if items * groups >= sms:
        assert ctas >= sms


@pytest.mark.parametrize("n", [132 * 64, 2112 * 64, 65536 * 64, 481, 132 * FILL - 1,
                               132 * FILL, 65537 * 13])
def test_compute_plan_takes_four_chains_only_where_they_fill_the_card(n):
    """K1: 4 elements a thread (16-byte accesses) where every SM gets FILL
    elements, 1 below that; its threads cover the elements once; at 132 x
    64 every SM gets a CTA."""
    plan = compute_plan(n, 132)
    assert plan.chains == (VEC if n >= 132 * FILL else 1)
    items = -(-n // plan.chains)
    assert (plan.threads, plan.ctas) == cut_ctas(items, 132)
    assert plan.ctas * plan.threads * plan.chains >= n
    if n == 132 * 64:
        assert plan.ctas >= 132 and plan.chains == 1


@pytest.mark.parametrize("W,P", [(132, 64), (2112, 64), (45, 13), (132, 13), (7, 1),
                                 (5281, 13)])
def test_step_plan_covers_every_element_once(W, P):
    """K3's compute launch: thread t owns row t // Q and columns C (t % Q)
    .. + C - 1 (C the plan's chains, Q = ceil(P / C)), the columns past P
    masked, so the plan's threads cover each (row, column) exactly once;
    at W = 132 every SM gets a CTA."""
    plan = step_plan(1, W, P, 132)
    C = plan.chains
    assert C == (VEC if W * P >= 132 * FILL else 1)
    Q = -(-P // C)
    t = np.arange(plan.ctas * plan.threads)
    t = t[t < W * Q]
    rows = np.repeat(t // Q, C)
    cols = (np.repeat(t % Q, C) * C + np.tile(np.arange(C), len(t)))
    keep = cols < P
    flat = np.sort(rows[keep] * P + cols[keep])
    assert np.array_equal(flat, np.arange(W * P))
    if W == 132:
        assert plan.ctas >= 132


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("case", [
    # (combine, src shape, idx shape, wgt shape)
    ("bogus", (1, 6, 4), (1, 4, 3), (1, 4, 3)),
    ("gather", (6, 4), (1, 4, 3), (1, 4, 3)),        # src rank
    ("gather", (1, 6, 4), (1, 4, 3), (4, 3)),         # wgt rank
    ("gather", (2, 6, 4), (1, 4, 3), (1, 4, 3)),      # K mismatch
    ("pair", (1, 7, 4), (1, 4, 1), (1, 4, 1)),        # pair: S != 2W
    ("gather", (1, 6, 4), (1, 4, 2), (1, 4, 3)),      # idx/wgt mismatch
    ("onehot", (1, 6, 4), (1, 3, 3), (1, 4, 3)),
    ("window", (1, 5, 4), (1, 4, 3), (1, 4, 3)),      # window: S < W + D - 1
    ("gather", (1, 6, 4), (1, 2, 4, 3), (1, 2, 4, 3)),  # time-varying at S=1
])
def test_step_shape_checks_match_reference(case):
    combine, s, i, w = case
    src, idx, wgt = np.zeros(s, np.float32), np.zeros(i, np.int32), np.ones(w, np.float32)
    want = _error(lambda: ref_ops.taskbench_step(
        jnp.asarray(src), jnp.asarray(idx), jnp.asarray(wgt), combine=combine))
    got = _error(lambda: ops.taskbench_step(_t(src), _t(idx), _t(wgt), combine=combine))
    assert got == want


def test_step_blocked_is_not_ported():
    """The blocked path's refusals carry the reference's messages: a depth
    below 1, no act mask, time-varying tables at one step, pair."""
    src, idx, wgt = _step_operands("gather", 1, 4, 2, 0)
    act = np.ones((1, 3), np.float32)
    for args, kw in [((src, idx, wgt, None), dict(steps_per_launch=0)),
                     ((src, idx, wgt, None), dict(steps_per_launch=3)),
                     ((src, idx[:, None], wgt[:, None], None), {}),
                     ((src[:, :4], idx, wgt, act), dict(steps_per_launch=3,
                                                        combine="pair"))]:
        want = _error(lambda: ref_ops.taskbench_step(
            *(None if a is None else jnp.asarray(a) for a in args), **kw))
        got = _error(lambda: ops.taskbench_step(
            *(None if a is None else _t(a) for a in args), **kw))
        assert got == want


def test_kernel_wrappers_refuse_cpu_tensors_without_launching():
    """No fallback: the CUDA wrappers take card tensors only, and nothing
    is counted as launched when they refuse."""
    ops.reset_launch_counts()
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        taskbench_compute(x, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        memory_bound(x, 3, 16)
    src, idx, wgt = (_t(a) for a in _step_operands("gather", 1, 4, 2, 0))
    with pytest.raises(ValueError, match="CUDA device"):
        taskbench_step(src, idx, wgt, combine="gather")
    act = torch.ones(1, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        taskbench_step(src[:, :4], idx, wgt, act, combine="gather", steps_per_launch=3)
    with pytest.raises(ValueError, match="CUDA device"):
        taskbench_step(src[:, :4], idx, wgt, act, combine="gather", steps_per_launch=3,
                       radius=2)
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(*(q.bfloat16(),) * 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention(q[:, :, 0], q, q, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_chunk(q, q[:, :1], q[:, :1], q[..., 0], q[..., 0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        rmsnorm(x, torch.ones(8))
    assert ops.launch_counts() == {"taskbench_compute": 0, "memory_bound": 0,
                                   "taskbench_step": 0, "taskbench_blocked": 0,
                                   "taskbench_blocked_tiled": 0,
                                   "taskbench_blocked_resident": 0, "flash_attention": 0,
                                   "flash_attention_f32": 0,
                                   "decode_attention": 0, "ssd_chunk": 0,
                                   "rmsnorm": 0}


def test_ops_route_cpu_tensors_to_the_plain_versions():
    x = _t(_x((5, 3)))
    assert torch.equal(ops.taskbench_compute(x, 4), fma_body(x, 4))
    assert torch.equal(ops.taskbench_memory(x, 2, 7), memory_sweep_body(x, 2, 7))
    assert torch.equal(ops.taskbench_memory(x, 0, 7), x)
    src, idx, wgt = (_t(a) for a in _step_operands("onehot", 2, 4, 3, 1))
    assert torch.equal(ops.taskbench_step(src, idx, wgt, combine="onehot"),
                       taskbench_step_plain(src, idx, wgt, combine="onehot"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.taskbench_compute(x.to("meta"), 1)


def test_scratch_beyond_shared_memory_raises():
    src, idx, wgt = (_t(a) for a in _step_operands("gather", 1, 4, 2, 0))
    with pytest.raises(ValueError, match="shared memory"):
        ops.taskbench_step(src, idx, wgt, kind="memory_bound", iterations=1,
                           scratch=40000, combine="gather")


def test_library_paths_follow_the_sources():
    p = _build.library_path("taskbench_step")
    assert p.name == "libtaskbench_step.so"
    assert p.parent.parent == _build.BUILD_ROOT
    assert {lib for lib, _ in (*_build.ENTRIES.values(), *_build.PROBES.values())} == {
        f.stem for f in _build.CSRC.glob("*.cu")}
    jax.block_until_ready(jnp.zeros(1))  # JAX stays on the CPU here
    assert jax.default_backend() == "cpu"
