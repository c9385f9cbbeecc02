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
from repro_torch.kernels.taskbench_compute import taskbench_compute
from repro_torch.kernels.taskbench_step import (
    taskbench_step,
    taskbench_step_plain,
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
                                   "taskbench_blocked_tiled": 0, "flash_attention": 0, "flash_attention_f32": 0,
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
