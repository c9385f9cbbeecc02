"""The port's SSD (K7) and RMSNorm (K8) plain versions against the JAX package.

K7: ``ops.ssd_chunk`` (-> ``ref.ssd_chunk_plain`` on the CPU) against
``repro.kernels.ssd_scan.ssd_chunk_pallas`` in interpret mode and
``repro.kernels.ref.ssd_chunk_ref``; the port's ``ops.ssd`` (chunks + the
inter-chunk recurrence) against the reference's ``ops.ssd(use_kernel=True)``
and the token-by-token ``ssd_sequential_ref``; ``ops.ssd_decode_step``
token by token against the sequential oracle. K8: ``ops.rmsnorm`` (->
``ref.rmsnorm_plain``) against ``rmsnorm_pallas`` in interpret mode. Inputs
are drawn with numpy from a seed and handed to both.

Tolerance, f32: rtol=atol=1e-5 (the same sums in another order: einsums
against the TPU kernel's dot_generals, a chunked scan against a
sequential one).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _chunk_inputs(rng, BC, H, G, T, N, P, dta_scale=0.5):
    x = rng.standard_normal((BC, H, T, P)).astype(np.float32)
    b = rng.standard_normal((BC, G, T, N)).astype(np.float32)
    c = rng.standard_normal((BC, G, T, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (BC, H, T)).astype(np.float32)
    dta = -rng.uniform(0.0, dta_scale, (BC, H, T)).astype(np.float32)
    return x, b, c, dta, dt


def _seq_inputs(rng, B, S, H, G, N, P):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    b = rng.standard_normal((B, S, G, N)).astype(np.float32)
    c = rng.standard_normal((B, S, G, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    dta = dt * -rng.uniform(0.5, 2.0, (1, 1, H)).astype(np.float32)
    return x, b, c, dta, dt


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("T", [5, 8, 16])
@pytest.mark.parametrize("N", [8, 16])
def test_ssd_chunk_plain_matches_pallas_and_ref(G, T, N):
    rng = np.random.default_rng(100 * G + 10 * T + N)
    args = _chunk_inputs(rng, 3, 4, G, T, N, 8)
    y, state = ops.ssd_chunk(*map(_t, args))
    assert y.shape == (3, 4, T, 8) and state.shape == (3, 4, N, 8)
    assert y.dtype == state.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in args]
    for wy, ws in (ssd_chunk_pallas(*jargs, interpret=True), jref.ssd_chunk_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(ws), **TOL)


def test_ssd_chunk_plain_keeps_x_dtype_for_y_and_f32_for_the_state():
    x, b, c, dta, dt = (_t(a) for a in _chunk_inputs(np.random.default_rng(1), 2, 2, 1,
                                                      8, 8, 8))
    xb, bb, cb = (t.to(torch.bfloat16) for t in (x, b, c))
    y, state = ops.ssd_chunk(xb, bb, cb, dta, dt)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    yf, sf = ops.ssd_chunk(xb.float(), bb.float(), cb.float(), dta, dt)
    # the same f32 sums, y rounded once to bf16
    assert torch.equal(y, yf.to(torch.bfloat16))
    torch.testing.assert_close(state, sf, rtol=0, atol=0)


def test_very_negative_dta_gives_no_nan():
    """dtA <= -30: exp(a_i - a_j) above the diagonal would overflow; the plain
    version masks the exponent before exp, so everything stays finite."""
    rng = np.random.default_rng(2)
    x, b, c, dta, dt = _chunk_inputs(rng, 2, 2, 1, 16, 8, 8)
    dta[:, :, ::3] = -40.0
    dta[0, 0] = -80.0
    y, state = ops.ssd_chunk(_t(x), _t(b), _t(c), _t(dta), _t(dt))
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    jargs = [jnp.asarray(a) for a in (x, b, c, dta, dt)]
    wy, ws = jref.ssd_chunk_ref(*jargs)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ws), **TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_matches_reference_ssd_and_the_sequential_oracle(chunk, G):
    rng = np.random.default_rng(chunk + G)
    B, S, H, N, P = 2, 32, 4, 8, 8
    args = _seq_inputs(rng, B, S, H, G, N, P)
    y, final = ops.ssd(*map(_t, args), chunk=chunk)
    jargs = [jnp.asarray(a) for a in args]
    for wy, wf in (jops.ssd(*jargs, chunk=chunk, use_kernel=True),
                   jref.ssd_sequential_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(final.numpy(), np.asarray(wf), **TOL)
    sy, sf = ref.ssd_sequential_plain(*map(_t, args))
    torch.testing.assert_close(y, sy, **TOL)
    torch.testing.assert_close(final, sf, **TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_carries_init_state_across_two_halves(chunk):
    rng = np.random.default_rng(10 + chunk)
    B, S, H, G, N, P = 2, 32, 4, 2, 8, 8
    args = [_t(a) for a in _seq_inputs(rng, B, S, H, G, N, P)]
    whole_y, whole_s = ops.ssd(*args, chunk=chunk)
    first = [a[:, :S // 2] for a in args]
    second = [a[:, S // 2:] for a in args]
    y1, s1 = ops.ssd(*first, chunk=chunk)
    y2, s2 = ops.ssd(*second, chunk=chunk, init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), whole_y, **TOL)
    torch.testing.assert_close(s2, whole_s, **TOL)
    jy, js = jops.ssd(*[jnp.asarray(a.numpy()) for a in second], chunk=chunk,
                      init_state=jnp.asarray(s1.numpy()), use_kernel=True)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js), **TOL)


def test_ssd_rejects_a_ragged_sequence():
    args = [_t(a) for a in _seq_inputs(np.random.default_rng(3), 1, 10, 2, 1, 4, 4)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(*args, chunk=4)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches_the_sequential_oracle(G):
    """Token by token from a nonzero state, the state updated in place."""
    rng = np.random.default_rng(20 + G)
    B, S, H, N, P = 2, 7, 4, 8, 8
    x, b, c, dta, dt = _seq_inputs(rng, B, S, H, G, N, P)
    init = rng.standard_normal((B, H, N, P)).astype(np.float32)
    wy, wf = jref.ssd_sequential_ref(*(jnp.asarray(a) for a in (x, b, c, dta, dt)),
                                     init_state=jnp.asarray(init))
    state = _t(init)
    buf = state.data_ptr()
    for t in range(S):
        state, yt = ops.ssd_decode_step(state, _t(x[:, t]), _t(b[:, t]), _t(c[:, t]),
                                        _t(dta[:, t]), _t(dt[:, t]))
        np.testing.assert_allclose(yt.numpy(), np.asarray(wy)[:, t], **TOL)
    assert state.data_ptr() == buf
    np.testing.assert_allclose(state.numpy(), np.asarray(wf), **TOL)


@pytest.mark.parametrize("rows,d", [(7, 100), (16, 64), (3, 300)])
def test_rmsnorm_plain_matches_pallas(rows, d):
    """d not a multiple of 128: the TPU kernel pads and divides by the true d."""
    rng = np.random.default_rng(rows * d)
    x = rng.standard_normal((rows, d)).astype(np.float32) * 3.0
    w = rng.standard_normal(d).astype(np.float32)
    got = ops.rmsnorm(_t(x), _t(w), 1e-5)
    want = rmsnorm_pallas(jnp.asarray(x), jnp.asarray(w), eps=1e-5, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.rmsnorm_ref(
        jnp.asarray(x), jnp.asarray(w), 1e-5)), **TOL)


def test_rmsnorm_keeps_x_dtype_and_takes_any_leading_shape():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    got = ops.rmsnorm(x.to(torch.bfloat16), w)
    assert got.shape == (2, 3, 40) and got.dtype == torch.bfloat16
    want = ops.rmsnorm(x.to(torch.bfloat16).float(), w).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(ops.rmsnorm(x, w, use_kernel=False), ops.rmsnorm(x, w))


def test_cpu_wrappers_launch_nothing():
    ops.reset_launch_counts()
    args = [_t(a) for a in _chunk_inputs(np.random.default_rng(5), 1, 2, 1, 4, 4, 4)]
    ops.ssd_chunk(*args)
    ops.rmsnorm(args[0], torch.ones(4))
    counts = ops.launch_counts()
    assert counts["ssd_chunk"] == counts["rmsnorm"] == 0
