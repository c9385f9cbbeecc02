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

K7's arithmetic on the card, emulated here in plain PyTorch: its two head
products run on the TF32 tensor cores with each f32 operand split into
TF32 parts (three for Y, two for the state: hi hi + hi lo + lo hi). The emulation is held to
the JAX kernel within the card check's tolerance, 2e-5 of the output's
scale, max(1, max |reference|); one TF32 rounding of each operand is shown
to miss it, which is why the kernel splits. K8's choice of its 16-byte
vector path (``rmsnorm.vector_width``) is tested on CPU tensors.
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
from repro_torch.kernels.rmsnorm import vector_width

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_F32_SCALED = 2e-5  # chip_smoke.py's K7/K8 tolerance, of max(1, max |want|)


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


# ------------------------------------------------ K7's TF32 split, emulated


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the card's cvt.rna.tf32.f32 does: to nearest,
    ties away from zero (half a TF32 ulp added to the magnitude bits), then
    the 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _parts(x: torch.Tensor, n: int):
    """x as n TF32 parts: rna(x), then rna of what is left, and so on."""
    out = []
    for _ in range(n):
        out.append(_tf32(x))
        x = x - out[-1]
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """a @ b with TF32 operands and f32 sums, each operand in ``parts``
    TF32 parts and the terms the kernel takes: hi hi (1 part); + hi lo +
    lo hi (2); + hi mid + mid hi + mid mid + hi lo + lo hi (3)."""
    pa, pb = _parts(a, parts), _parts(b, parts)
    return sum(pa[i] @ pb[j] for i in range(parts) for j in range(parts)
               if i + j < parts)


def _ssd_chunk_tf32(x, b, c, dta, dt, split: bool = True):
    """K7's arithmetic on f32 inputs (as csrc/ssd_chunk.cu takes it): C B^T
    once per group in f32, Y as scores (X * dt) with three TF32 parts of
    each operand, the state as (B * exp(a_T - a))^T (X * dt) with two; one
    part each without ``split``."""
    T = x.shape[2]
    ratio = x.shape[1] // b.shape[1]
    a = torch.empty_like(dta)
    run = torch.zeros_like(dta[..., 0])
    for t in range(T):  # token order, as the kernel's one lane per head
        run = run + dta[..., t]
        a[..., t] = run
    cbt = (c @ b.transpose(-1, -2)).repeat_interleave(ratio, dim=1)
    causal = torch.ones((T, T), dtype=torch.bool).tril()
    decay = torch.exp(torch.where(causal, a[..., :, None] - a[..., None, :], float("-inf")))
    xdt = x * dt[..., None]
    y = _mm(cbt * decay, xdt, 3 if split else 1)
    bw = b.repeat_interleave(ratio, dim=1) * torch.exp(a[..., -1:] - a)[..., None]
    return y, _mm(bw.transpose(-1, -2), xdt, 2 if split else 1)


def _scaled_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / max(1.0, np.abs(want).max()))


# the reduced mamba2-130m's chunks (2 x 12-token prompts padded to 2 chunks
# of 8, 16 heads of 8, state 8) and a two-group case, against the JAX
# kernel; and one chunk at full width (T = N = 128, P = 64) against the
# port's plain version. Each has some dtA = -35 (a decay that underflows).
# At T = 128 the JAX kernel's cumsum associates differently from the token
# order K7 and its plain version keep, which alone moves its outputs ~3e-5
# of the scale, so the full-width case is held to the plain version, as
# chip_smoke.py holds the kernel.
REDUCED_SHAPES = [(4, 16, 1, 8, 8, 8), (3, 4, 2, 16, 8, 8)]
FULL_SHAPE = (1, 2, 1, 128, 128, 64)


def _k7_inputs(shape, seed):
    BC, H, G, T, N, P = shape
    rng = np.random.default_rng(seed)
    x, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((BC, H, T, P), (BC, G, T, N), (BC, G, T, N)))
    dt = rng.uniform(0.001, 0.1, (BC, H, T)).astype(np.float32)
    dta = dt * -rng.uniform(1.0, 16.0, (1, H, 1)).astype(np.float32)
    dta[:, :, ::7] = -35.0
    return x, b, c, dta, dt


def _k7_reference(shape, args):
    if shape == FULL_SHAPE:
        return [t.numpy().astype(np.float64) for t in ref.ssd_chunk_plain(*map(_t, args))]
    wy, ws = ssd_chunk_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    return np.asarray(wy, np.float64), np.asarray(ws, np.float64)


@pytest.mark.parametrize("shape", REDUCED_SHAPES + [FULL_SHAPE])
def test_tf32_split_arithmetic_meets_the_card_tolerance(shape):
    args = _k7_inputs(shape, sum(shape))
    y, state = _ssd_chunk_tf32(*map(_t, args))
    wy, ws = _k7_reference(shape, args)
    assert _scaled_err(y.numpy(), wy) <= TOL_F32_SCALED
    assert _scaled_err(state.numpy(), ws) <= TOL_F32_SCALED


@pytest.mark.parametrize("shape", REDUCED_SHAPES + [FULL_SHAPE])
def test_one_tf32_rounding_misses_the_card_tolerance(shape):
    """Without the residual products the same arithmetic is off by ~5e-4
    of the scale: the split is what lets K7 use the tensor cores."""
    args = _k7_inputs(shape, sum(shape))
    y, state = _ssd_chunk_tf32(*map(_t, args), split=False)
    wy, ws = _k7_reference(shape, args)
    err = max(_scaled_err(y.numpy(), wy), _scaled_err(state.numpy(), ws))
    assert err > 2 * TOL_F32_SCALED


def test_tf32_rounding_matches_the_card_rule():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -12),
                      3.0e-3, -7.5, 0.0])
    h = _tf32(x)
    # ties round away from zero; the result has 10 explicit mantissa bits
    assert h.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)]
    assert torch.equal(h[-2:], x[-2:])
    assert ((h.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x - h).abs() <= x.abs() * 2.0 ** -11).all()


# ------------------------------------------------- K8's vector path choice


@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 8), (torch.float32, 4)])
@pytest.mark.parametrize("d", [768, 1536, 1000, 8192])
def test_rmsnorm_vector_width_on_aligned_rows(dtype, width, d):
    x, w = torch.zeros((5, d), dtype=dtype), torch.ones(d)
    assert x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    assert vector_width(x, w) == width
    assert vector_width(x, w.to(torch.bfloat16)) == width  # w's dtype does not decide


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [33, 5, 1002, 770])
def test_rmsnorm_vector_width_falls_back_on_ragged_rows(dtype, d):
    """d not a multiple of 16 bytes of x: rows start unaligned, the scalar
    path (770 and 1002 are multiples of 4 f32 but not of 8 bf16)."""
    x, w = torch.zeros((3, d), dtype=dtype), torch.ones(d)
    want = 16 // x.element_size() if d % (16 // x.element_size()) == 0 else 1
    assert vector_width(x, w) == want
    if dtype == torch.bfloat16:
        assert want == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_vector_width_falls_back_off_alignment(dtype):
    """A contiguous view one element into its storage, or a w view at an
    odd offset, is not 16-byte aligned: the scalar path."""
    x = torch.zeros(4 * 768 + 1, dtype=dtype)[1:].view(4, 768)
    w = torch.ones(769)
    assert x.is_contiguous() and vector_width(x, w[:768]) == 1
    xa = x.clone()
    assert vector_width(xa, w[:768]) == 16 // xa.element_size()
    assert vector_width(xa, w[1:]) == 1
