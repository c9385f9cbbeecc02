"""The port's optimizer and gradient quantizer (``repro_torch.optim``)
against the JAX package's, on the CPU.

The reference's ``tests/test_optim.py`` cases run on the port, its two
hypothesis properties as cases over fixed seeds and shapes (hypothesis is
not installed here). Then AdamW's ``update`` is held to the reference's
over 3 steps on the same parameters and gradients (f32 and bf16
parameters, matrices and vectors, a step that clips): parameters, moments
and metrics within rtol=1e-6, atol=1e-7 in f32 (the same f32 arithmetic;
``b ** step`` and the square root may round apart in the last bit), and
bf16 parameters within one bf16 rounding (rtol=8e-3) after each step.
``quantize_int8`` and ``compress_with_feedback`` fed the reference's
``jax.random.uniform`` draws give its ``q`` exactly and its ``scale`` and
residual within 1 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compression as ref_gc
from repro.optim.optimizer import AdamW as RefAdamW
from repro.optim.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch.optim.grad_compression import (
    compress_with_feedback,
    compression_ratio,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.optim.optimizer import AdamW, AdamWConfig, cosine_schedule


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# --------------------------------------------- the reference's cases


def test_adamw_decreases_quadratic_loss():
    opt = AdamW(AdamWConfig(lr=0.05, warmup_steps=1, total_steps=200, weight_decay=0.0))
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = opt.init(params)
    l0 = float(torch.sum(params["w"] ** 2))
    for _ in range(100):
        g = {"w": 2 * params["w"]}  # the gradient of sum(w^2)
        params, state, _ = opt.update(g, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2 * l0


def test_adamw_clipping_bounds_update():
    opt = AdamW(AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=1, weight_decay=0.0))
    params = {"w": torch.zeros((4,))}
    state = opt.init(params)
    new, state, metrics = opt.update({"w": torch.full((4,), 1e6)}, state, params)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    # the clipped gradient has norm 1: an adam step is bounded by lr
    assert float(new["w"].abs().max()) <= 1.1


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lr = cosine_schedule(cfg)
    assert float(lr(0)) == pytest.approx(0.0)
    assert float(lr(torch.tensor(10, dtype=torch.int32))) == pytest.approx(1e-3, rel=1e-3)
    assert float(lr(100)) == pytest.approx(1e-4, rel=1e-2)
    assert float(lr(55)) < 1e-3


def test_weight_decay_applies_to_matrices_only():
    opt = AdamW(AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=1))
    params = {"mat": torch.ones((2, 2)), "vec": torch.ones((2,))}
    state = opt.init(params)
    new, _, _ = opt.update({k: torch.zeros_like(v) for k, v in params.items()},
                           state, params)
    assert bool((new["mat"] < 1.0).all())  # decayed
    np.testing.assert_allclose(new["vec"].numpy(), 1.0)  # not decayed


def test_moments_stay_f32_for_bf16_params():
    opt = AdamW()
    params = {"w": torch.ones((3,), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.m["w"].dtype == torch.float32
    new, state, _ = opt.update({"w": torch.ones((3,), dtype=torch.bfloat16)}, state, params)
    assert new["w"].dtype == torch.bfloat16
    assert state.v["w"].dtype == torch.float32


def test_update_is_in_place_and_reallocates_nothing():
    """A model's modules keep their tensors: each parameter and moment is
    the same tensor, at the same address, after the update."""
    opt = AdamW(AdamWConfig(warmup_steps=1))
    params = {"mat": torch.randn((3, 4), generator=_gen(0)),
              "vec": torch.randn((4,), generator=_gen(1))}
    state = opt.init(params)
    ptrs = {n: p.data_ptr() for n, p in params.items()}
    ids = {n: id(p) for n, p in params.items()}
    before = {n: p.clone() for n, p in params.items()}
    new, state2, _ = opt.update({n: torch.ones_like(p) for n, p in params.items()},
                                state, params)
    assert new is params
    for n, p in params.items():
        assert id(p) == ids[n] and p.data_ptr() == ptrs[n]
        assert not torch.equal(p, before[n])
        assert state2.m[n] is state.m[n]
    assert int(state2.step) == 1


def test_quantize_roundtrip_error_bound():
    x = torch.randn((256,), generator=_gen(0))
    q, scale = quantize_int8(x, _gen(1))
    err = (dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) + 1e-7


def test_error_feedback_accumulates_residual():
    x = torch.full((16,), 0.41)
    q, scale, ef2 = compress_with_feedback(x, torch.zeros((16,)), _gen(0))
    np.testing.assert_allclose((dequantize_int8(q, scale) + ef2).numpy(), x.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 1000])
def test_property_stochastic_rounding_unbiased(seed):
    """E[quantized] == input when averaged over rounding draws."""
    x = torch.full((8,), 0.3)
    gen = _gen(seed)
    recons = [dequantize_int8(*quantize_int8(x, gen)) for _ in range(64)]
    mean = torch.stack(recons).mean(0)
    scale = float(x.abs().max() / 127.0)
    assert float((mean - 0.3).abs().max()) < 0.5 * scale


@pytest.mark.parametrize("scale_exp", [-8, -3, 0, 5, 8])
@pytest.mark.parametrize("shape", [(8,), (4, 4), (2, 3, 5)])
def test_property_quantize_handles_scales(shape, scale_exp):
    x = torch.randn(shape, generator=_gen(0)) * (2.0 ** scale_exp)
    q, s = quantize_int8(x, _gen(1))
    assert q.dtype == torch.int8
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 1.01 + 1e-12


def test_compression_ratio():
    assert compression_ratio() == float(ref_gc.compression_ratio()) == 2.0
    assert compression_ratio(torch.float32) == float(ref_gc.compression_ratio(jnp.float32))


# ------------------------------------------- against the reference


def _params(dtype):
    rng = np.random.default_rng(3)
    return {"mat": rng.standard_normal((5, 7)).astype(dtype),
            "vec": rng.standard_normal((7,)).astype(dtype),
            "stack": rng.standard_normal((2, 3, 4)).astype(dtype)}


@pytest.mark.parametrize("clip", [1.0, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference_over_three_steps(dtype, clip):
    """The same parameters and gradients (a new draw each step) through
    both optimizers; clip 1.0 clips every step, 100.0 never."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip, weight_decay=0.1)
    ref_opt, opt = RefAdamW(RefAdamWConfig(**kw)), AdamW(AdamWConfig(**kw))
    p0 = _params(np.float32)
    ref_p = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    params = {k: _t(v).to(tdt) for k, v in p0.items()}
    ref_state, state = ref_opt.init(ref_p), opt.init(params)
    rng = np.random.default_rng(5)
    tol = dict(rtol=8e-3, atol=1e-6) if dtype == "bfloat16" else dict(rtol=1e-6, atol=1e-7)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        ref_p, ref_state, ref_m = ref_opt.update(
            {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}, ref_state, ref_p)
        params, state, m = opt.update({k: _t(v).to(tdt) for k, v in g.items()},
                                      state, params)
        for k in p0:
            assert params[k].dtype == tdt and state.m[k].dtype == torch.float32
            np.testing.assert_allclose(params[k].float().numpy(),
                                       np.asarray(ref_p[k], np.float32), **tol)
            np.testing.assert_allclose(state.m[k].numpy(), np.asarray(ref_state.m[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(state.v[k].numpy(), np.asarray(ref_state.v[k]),
                                       rtol=1e-5, atol=1e-7)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), float(ref_m[name]), rtol=1e-6)
        assert int(state.step) == int(ref_state.step)


@pytest.mark.parametrize("step", [0, 1, 3, 10, 55, 99, 100, 150])
def test_schedule_matches_the_reference(step):
    from repro.optim.optimizer import cosine_schedule as ref_schedule

    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(ref_schedule(RefAdamWConfig(**cfg))(jnp.int32(step)))
    assert float(cosine_schedule(AdamWConfig(**cfg))(step)) == pytest.approx(
        want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("shape,scale_exp", [((256,), 0), ((4, 4), -6), ((2, 3, 5), 7)])
def test_quantize_matches_the_reference_with_its_uniforms(shape, scale_exp):
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape)) * 2.0 ** scale_exp
    key = jax.random.PRNGKey(1)
    want_q, want_s = ref_gc.quantize_int8(jnp.asarray(x), key)
    uniforms = _t(jax.random.uniform(key, shape))
    q, s = quantize_int8(_t(x), uniforms)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(float(s), float(want_s), rtol=1.2e-7)
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(),
                               np.asarray(ref_gc.dequantize_int8(want_q, want_s)), rtol=1.2e-7)


def test_compress_with_feedback_matches_the_reference_over_steps():
    """Three steps of error feedback, each fed the reference's draw: the
    same int8 payloads, scales and residuals."""
    rng = np.random.default_rng(0)
    ef_ref, ef = jnp.zeros((64,)), torch.zeros((64,))
    for i in range(3):
        g = rng.standard_normal(64).astype(np.float32)
        key = jax.random.PRNGKey(10 + i)
        want_q, want_s, ef_ref = ref_gc.compress_with_feedback(jnp.asarray(g), ef_ref, key)
        q, s, ef = compress_with_feedback(_t(g), ef, _t(jax.random.uniform(key, (64,))))
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_allclose(float(s), float(want_s), rtol=1.2e-7)
        np.testing.assert_allclose(ef.numpy(), np.asarray(ef_ref), rtol=1e-6, atol=1e-9)


def test_uniforms_of_another_shape_are_refused():
    with pytest.raises(ValueError, match="shape"):
        quantize_int8(torch.zeros((4,)), torch.zeros((5,)))
