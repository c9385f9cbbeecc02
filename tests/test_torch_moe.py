"""The port's MoE layer against the JAX package's, on the CPU.

``repro_torch.models.moe`` against ``repro.models.moe`` on the reduced
mixtral-8x7b and granite-moe-3b-a800m configs and on ``tests/test_moe.py``'s
``make_cfg`` shapes, in prefill and decode mode, at capacity factors 8.0
(no drop), 1.25 and 0.5 (drops). The reference's weights (``moe_init``)
are carried over as numpy arrays, inputs are drawn with numpy.

The routing (e_idx, s_idx, keep) is held equal exactly: the reference's is
read off the arguments of its combine (``jax.vmap(degroup)(y, e_idx,
s_idx, gates x keep)``) by a stand-in for the module's ``jax`` that records
each ``vmap`` call and runs it. Output and aux loss within rtol=atol=1e-5
(f32: the same sums in another order). Then the reference's invariants
(``tests/test_moe.py``, ``tests/test_models.py``) on the port alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.models import moe as ref_moe
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import moe
from test_moe import dense_reference, make_cfg

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {
    "mixtral": lambda: ref_config("mixtral-8x7b").reduced(),
    "granite": lambda: ref_config("granite-moe-3b-a800m").reduced(),
    "make_cfg": lambda: make_cfg(),
    "make_cfg_k1": lambda: make_cfg(E=4, K=1),
}
CAPACITY = (8.0, 1.25, 0.5)
# (B, S) per mode: 128 prefill tokens route ~64 assignments to each of 4
# experts, so capacity factor 0.5 (C = 32) drops
SHAPES = {"prefill": (4, 32), "decode": (5, 1)}


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


class _VmapSpy:
    """Stands in for ``jax`` in ``repro.models.moe``: records the arguments
    of each ``jax.vmap(f)(...)`` call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, f):
        def run(*args):
            self.calls.append(args)
            return jax.vmap(f)(*args)
        return run


def _ref_run(monkeypatch, cfg, p, x, mode):
    """The reference's (out, aux) and its routing (e_idx, s_idx, keep)."""
    spy = _VmapSpy()
    monkeypatch.setattr(ref_moe, "jax", spy)
    out, aux = ref_moe.moe_fwd(p, jnp.asarray(x), cfg, mode=mode)
    monkeypatch.undo()
    _, e_idx, s_idx, _ = spy.calls[-1]  # degroup(y, e_idx, s_idx, w)
    e_idx = np.asarray(e_idx)
    return np.asarray(out), float(aux), (e_idx, np.asarray(s_idx), e_idx < cfg.n_experts)


def _params(cfg, seed=0):
    return jax.tree.map(np.asarray, ref_moe.moe_init(jax.random.PRNGKey(seed), cfg,
                                                     jnp.float32))


@pytest.mark.parametrize("mode", sorted(SHAPES))
@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_matches_the_reference(monkeypatch, name, cf, mode):
    cfg = dataclasses.replace(CONFIGS[name](), capacity_factor=cf)
    pcfg = _port_cfg(cfg)
    p = _params(cfg)
    x = np.random.default_rng(1).standard_normal(
        SHAPES[mode] + (cfg.d_model,)).astype(np.float32)
    want, want_aux, (we, ws, wk) = _ref_run(monkeypatch, cfg, p, x, mode)

    pt = {k: _t(v) for k, v in p.items()}
    xt = _t(x)
    r = moe.route(pt, xt.reshape(1, -1, cfg.d_model), pcfg, mode)
    np.testing.assert_array_equal(r.e_idx.numpy(), we)
    np.testing.assert_array_equal(r.s_idx.numpy(), ws)
    np.testing.assert_array_equal(r.keep.numpy(), wk)
    got, aux = moe.moe_fwd(pt, xt, pcfg, mode=mode)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux), want_aux, **TOL)
    if mode == "decode" or cf == 8.0:
        assert wk.all()  # no drop: decode's capacity is exact, 8.0 is ample
    if mode == "prefill" and cf == 0.5:
        assert not wk.all()  # the case drops


def test_routing_ties_take_the_lower_expert_first():
    """jax.lax.top_k's order among equal logits: a zero router ties every
    expert, so top-k picks experts 0..K-1 in both packages."""
    cfg = make_cfg(E=4, K=2)
    p = _params(cfg)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(2).standard_normal((1, 3, cfg.d_model)).astype(np.float32)
    _, top_e = jax.lax.top_k(jnp.asarray(x.reshape(3, -1) @ p["router"]), cfg.top_k)
    r = moe.route({k: _t(v) for k, v in p.items()}, _t(x).reshape(1, 3, -1),
                  _port_cfg(cfg), "prefill")
    np.testing.assert_array_equal(r.e_idx.numpy().reshape(3, 2), np.asarray(top_e))
    np.testing.assert_array_equal(np.asarray(top_e), [[0, 1]] * 3)


def test_capacity_rule():
    cfg = _port_cfg(ref_config("granite-moe-3b-a800m"))
    # the full-size serving prefill: 8 x 1024 tokens, top-8 of 40 at 1.25
    assert moe.capacity(cfg, 8 * 1024, "prefill") == 2048
    assert moe.capacity(cfg, 8, "decode") == 64
    assert moe.capacity(_port_cfg(make_cfg(cf=0.01)), 3, "prefill") == 8  # at least 8
    assert moe.capacity(_port_cfg(make_cfg(E=4, K=2, cf=1.0)), 9, "prefill") == 8
    assert moe.capacity(_port_cfg(make_cfg(E=4, K=2, cf=1.0)), 17, "prefill") == 16


# ------------------------------------------- the reference's invariants


@pytest.mark.parametrize("seed,B,S", [(0, 1, 4), (7, 2, 8), (23, 4, 8), (50, 4, 4)])
def test_no_drops_with_ample_capacity_equals_the_dense_routing(seed, B, S):
    """capacity_factor >= E: no drop, so the port equals the reference's
    per-token dense routing (tests/test_moe.py's dense_reference)."""
    cfg = make_cfg(cf=8.0)
    p = _params(cfg)
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    got, _ = moe.moe_fwd({k: _t(v) for k, v in p.items()}, _t(x), _port_cfg(cfg),
                         mode="prefill")
    want = dense_reference(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_decode_mode_never_drops():
    cfg = make_cfg(cf=0.01)  # absurdly tight prefill capacity
    p = _params(cfg)
    x = np.random.default_rng(4).standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    pt = {k: _t(v) for k, v in p.items()}
    r = moe.route(pt, _t(x).reshape(1, 3, -1), _port_cfg(cfg), "decode")
    assert bool(r.keep.all())
    got, _ = moe.moe_fwd(pt, _t(x), _port_cfg(cfg), mode="decode")
    want = dense_reference(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_capacity_drops_reduce_output_norm():
    p = {k: _t(v) for k, v in _params(make_cfg(cf=8.0)).items()}
    x = _t(np.random.default_rng(3).standard_normal((2, 32, 16)).astype(np.float32))
    out_t, _ = moe.moe_fwd(p, x, _port_cfg(make_cfg(cf=0.25)), mode="prefill")
    out_a, _ = moe.moe_fwd(p, x, _port_cfg(make_cfg(cf=8.0)), mode="prefill")
    assert float(out_t.norm()) < float(out_a.norm())


def test_aux_loss_uniform_routing_lower_than_skewed():
    cfg = _port_cfg(make_cfg(E=4, K=1))
    p = {k: _t(v) for k, v in _params(make_cfg(E=4, K=1)).items()}
    skew = dict(p)
    skew["router"] = torch.zeros_like(p["router"])
    skew["router"][:, 0] = 1.0  # every token to expert 0
    x = _t(np.abs(np.random.default_rng(6).standard_normal((2, 32, 16))).astype(np.float32))
    _, aux_skew = moe.moe_fwd(skew, x, cfg, mode="prefill")
    _, aux_rand = moe.moe_fwd(p, x, cfg, mode="prefill")
    assert float(aux_skew) > float(aux_rand)


def test_moe_aux_loss_nonzero_and_capacity_drops():
    """tests/test_models.py's check on reduced mixtral, on the port."""
    cfg = get_config("mixtral-8x7b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.float32, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    out, aux = moe.moe_fwd(p, x, cfg, mode="prefill")
    assert out.shape == x.shape and float(aux) > 0.0
    out_d, _ = moe.moe_fwd(p, x[:, :1], cfg, mode="decode")
    assert bool(torch.isfinite(out_d).all())


def test_train_mode_is_not_ported():
    """Named when train mode raised; training is ported now: train mode
    routes as the prefill does (capacity_factor's capacity, drops) and is
    differentiable, the reference's gradients held in
    tests/test_torch_train.py."""
    cfg = get_config("mixtral-8x7b").reduced()
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, aux = moe.moe_fwd(p, x, cfg, mode="train")
    want, want_aux = moe.moe_fwd(p, x, cfg, mode="prefill")
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
    (out.square().sum() + aux).backward()
    for k, v in p.items():
        assert v.grad is not None and float(v.grad.abs().max()) > 0, k


def test_moe_forward_syncs_nothing_with_the_host(monkeypatch):
    """A decode step through the MoE captures as a CUDA graph only if it
    never waits on the device: no .item(), .tolist(), nonzero or
    boolean-mask indexing, which all read device values on the host."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn((3, 1, cfg.d_model), generator=torch.Generator().manual_seed(1))

    def refuse(*a, **k):
        raise AssertionError("host sync")

    for name in ("item", "tolist", "nonzero", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    monkeypatch.setattr(torch, "masked_select", refuse)
    for mode in ("decode", "prefill"):
        out, aux = moe.moe_fwd(p, x, cfg, mode=mode)
    monkeypatch.undo()
    assert out.shape == x.shape
