"""The port's SSM and hybrid serving paths against the JAX package, on the CPU.

``repro_torch.models`` (``ssm`` and ``hybrid`` blocks) and
``repro_torch.launch.serve`` on ``mamba2-130m.reduced()`` (its MLP branch,
d_ff = 128), the same with ``d_ff=0`` (the full config's layout, no MLP)
and ``hymba-1.5b.reduced()`` (attention and SSM heads in parallel, window
8), with the reference's weights (``repro.models.model.Model(cfg).init(
PRNGKey(0))``) carried over by ``params_from_reference``. The reference
runs with ``use_flash=True``: its Pallas kernels (SSD chunk, flash and
decode attention) in interpret mode. Prompts of 12 tokens (chunk 8: the
sequence is padded to 16), 5 (one chunk of T = S = 5) and 2 (shorter than
the conv window: the conv tail is padded). Inputs are drawn with numpy.

Tolerance, f32: one block atol=rtol=1e-5; logits and the caches after
decode rtol=atol=1e-4 (the same sums in another order, through every
layer), as in test_torch_lm.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.launch.serve import _grow_caches as ref_grow
from repro.models import blocks as ref_blocks
from repro.models import ssm as ref_ssm
from repro.models.model import Model as RefModel
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import blocks, ssm
from repro_torch.models.model import (
    Model,
    caches_from_reference,
    caches_to_reference,
    params_from_reference,
)

#: (name, arch, config overrides)
CONFIGS = {
    "mamba2": ("mamba2-130m", {}),
    "mamba2-no-mlp": ("mamba2-130m", {"d_ff": 0}),
    "hymba": ("hymba-1.5b", {}),
}
PROMPTS = [12, 5, 2]
B, STEPS = 2, 6
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(name):
    arch, over = CONFIGS[name]
    return (dataclasses.replace(ref_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ref_params(cfg):
    return _np(RefModel(cfg).init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", params=[(n, p) for n in CONFIGS for p in PROMPTS],
                ids=lambda np_: f"{np_[0]}-prompt{np_[1]}")
def served(request):
    """One prompt batch through both models: the reference's prefill and
    STEPS greedy decode steps (jitted, Pallas in interpret mode), then the
    port's, fed the same tokens."""
    name, prompt = request.param
    cfg, pcfg = _configs(name)
    assert cfg.use_flash
    params = _ref_params(cfg)
    prompts = np.random.default_rng(prompt).integers(0, cfg.vocab, (B, prompt), np.int32)
    capacity = prompt + STEPS + 1

    ref = RefModel(cfg)
    prefill = jax.jit(lambda p, t: ref.prefill(p, {"tokens": t}))
    decode = jax.jit(lambda p, t, n, c: ref.decode_step(p, {"tokens": t}, n, c))
    logits, caches = prefill(params, prompts)
    want = {"prefill": np.asarray(logits), "prefill_caches": _np(caches), "steps": []}
    caches = ref_grow(ref, caches, B, capacity)
    lengths = jnp.full((B,), prompt, jnp.int32)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for _ in range(STEPS):
        lg, caches = decode(params, tok, lengths, caches)
        want["steps"].append((np.asarray(tok), np.asarray(lg)))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        lengths = lengths + 1
    want["caches"] = _np(caches)

    model = Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(pcfg, params))
    got = {"steps": []}
    logits, pc = model.prefill(_t(prompts).long())
    got["prefill"] = logits.numpy()
    got["prefill_caches"] = caches_to_reference(pcfg, pc)
    pc = serve_mod._grow_caches(model, pc, B, capacity)
    lengths = torch.full((B,), prompt, dtype=torch.int32)
    tok = logits.argmax(-1)[:, None]
    for _ in range(STEPS):
        lg, pc = model.decode_step(tok, lengths, pc)
        got["steps"].append((tok.numpy(), lg.numpy()))
        tok = lg.argmax(-1)[:, None]
        lengths = lengths + 1
    got["caches"] = caches_to_reference(pcfg, pc)
    return name, got, want


def _close_tree(got, want, **tol):
    flat_g, tree_g = jax.tree.flatten(got)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, **tol)


def test_prefill_logits_match_the_reference(served):
    _, got, want = served
    np.testing.assert_allclose(got["prefill"], want["prefill"], **LOGIT_TOL)


def test_prefill_caches_match_the_reference(served):
    """The conv tail (padded for a 2-token prompt), the final SSD state and,
    for hymba, the KV cache."""
    _, got, want = served
    _close_tree(got["prefill_caches"], want["prefill_caches"], **LOGIT_TOL)


def test_greedy_decode_matches_the_reference(served):
    """The same tokens at every step, and the logits within 1e-4."""
    _, got, want = served
    for (gt, gl), (wt, wl) in zip(got["steps"], want["steps"]):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_allclose(gl, wl, **LOGIT_TOL)


def test_caches_after_decode_match_the_reference(served):
    _, got, want = served
    _close_tree(got["caches"], want["caches"], **LOGIT_TOL)


def test_caches_round_trip(served):
    name, got, _ = served
    pcfg = _configs(name)[1]
    back = caches_to_reference(pcfg, caches_from_reference(pcfg, got["caches"]))
    _close_tree(back, got["caches"], rtol=0, atol=0)


# ------------------------------------------------------------ the blocks


def _layer0(pcfg, params):
    """Layer 0's parameters of the port's state dict, as a nested dict."""
    p = {}
    for name, t in params_from_reference(pcfg, params).items():
        if name.startswith("layers.0."):
            *path, leaf = name[len("layers.0."):].split(".")
            d = p
            for k in path:
                d = d.setdefault(k, {})
            d[leaf] = t
    return p


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("S", [11, 3])
def test_one_block_matches_the_reference(name, S):
    """The first block of the reduced model, prefill mode: output and cache."""
    cfg, pcfg = _configs(name)
    params = _ref_params(cfg)
    kind = cfg.layer_plan()[0][0][0]
    assert kind in ("ssm", "hybrid")
    p_ref = jax.tree.map(lambda a: a[0], params["group0"]["sub0"])
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S))
    want, wc, _ = ref_blocks.block_fwd(
        jax.tree.map(jnp.asarray, p_ref), jnp.asarray(x), cfg=cfg, kind=kind,
        ctx=ref_blocks.BlockCtx(mode="prefill", positions=jnp.asarray(pos)))
    got, gc, aux = blocks.block_fwd(
        _layer0(pcfg, params), _t(x), cfg=pcfg, kind=kind,
        ctx=blocks.BlockCtx(mode="prefill", positions=_t(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_tree(jax.tree.map(lambda t: t.numpy(), gc), _np(wc), **TOL)
    assert float(aux) == 0.0


def test_ssm_decode_updates_the_cache_in_place():
    """ssm_fwd in decode against the reference's, from a random cache: the
    output and both states match, written into the caller's tensors."""
    cfg, pcfg = _configs("mamba2")
    p = _layer0(pcfg, _ref_params(cfg))["ssm"]
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         _ref_params(cfg)["group0"]["sub0"]["ssm"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in ssm.ssm_cache_init(pcfg, 3, torch.float32, "cpu").items()}
    want, wc = ref_ssm.ssm_fwd(p_ref, jnp.asarray(x), cfg=cfg, mode="decode",
                               cache=jax.tree.map(jnp.asarray, cache))
    mine = {k: _t(v) for k, v in cache.items()}
    got, gc = ssm.ssm_fwd(p, _t(x), cfg=pcfg, mode="decode", cache=mine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "ssd"):
        assert gc[k] is mine[k]
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(wc[k]), **TOL)


# -------------------------------------------------------- the whole slice


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_from_reference_fills_every_parameter(name):
    cfg, pcfg = _configs(name)
    sd = params_from_reference(pcfg, _ref_params(cfg))
    model = Model(pcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, t in model.state_dict().items():
        assert sd[k].shape == t.shape and sd[k].dtype == t.dtype, k
    assert "head" not in sd if pcfg.tie_embeddings else "head" in sd
    assert len(model.layers) == cfg.n_layers
    has_mlp = any(k.endswith("mlp.gate") for k in sd)
    assert has_mlp == (name != "mamba2-no-mlp")


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_serve_reduced_on_the_cpu_is_deterministic_and_healthy(arch):
    cfg = get_config(arch).reduced()
    ops.reset_launch_counts()
    a = serve_mod.serve(cfg, batch=2, prompt_len=12, gen=5, verbose=False, device="cpu")
    b = serve_mod.serve(cfg, batch=2, prompt_len=12, gen=5, verbose=False, device="cpu")
    assert a.tokens.shape == (2, 5)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.healthy and a.tokens_per_s > 0
    assert a.report is not None and a.report.steps == 3
    assert not any(ops.launch_counts().values())


def test_ssm_caches_pass_through_grow_and_attention_caches_grow():
    cfg = get_config("hymba-1.5b").reduced()
    model = Model(cfg, device="cpu")
    _, caches = model.prefill(torch.zeros((2, 6), dtype=torch.long))
    grown = serve_mod._grow_caches(model, caches, 2, 10)
    for c, g in zip(caches, grown):
        assert g["ssm"]["ssd"] is c["ssm"]["ssd"] and g["ssm"]["conv"] is c["ssm"]["conv"]
        assert g["attn"]["k"].shape[2] == 10 and c["attn"]["k"].shape[2] == 6
        assert torch.equal(g["attn"]["k"][:, :, :6], c["attn"]["k"])
        assert not g["attn"]["k"][:, :, 6:].any()
