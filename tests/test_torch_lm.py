"""The port's LM serving path against the JAX package, on the CPU.

``repro_torch.models`` and ``repro_torch.launch.serve`` on
``internlm2-1.8b.reduced()`` and ``gemma3-4b.reduced()`` (local/global
windows, qk-norm, tied embeddings), with the reference's weights
(``repro.models.model.Model(cfg).init(PRNGKey(0))``) carried over by
``params_from_reference``. The reference runs with ``use_flash=True``:
its Pallas kernels in interpret mode. Inputs are drawn with numpy.

Tolerance, f32: layers and one block atol=rtol=1e-5; logits
rtol=atol=1e-4 (the same sums in another order, through every layer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.launch.serve import _grow_caches as ref_grow
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models import layers as ref_layers
from repro.models.model import Model as RefModel
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention, blocks, layers
from repro_torch.models.model import (
    Model,
    caches_from_reference,
    caches_to_reference,
    params_from_reference,
)

ARCH_NAMES = ["internlm2-1.8b", "gemma3-4b"]
B, PROMPT, STEPS = 2, 12, 6
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ref_params(cfg):
    return _np(RefModel(cfg).init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", params=ARCH_NAMES)
def served(request):
    """One prompt batch through both models: the reference's prefill and
    STEPS greedy decode steps (jitted, Pallas in interpret mode), then the
    port's, fed the same tokens."""
    cfg = ref_config(request.param).reduced()
    assert cfg.use_flash
    params = _ref_params(cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, PROMPT), np.int32)
    capacity = PROMPT + STEPS + 1

    ref = RefModel(cfg)
    prefill = jax.jit(lambda p, t: ref.prefill(p, {"tokens": t}))
    decode = jax.jit(lambda p, t, n, c: ref.decode_step(p, {"tokens": t}, n, c))
    logits, caches = prefill(params, prompts)
    want = {"prefill": np.asarray(logits), "prefill_caches": _np(caches), "steps": []}
    caches = ref_grow(ref, caches, B, capacity)
    lengths = jnp.full((B,), PROMPT, jnp.int32)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for _ in range(STEPS):
        lg, caches = decode(params, tok, lengths, caches)
        want["steps"].append((np.asarray(tok), np.asarray(lg)))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        lengths = lengths + 1
    want["caches"] = _np(caches)

    pcfg = get_config(request.param).reduced()
    model = Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(pcfg, params))
    got = {"steps": []}
    logits, pc = model.prefill(_t(prompts).long())
    got["prefill"] = logits.numpy()
    got["prefill_caches"] = caches_to_reference(pcfg, pc)
    pc = serve_mod._grow_caches(model, pc, B, capacity)
    lengths = torch.full((B,), PROMPT, dtype=torch.int32)
    tok = logits.argmax(-1)[:, None]
    for _ in range(STEPS):
        lg, pc = model.decode_step(tok, lengths, pc)
        got["steps"].append((tok.numpy(), lg.numpy()))
        tok = lg.argmax(-1)[:, None]
        lengths = lengths + 1
    got["caches"] = caches_to_reference(pcfg, pc)
    return cfg, got, want


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
    _, got, want = served
    _close_tree(got["prefill_caches"], want["prefill_caches"], **TOL)


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
    cfg, got, _ = served
    pcfg = get_config(cfg.name).reduced()
    back = caches_to_reference(pcfg, caches_from_reference(pcfg, got["caches"]))
    _close_tree(back, got["caches"], rtol=0, atol=0)


# ------------------------------------------------------------ the layers


def test_rope_and_rmsnorm_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rope(_t(x), _t(pos), 1e4).numpy(),
        np.asarray(ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-4)  # angles up to 2000 rad: f32 cos/sin to ~1e-4
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm_fwd(_t(w), _t(x), 1e-5).numpy(),
        np.asarray(ref_layers.rmsnorm_fwd(jnp.asarray(w), jnp.asarray(x), 1e-5)), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.rmsnorm_fwd(_t(w), xb, 1e-5).dtype == torch.bfloat16
    assert layers.rope(xb, _t(pos), 1e4).dtype == torch.bfloat16


def test_mlp_matches_the_reference():
    rng = np.random.default_rng(1)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("gate", (16, 40)), ("up", (16, 40)), ("down", (40, 16)))}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    got = layers.mlp_fwd({k: _t(v) for k, v in p.items()}, _t(x))
    want = ref_layers.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_one_block_matches_the_reference(arch):
    """The first block of the reduced model, prefill mode: output and cache."""
    cfg = ref_config(arch).reduced()
    pcfg = get_config(arch).reduced()
    params = _ref_params(cfg)
    kind = cfg.layer_plan()[0][0][0]
    p_ref = jax.tree.map(lambda a: a[0], params["group0"]["sub0"])
    sd = params_from_reference(pcfg, params)
    p = {}
    for name, t in sd.items():
        if name.startswith("layers.0."):
            *path, leaf = name[len("layers.0."):].split(".")
            d = p
            for k in path:
                d = d.setdefault(k, {})
            d[leaf] = t
    x = np.random.default_rng(2).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    want, wc, _ = ref_blocks.block_fwd(
        jax.tree.map(jnp.asarray, p_ref), jnp.asarray(x), cfg=cfg, kind=kind,
        ctx=ref_blocks.BlockCtx(mode="prefill", positions=jnp.asarray(pos)))
    got, gc, aux = blocks.block_fwd(
        p, _t(x), cfg=pcfg, kind=kind,
        ctx=blocks.BlockCtx(mode="prefill", positions=_t(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_tree({k: v.numpy() for k, v in gc["attn"].items()}, _np(wc["attn"]), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch,kind", [("internlm2-1.8b", "attn"),
                                       ("gemma3-4b", "local"), ("gemma3-4b", "global")])
def test_decode_writes_at_lengths_and_clamps_a_full_cache(arch, kind):
    """attn_fwd in decode: the token goes to position lengths[b]; at
    lengths == capacity JAX's dynamic_update_slice clamps the start to the
    last slot, and the port does the same."""
    cfg = ref_config(arch).reduced()
    pcfg = get_config(arch).reduced()
    rng = np.random.default_rng(4)
    S, hd = 10, cfg.head_dim_
    p = jax.tree.map(lambda a: a[0], _ref_params(cfg)["group0"]["sub0"]["attn"])
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    cache = {n: rng.standard_normal((3, cfg.n_kv_heads, S, hd)).astype(np.float32)
             for n in ("k", "v")}
    lengths = np.array([3, S - 1, S], np.int32)
    want, wc = ref_attn.attn_fwd(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg=cfg, kind=kind, mode="decode",
        positions=jnp.asarray(lengths[:, None]),
        cache=jax.tree.map(jnp.asarray, cache), lengths=jnp.asarray(lengths))
    got, gc = attention.attn_fwd(
        {k: _t(v) for k, v in p.items()}, _t(x), cfg=pcfg, kind=kind, mode="decode",
        positions=_t(lengths[:, None]), cache={k: _t(v) for k, v in cache.items()},
        lengths=_t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(gc[n].numpy(), np.asarray(wc[n]), **TOL)
        assert not np.array_equal(gc[n].numpy()[2, :, S - 1], cache[n][2, :, S - 1])


# -------------------------------------------------------- the whole slice


def test_serve_reduced_on_the_cpu_is_deterministic_and_healthy():
    cfg = get_config("internlm2-1.8b").reduced()
    a = serve_mod.serve(cfg, batch=2, prompt_len=12, gen=5, verbose=False, device="cpu")
    b = serve_mod.serve(cfg, batch=2, prompt_len=12, gen=5, verbose=False, device="cpu")
    assert a.tokens.shape == (2, 5)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.healthy and a.tokens_per_s > 0
    assert a.report is not None and a.report.steps == 3


def test_serve_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """serve() defaults to the card; with none it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2-1.8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA card"):
        serve_mod.serve(cfg, batch=1, prompt_len=4, gen=2, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        Model(cfg)
    ops.reset_launch_counts()
    serve_mod.serve(cfg, batch=1, prompt_len=4, gen=2, verbose=False, device="cpu")
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("arch", ["minitron-8b", "stablelm-3b"])
def test_other_dense_archs_serve_reduced(arch):
    res = serve_mod.serve(get_config(arch).reduced(), batch=1, prompt_len=6, gen=3,
                          verbose=False, device="cpu")
    assert res.tokens.shape == (1, 3)


def test_params_from_reference_fills_every_parameter():
    cfg = ref_config("gemma3-4b").reduced()
    pcfg = get_config("gemma3-4b").reduced()
    sd = params_from_reference(pcfg, _ref_params(cfg))
    model = Model(pcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert "head" not in sd  # tied embeddings
    assert len(model.layers) == cfg.n_layers == 6
