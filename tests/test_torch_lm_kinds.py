"""The port's serving path for the MoE kind, cross-attention over image
tokens, embedding inputs and the int8 KV cache, against the JAX package on
the CPU.

Reduced granite-moe-3b-a800m and mixtral-8x7b (``moe``; mixtral's sliding
window of 8 lies inside the 12-token prompt), llama-3.2-vision-90b (4
``attn`` + 1 ``xattn`` layer, 8 image tokens), musicgen-medium
(``embed_inputs``: embedding prompts and a fresh embedding each decode
step) and internlm2-1.8b with ``kv_quant=True``, with the reference's
weights (``repro.models.model.Model(cfg).init(PRNGKey(0))``) carried over
by ``params_from_reference``. The reference runs with ``use_flash=True``:
its Pallas kernels in interpret mode. Inputs are drawn with numpy; for
llama-vision the image embeddings are 0.02·N(0, 1) and both gates of the
cross-attention layer are set to 0.5 in both packages (at their zero init
the layer adds nothing).

Tolerances as ``tests/test_torch_lm.py``: logits rtol=atol=1e-4, one block
1e-5. The int8 caches: the int8 values are compared exactly where the two
packages agree; where they do not (an f32 K or V value that lies at a
rounding boundary of its quantization step), the dequantized values must lie
within one quantization step of each other, and at most 1% of the values
may disagree; the bf16 scales within one bf16 rounding (rtol 1e-2).

Then the port alone: every registered arch (and internlm2 with the int8
cache) builds and serves its reduced config on the CPU, deterministic and
healthy, and the reference's own model checks (tests/test_models.py) run
on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.launch.serve import _grow_caches as ref_grow
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro.models.model import Model as RefModel
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention, blocks
from repro_torch.models.model import (
    Model,
    caches_from_reference,
    caches_to_reference,
    params_from_reference,
)
from test_models import make_batch

B, PROMPT, STEPS = 2, 12, 6
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
INT8 = "internlm2-1.8b+kv_quant"
CASES = ["granite-moe-3b-a800m", "mixtral-8x7b", "llama-3.2-vision-90b",
         "musicgen-medium", INT8]
GATE = 0.5


def _configs(case):
    """(reference config, port config), both reduced."""
    if case == INT8:
        arch = case.split("+")[0]
        return (dataclasses.replace(ref_config(arch).reduced(), kv_quant=True),
                dataclasses.replace(get_config(arch).reduced(), kv_quant=True))
    return ref_config(case).reduced(), get_config(case).reduced()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ref_params(cfg):
    params = _np(RefModel(cfg).init(jax.random.PRNGKey(0)))
    for gp in (v for k, v in params.items() if k.startswith("group")):
        for sub in gp.values():
            for gate in ("gate_attn", "gate_mlp"):
                if gate in sub:
                    sub[gate] = np.full_like(sub[gate], GATE)
    return params


def _inputs(cfg, rng, batch=B, prompt=PROMPT):
    """The prefill's batch (numpy) and each decode step's embeddings."""
    inp = {}
    if cfg.embed_inputs:
        inp["embeds"] = (0.02 * rng.standard_normal((batch, prompt, cfg.d_model))
                         ).astype(np.float32)
    else:
        inp["tokens"] = rng.integers(0, cfg.vocab, (batch, prompt), np.int32)
    if cfg.n_image_tokens:
        inp["image_embeds"] = (0.02 * rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.d_model))).astype(np.float32)
    steps = [(0.02 * rng.standard_normal((batch, 1, cfg.d_model))).astype(np.float32)
             for _ in range(STEPS)] if cfg.embed_inputs else None
    return inp, steps


def _port_inputs(inp):
    return {k: _t(v).long() if k == "tokens" else _t(v) for k, v in inp.items()}


@pytest.fixture(scope="module", params=CASES)
def served(request):
    """One prompt batch through both models: the reference's prefill and
    STEPS greedy decode steps (jitted, Pallas in interpret mode), then the
    port's, fed the same inputs."""
    cfg, pcfg = _configs(request.param)
    assert cfg.use_flash
    params = _ref_params(cfg)
    inp, step_embeds = _inputs(cfg, np.random.default_rng(0))
    capacity = PROMPT + STEPS + 1

    ref = RefModel(cfg)
    prefill = jax.jit(ref.prefill)
    decode = jax.jit(ref.decode_step)
    logits, caches = prefill(params, inp)
    want = {"prefill": np.asarray(logits), "prefill_caches": _np(caches), "steps": []}
    caches = ref_grow(ref, caches, B, capacity)
    lengths = jnp.full((B,), PROMPT, jnp.int32)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for i in range(STEPS):
        batch = {"embeds": step_embeds[i]} if cfg.embed_inputs else {"tokens": tok}
        lg, caches = decode(params, batch, lengths, caches)
        want["steps"].append((np.asarray(tok), np.asarray(lg)))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        lengths = lengths + 1
    want["caches"] = _np(caches)

    model = Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(pcfg, params))
    got = {"steps": []}
    logits, pc = model.prefill(**_port_inputs(inp))
    got["prefill"] = logits.numpy()
    got["prefill_caches"] = caches_to_reference(pcfg, pc)
    pc = serve_mod._grow_caches(model, pc, B, capacity)
    lengths = torch.full((B,), PROMPT, dtype=torch.int32)
    tok = logits.argmax(-1)[:, None]
    for i in range(STEPS):
        if pcfg.embed_inputs:
            lg, pc = model.decode_step(lengths=lengths, caches=pc,
                                       embeds=_t(step_embeds[i]))
        else:
            lg, pc = model.decode_step(tok, lengths, pc)
        got["steps"].append((tok.numpy(), lg.numpy()))
        tok = lg.argmax(-1)[:, None]
        lengths = lengths + 1
    got["caches"] = caches_to_reference(pcfg, pc)
    return request.param, got, want


def _close_int8(got, want, name):
    """An int8 cache leaf and its scales: equal where the int8 values agree,
    within one quantization step where they do not."""
    qg, qw = got[name], np.asarray(want[name])
    sg = got[name + "_scale"].astype(np.float32)
    sw = np.asarray(want[name + "_scale"]).astype(np.float32)
    assert qg.dtype == qw.dtype == np.int8
    np.testing.assert_allclose(sg, sw, rtol=1e-2, atol=0)
    differ = qg != qw
    assert differ.mean() <= 0.01, f"{name}: {differ.mean():.4f} of the int8 values differ"
    dq_g, dq_w = qg * sg, qw * sw
    step = np.broadcast_to(np.maximum(sg, sw), qg.shape)
    gap = np.abs(dq_g - dq_w)
    assert (gap[differ] <= step[differ] * (1 + 1e-2) + 1e-6).all(), name


def _close_caches(got, want, **tol):
    """Per-layer-group cache trees: float leaves within tol, int8 leaves by
    _close_int8."""
    flat_g, tree_g = jax.tree.flatten(got)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_g == tree_w
    for group_g, group_w in zip(got, want):
        for sub_g, sub_w in zip(group_g, group_w):
            for part, leaves in sub_g.items():
                for name, g in leaves.items():
                    w = sub_w[part][name]
                    if "k_scale" in leaves and name in ("k", "v"):
                        _close_int8(leaves, sub_w[part], name)
                    elif not name.endswith("_scale"):
                        np.testing.assert_allclose(g, np.asarray(w), **tol)


def test_prefill_logits_match_the_reference(served):
    _, got, want = served
    np.testing.assert_allclose(got["prefill"], want["prefill"], **LOGIT_TOL)


def test_prefill_caches_match_the_reference(served):
    _, got, want = served
    _close_caches(got["prefill_caches"], want["prefill_caches"], **TOL)


def test_greedy_decode_matches_the_reference(served):
    """The same tokens at every step, and the logits within 1e-4."""
    _, got, want = served
    for (gt, gl), (wt, wl) in zip(got["steps"], want["steps"]):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_allclose(gl, wl, **LOGIT_TOL)


def test_caches_after_decode_match_the_reference(served):
    _, got, want = served
    _close_caches(got["caches"], want["caches"], **LOGIT_TOL)


def test_caches_round_trip(served):
    case, got, _ = served
    _, pcfg = _configs(case)
    back = caches_to_reference(pcfg, caches_from_reference(pcfg, got["caches"]))
    flat_b, tree_b = jax.tree.flatten(back)
    flat_g, tree_g = jax.tree.flatten(got["caches"])
    assert tree_b == tree_g
    for b, g in zip(flat_b, flat_g):
        assert b.dtype == g.dtype
        np.testing.assert_array_equal(b, g)


def test_the_int8_caches_cross_packages_as_int8():
    """The reference's int8 caches and bf16 scales come over as int8 and
    bf16 tensors (ml_dtypes' bfloat16 through float32), and back as int8
    and float32 numpy."""
    cfg, pcfg = _configs(INT8)
    inp, _ = _inputs(cfg, np.random.default_rng(1))
    _, want = RefModel(cfg).prefill(_ref_params(cfg), inp)
    want = _np(want)
    caches = caches_from_reference(pcfg, want)
    attn = caches[0]["attn"]
    assert attn["k"].dtype == attn["v"].dtype == torch.int8
    assert attn["k_scale"].dtype == attn["v_scale"].dtype == torch.bfloat16
    w = want[0][0]["attn"]
    np.testing.assert_array_equal(attn["k"].numpy(), w["k"][0])
    np.testing.assert_array_equal(attn["k_scale"].float().numpy(),
                                  w["k_scale"][0].astype(np.float32))
    back = caches_to_reference(pcfg, caches)[0][0]["attn"]
    assert back["k"].dtype == np.int8 and back["k_scale"].dtype == np.float32
    np.testing.assert_array_equal(back["v"], w["v"])


# ------------------------------------------------------------ the layers


def _layer(params, pcfg, li):
    """Layer li's parameters as the port's nested dict."""
    sd = params_from_reference(pcfg, params)
    p = {}
    for name, t in sd.items():
        if name.startswith(f"layers.{li}."):
            *path, leaf = name[len(f"layers.{li}."):].split(".")
            d = p
            for k in path:
                d = d.setdefault(k, {})
            d[leaf] = t
    return p


@pytest.mark.parametrize("case,sub", [("granite-moe-3b-a800m", 0), ("mixtral-8x7b", 0),
                                      ("llama-3.2-vision-90b", 4)])
def test_one_block_matches_the_reference(case, sub):
    """One moe or xattn block, prefill mode: output, cache and aux."""
    cfg, pcfg = _configs(case)
    params = _ref_params(cfg)
    kind = cfg.layer_plan()[0][0][sub]
    p_ref = jax.tree.map(lambda a: a[0], params["group0"][f"sub{sub}"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    img = (rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
           if kind == "xattn" else None)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    want, wc, waux = ref_blocks.block_fwd(
        jax.tree.map(jnp.asarray, p_ref), jnp.asarray(x), cfg=cfg, kind=kind,
        ctx=ref_blocks.BlockCtx(mode="prefill", positions=jnp.asarray(pos),
                                image_embeds=None if img is None else jnp.asarray(img)))
    got, gc, aux = blocks.block_fwd(
        _layer(params, pcfg, sub), _t(x), cfg=pcfg, kind=kind,
        ctx=blocks.BlockCtx(mode="prefill", positions=_t(pos),
                            image_embeds=None if img is None else _t(img)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(gc["attn"][n].numpy(), np.asarray(wc["attn"][n]), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    assert (float(aux) > 0) == (kind == "moe")


def test_xattn_block_at_init_adds_nothing():
    """At their zero init the gates make the cross-attention layer the
    identity, bit for bit, whatever the image embeddings."""
    pcfg = get_config("llama-3.2-vision-90b").reduced()
    model = Model(pcfg, device="cpu")
    li = pcfg.layer_plan_flat().index("xattn")
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 5, pcfg.d_model)).astype(np.float32))
    img = _t(rng.standard_normal((2, pcfg.n_image_tokens, pcfg.d_model)).astype(np.float32))
    out, cache, _ = blocks.block_fwd(
        model._layer_params(li), x, cfg=pcfg, kind="xattn",
        ctx=blocks.BlockCtx(mode="prefill", positions=torch.arange(5).expand(2, 5),
                            image_embeds=img))
    assert torch.equal(out, x)
    assert cache["attn"]["k"].shape == (2, pcfg.n_kv_heads, pcfg.n_image_tokens,
                                        pcfg.head_dim_)


def test_xattn_decode_reads_the_image_cache_whole_and_writes_nothing():
    cfg, pcfg = _configs("llama-3.2-vision-90b")
    p = jax.tree.map(lambda a: a[0], _ref_params(cfg)["group0"]["sub4"]["attn"])
    rng = np.random.default_rng(4)
    I, hd = cfg.n_image_tokens, cfg.head_dim_
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    cache = {n: rng.standard_normal((3, cfg.n_kv_heads, I, hd)).astype(np.float32)
             for n in ("k", "v")}
    lengths = np.array([0, 5, 17], np.int32)  # past I: an image cache ignores it
    want, _ = ref_attn.attn_fwd(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg=cfg, kind="xattn",
        mode="decode", positions=jnp.asarray(lengths[:, None]),
        cache=jax.tree.map(jnp.asarray, cache), lengths=jnp.asarray(lengths))
    pc = {k: _t(v) for k, v in cache.items()}
    got, gc = attention.attn_fwd(
        {k: _t(v) for k, v in p.items()}, _t(x), cfg=pcfg, kind="xattn", mode="decode",
        positions=_t(lengths[:, None]), cache=pc, lengths=_t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in ("k", "v"):
        np.testing.assert_array_equal(gc[n].numpy(), cache[n])


def test_quantize_kv_matches_the_reference_bit_for_bit():
    """int8 values and bf16 scales equal, halves rounded to even: a row of
    amax 127 has scale 1, so 2.5 -> 2, -3.5 -> -4, 0.5 -> 0."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    x[0, 0, 0, 4:] = 0.0
    x[1, 2, 3] = 0.0  # an all-zero row: scale 1e-6 / 127
    qg, sg = attention._quantize_kv(_t(x))
    qw, sw = ref_attn._quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(qg.numpy(), np.asarray(qw))
    np.testing.assert_array_equal(sg.float().numpy(), np.asarray(sw).astype(np.float32))
    assert qg.numpy()[0, 0, 0, :4].tolist() == [127, 2, -4, 0]
    assert qg.dtype == torch.int8 and sg.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        attention._dequantize_kv(qg, sg, torch.float32).numpy(),
        np.asarray(ref_attn._dequantize_kv(qw, sw, jnp.float32)))


def test_int8_decode_writes_at_lengths_and_clamps_a_full_cache():
    """kv_quant decode: the quantized token and its scales go to position
    lengths[b] (the last slot at lengths == capacity), as the reference's."""
    cfg, pcfg = _configs(INT8)
    rng = np.random.default_rng(6)
    S, hd = 10, cfg.head_dim_
    p = jax.tree.map(lambda a: a[0], _ref_params(cfg)["group0"]["sub0"]["attn"])
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    qk, sk = ref_attn._quantize_kv(jnp.asarray(
        rng.standard_normal((3, cfg.n_kv_heads, S, hd)).astype(np.float32)))
    qv, sv = ref_attn._quantize_kv(jnp.asarray(
        rng.standard_normal((3, cfg.n_kv_heads, S, hd)).astype(np.float32)))
    cache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    lengths = np.array([3, S - 1, S], np.int32)
    want, wc = ref_attn.attn_fwd(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg=cfg, kind="attn", mode="decode",
        positions=jnp.asarray(lengths[:, None]), cache=cache, lengths=jnp.asarray(lengths))
    pc = {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(torch.bfloat16)
          if k.endswith("_scale") else _t(v) for k, v in cache.items()}
    got, gc = attention.attn_fwd(
        {k: _t(v) for k, v in p.items()}, _t(x), cfg=pcfg, kind="attn", mode="decode",
        positions=_t(lengths[:, None]), cache=pc, lengths=_t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in ("k", "v"):
        np.testing.assert_array_equal(gc[n].numpy(), np.asarray(wc[n]))
        np.testing.assert_array_equal(gc[n + "_scale"].float().numpy(),
                                      np.asarray(wc[n + "_scale"]).astype(np.float32))


# ------------------------------------------------------- the port alone

SERVE_CASES = sorted(ARCHS) + [INT8]


@pytest.mark.parametrize("case", SERVE_CASES)
def test_every_arch_serves_reduced_on_the_cpu(case):
    """Builds and serves, deterministic and healthy (11 cases: the 10
    registered archs and internlm2 with the int8 cache)."""
    _, cfg = _configs(case) if case == INT8 else (None, get_config(case).reduced())
    a = serve_mod.serve(cfg, batch=2, prompt_len=10, gen=4, verbose=False, device="cpu")
    b = serve_mod.serve(cfg, batch=2, prompt_len=10, gen=4, verbose=False, device="cpu")
    assert a.tokens.shape == (2, 4)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.healthy and a.tokens_per_s > 0


def _port_model(name):
    """The reduced arch with the reference's weights (the reference's own
    model checks run on them; their tolerances were set there)."""
    cfg = get_config(name).reduced()
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(
        cfg, _np(RefModel(ref_config(name).reduced()).init(jax.random.PRNGKey(0)))))
    return cfg, model


def _port_batch(cfg, B, S, seed):
    """tests/test_models.py's make_batch (without labels), as tensors."""
    batch = make_batch(ref_config(cfg.name).reduced(), B, S, key=seed)
    del batch["labels"]
    if cfg.embed_inputs:
        del batch["tokens"]
    return _port_inputs(_np(batch))


def _grow(model, caches, B, capacity):
    return serve_mod._grow_caches(model, caches, B, capacity)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_decode_consistency(name):
    """The reference's check on the port: teacher-forced prefill over S+1
    positions == prefill(S) + decode(1), within the reference's 2e-2."""
    cfg, model = _port_model(name)
    S = 12
    full = _port_batch(cfg, 1, S + 1, 5)
    key = "embeds" if cfg.embed_inputs else "tokens"
    pre = dict(full, **{key: full[key][:, :S]})
    logits_full, _ = model.prefill(**full)
    _, caches = model.prefill(**pre)
    caches = _grow(model, caches, 1, S + 1)
    lengths = torch.full((1,), S, dtype=torch.int32)
    if cfg.embed_inputs:
        logits_dec, _ = model.decode_step(lengths=lengths, caches=caches,
                                          embeds=full["embeds"][:, S:S + 1])
    else:
        logits_dec, _ = model.decode_step(full["tokens"][:, S:S + 1], lengths, caches)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_decode_cache_roundtrip_multi_token(name):
    """The reference's check on the port: 3 decode steps keep shapes and
    finiteness."""
    cfg, model = _port_model(name)
    B, S0 = 2, 8
    _, caches = model.prefill(**_port_batch(cfg, B, S0, 2))
    caches = _grow(model, caches, B, S0 + 4)
    lengths = torch.full((B,), S0, dtype=torch.int32)
    for _ in range(3):
        if cfg.embed_inputs:
            logits, caches = model.decode_step(
                lengths=lengths, caches=caches,
                embeds=torch.full((B, 1, cfg.d_model), 0.01))
        else:
            logits, caches = model.decode_step(torch.ones((B, 1), dtype=torch.long),
                                               lengths, caches)
        assert logits.shape == (B, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
        lengths = lengths + 1


def test_int8_kv_cache_decode_close_to_bf16():
    """The reference's check on the port: kv_quant decode logits track the
    unquantized path (int8 error bounded by per-position scales)."""
    cfg = get_config("internlm2-1.8b").reduced()
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    model = Model(cfg, device="cpu")
    model_q = Model(cfg_q, device="cpu")
    model_q.load_state_dict(model.state_dict())
    B, S = 2, 12
    pre = _port_batch(cfg, B, S, 7)
    lg, caches = model.prefill(**pre)
    lg_q, caches_q = model_q.prefill(**pre)
    np.testing.assert_allclose(lg.numpy(), lg_q.numpy(), rtol=2e-2, atol=2e-2)
    tok = torch.ones((B, 1), dtype=torch.long)
    lengths = torch.full((B,), S, dtype=torch.int32)
    base, _ = model.decode_step(tok, lengths, _grow(model, caches, B, S + 2))
    got, _ = model_q.decode_step(tok, lengths, _grow(model_q, caches_q, B, S + 2))
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=0.08, atol=0.08)
    assert any(t.dtype == torch.int8 for c in model_q.init_caches(B, 8)
               for t in c["attn"].values())


def test_moe_aux_loss_is_summed_over_layers():
    cfg, model = _port_model("granite-moe-3b-a800m")
    _, _, aux = model.forward(**_port_batch(cfg, 2, 16, 1), mode="prefill")
    per_layer = []
    x = model._embed(_port_batch(cfg, 2, 16, 1)["tokens"], None)
    ctx = blocks.BlockCtx(mode="prefill", positions=torch.arange(16).expand(2, 16))
    for li, kind in enumerate(model.kinds):
        x, _, a = blocks.block_fwd(model._layer_params(li), x, cfg=cfg, kind=kind, ctx=ctx)
        per_layer.append(float(a))
    assert len(per_layer) == cfg.n_layers and all(a > 0 for a in per_layer)
    np.testing.assert_allclose(float(aux), sum(per_layer), rtol=1e-6)


def test_embed_inputs_model_has_no_embedding_table():
    """musicgen: embedding inputs and untied embeddings, only the head."""
    cfg, model = _port_model("musicgen-medium")
    names = set(model.state_dict())
    assert "head" in names and "embed" not in names
    with pytest.raises(ValueError, match="embeds"):
        model.prefill(torch.zeros((1, 3), dtype=torch.long))


def test_image_tokens_need_image_embeddings():
    cfg, model = _port_model("llama-3.2-vision-90b")
    with pytest.raises(ValueError, match="image_embeds"):
        model.prefill(torch.zeros((1, 3), dtype=torch.long))


@pytest.mark.parametrize("case", CASES)
def test_params_from_reference_fills_every_parameter(case):
    cfg, pcfg = _configs(case)
    sd = params_from_reference(pcfg, _ref_params(cfg))
    model = Model(pcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    for name, t in model.state_dict().items():
        assert t.shape == sd[name].shape, name


@pytest.mark.parametrize("name", ["mixtral-8x7b", "llama-3.2-vision-90b", "musicgen-medium"])
def test_train_mode_is_not_ported(name):
    """Named when train mode raised; training is ported now: the forward in
    train mode runs, writes no cache and records the graph
    (tests/test_torch_train.py holds its loss and gradients to the
    reference)."""
    cfg, model = _port_model(name)
    model.train_mode()
    hidden, caches, aux = model.forward(**_port_batch(cfg, 1, 4, 0), mode="train")
    assert hidden.shape == (1, 4, cfg.d_model) and caches is None
    assert hidden.requires_grad and bool(torch.isfinite(hidden).all())
    assert bool(torch.isfinite(aux)) and (float(aux.detach()) > 0) == bool(cfg.n_experts)


def _serve_controls():
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_serve_controls", root / "benchmarks" / "torch_serve_controls.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["moe", "k6"])
def test_serve_controls_break_the_kernel_path_only(name):
    """benchmarks/torch_serve_controls.py's controls, in process: inside
    one, the kernel path (use_flash / use_kernel) is broken as it says and
    the plain path is untouched; on leaving it, the wrapped function is
    back."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention, moe

    controls = _serve_controls()
    rng = np.random.default_rng(0)
    if name == "moe":
        cfg = get_config("granite-moe-3b-a800m").reduced()
        p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
        xt = torch.from_numpy(rng.standard_normal((1, 6, cfg.d_model)).astype(np.float32))
        route = moe.route
        want = route(p, xt, cfg, "prefill")
        with controls.moe_one_over_k():
            plain = moe.route(p, xt, dataclasses.replace(cfg, use_flash=False), "prefill")
            kern = moe.route(p, xt, dataclasses.replace(cfg, use_flash=True), "prefill")
        assert moe.route is route
        assert torch.equal(plain.gates, want.gates)
        assert torch.equal(kern.gates, torch.full_like(want.gates, 1.0 / cfg.top_k))
        assert torch.equal(kern.e_idx, want.e_idx) and torch.equal(kern.keep, want.keep)
        return
    ops = attention.ops
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((3, 4, 8), (3, 2, 10, 8), (3, 2, 10, 8)))
    lengths = torch.tensor([5, 9, 10], dtype=torch.int32)
    with controls.k6_misses_own_token():
        kern = attention.ops.decode_attention(q, kc, vc, lengths, use_kernel=True)
        plain = attention.ops.decode_attention(q, kc, vc, lengths, use_kernel=False)
        assert attention.ops.flash_attention is ops.flash_attention
    assert attention.ops is ops
    assert torch.equal(plain, ref.decode_attention_plain(q, kc, vc, lengths))
    # a self-attention read (lengths < capacity) one short; a whole read kept
    short = ref.decode_attention_plain(q, kc, vc, torch.tensor([4, 8, 10], dtype=torch.int32))
    assert torch.equal(kern, short)
