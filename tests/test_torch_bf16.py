"""The port's bf16 model path against the JAX package, on the CPU.

The reduced internlm2-1.8b, gemma3-4b, mamba2-130m, hymba-1.5b,
granite-moe-3b-a800m and llama-3.2-vision-90b configs with
``dtype="bfloat16"`` (the compute dtype of the full-size configs; the
weights stay f32), the reference's weights carried over by
``params_from_reference``, one prompt batch: the prefill and STEPS decode
steps, teacher-forced with the f32 reference's greedy tokens. Three runs:
the reference in f32, the reference in bf16 and the port in bf16. The two
frameworks round to bf16 at other places, so the port's bf16 logits are
held not to the reference's bf16 logits but to the f32 ones, by the
reference's own bf16 error, over the prefill and every step: the port's
||logits - f32 logits|| / ||f32 logits|| within RMS_FACTOR of the
reference's, and its max |logit - f32 logit| / max |f32 logit| within
MAX_FACTOR of the reference's. The reference runs its plain path
(``use_flash=False``: no Pallas kernel in interpret mode); the port on the
CPU runs its kernels' plain versions. Inputs are drawn with numpy; the
llama-vision prefill gets 0.02·N(0, 1) image embeddings (f32: both
packages then keep the cross-attention K/V in f32) with both
cross-attention gates at 0.5 (at their zero init the layer adds nothing).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.launch.serve import _grow_caches as ref_grow
from repro.models.model import Model as RefModel
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models.model import Model, caches_to_reference, params_from_reference

ARCHS = ["internlm2-1.8b", "gemma3-4b", "mamba2-130m", "hymba-1.5b",
         "granite-moe-3b-a800m", "llama-3.2-vision-90b"]
B, PROMPT, STEPS = 2, 12, 4
#: The port's bf16 gaps may exceed the reference's by these factors. The two
#: frameworks round at other places, so their errors differ in detail but
#: not in size. The norm gap is the steadier measure; the max gap, one
#: element's chain of roundings, varies more between inputs, so its factor
#: is wider. (``pytest -s`` prints each arch's gaps.)
RMS_FACTOR = 1.5
MAX_FACTOR = 2.0


def _prefill_batch(cfg, prompts):
    """The prefill's inputs: the prompts, and image embeddings where the
    config takes them."""
    batch = {"tokens": prompts}
    if cfg.n_image_tokens:
        batch["image_embeds"] = (0.02 * np.random.default_rng(1).standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _ref_logits(cfg, params, prompts, tokens):
    """The reference's prefill and decode logits, teacher-forced."""
    ref = RefModel(cfg)
    prefill = jax.jit(ref.prefill)
    decode = jax.jit(lambda p, t, n, c: ref.decode_step(p, {"tokens": t}, n, c))
    logits, caches = prefill(params, _prefill_batch(cfg, prompts))
    out = [np.asarray(logits, np.float32)]
    caches = ref_grow(ref, caches, B, PROMPT + STEPS + 1)
    lengths = jnp.full((B,), PROMPT, jnp.int32)
    for i in range(STEPS):
        lg, caches = decode(params, tokens[:, i:i + 1], lengths, caches)
        out.append(np.asarray(lg, np.float32))
        lengths = lengths + 1
    return out


def _port_logits(cfg, params, prompts, tokens):
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, params))
    batch = {k: torch.from_numpy(v) for k, v in _prefill_batch(cfg, prompts).items()}
    logits, caches = model.prefill(batch.pop("tokens").long(), **batch)
    out = [logits.float().numpy()]
    caches = serve_mod._grow_caches(model, caches, B, PROMPT + STEPS + 1)
    lengths = torch.full((B,), PROMPT, dtype=torch.int32)
    for i in range(STEPS):
        lg, caches = model.decode_step(torch.from_numpy(tokens[:, i:i + 1]).long(),
                                       lengths, caches)
        out.append(lg.float().numpy())
        lengths = lengths + 1
    return out


def _gaps(got, want):
    """(norm gap, max gap) over the prefill and the steps."""
    rms = max(float(np.linalg.norm(g - w) / np.linalg.norm(w)) for g, w in zip(got, want))
    mx = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))
    return rms, mx


def _with_gates(params):
    """Both cross-attention gates at 0.5, where the model has them."""
    for gp in (v for k, v in params.items() if k.startswith("group")):
        for sub in gp.values():
            for gate in ("gate_attn", "gate_mlp"):
                if gate in sub:
                    sub[gate] = np.full_like(sub[gate], 0.5)
    return params


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_stay_within_the_references_own_bf16_error(arch):
    ref32 = dataclasses.replace(ref_config(arch).reduced(), use_flash=False)
    ref16 = dataclasses.replace(ref32, dtype="bfloat16")
    port16 = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    params = _with_gates(jax.tree.map(np.asarray, RefModel(ref32).init(jax.random.PRNGKey(0))))
    prompts = np.random.default_rng(0).integers(0, ref32.vocab, (B, PROMPT), np.int32)
    # the f32 reference's greedy tokens, which every run is then fed
    tokens = np.zeros((B, STEPS), np.int32)
    ref = RefModel(ref32)
    logits, caches = ref.prefill(params, _prefill_batch(ref32, prompts))
    caches = ref_grow(ref, caches, B, PROMPT + STEPS + 1)
    lengths = jnp.full((B,), PROMPT, jnp.int32)
    for i in range(STEPS):
        tokens[:, i] = np.asarray(jnp.argmax(logits, -1))
        logits, caches = ref.decode_step(params, {"tokens": jnp.asarray(tokens[:, i:i + 1])},
                                         lengths, caches)
        lengths = lengths + 1

    want = _ref_logits(ref32, params, prompts, tokens)
    ref_rms, ref_max = _gaps(_ref_logits(ref16, params, prompts, tokens), want)
    port_rms, port_max = _gaps(_port_logits(port16, params, prompts, tokens), want)
    assert all(np.isfinite(w).all() for w in want)
    assert 0.0 < ref_rms < 0.1 and 0.0 < ref_max < 0.1  # bf16 moved the reference, not wildly
    print(f"{arch}: port/reference bf16 gap, norm {port_rms:.4g}/{ref_rms:.4g}, "
          f"max {port_max:.4g}/{ref_max:.4g}")
    assert port_rms <= RMS_FACTOR * ref_rms, (arch, port_rms, ref_rms)
    assert port_max <= MAX_FACTOR * ref_max, (arch, port_max, ref_max)


def test_layer_params_keep_the_router_f32():
    """The reference's _cast_group casts every floating matrix to the
    activation dtype except the MoE router: the port's _layer_params too."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(), dtype="bfloat16")
    model = Model(cfg, device="cpu")
    p = model._layer_params(0)
    assert p["moe"]["router"].dtype == torch.float32
    assert p["moe"]["router"] is model.layers[0].moe.router
    for name in ("gate", "up", "down"):
        assert p["moe"][name].dtype == torch.bfloat16 and p["moe"][name].ndim == 3
    assert p["attn"]["wq"].dtype == torch.bfloat16
    assert p["norm1"].dtype == torch.float32
    vlm = Model(dataclasses.replace(get_config("llama-3.2-vision-90b").reduced(),
                                    dtype="bfloat16"), device="cpu")
    gates = vlm._layer_params(4)
    assert gates["gate_attn"].dtype == gates["gate_mlp"].dtype == torch.float32


def test_bf16_image_cache_stays_f32_as_the_references():
    """A bf16 llama-vision fed f32 image embeddings: the reference's
    ``kv_src @ wk`` promotes, so its prefill keeps the image K/V in f32; the
    port's too, and they agree to f32 rounding (the same products of the
    same bf16-rounded weights, summed in another order)."""
    ref16 = dataclasses.replace(ref_config("llama-3.2-vision-90b").reduced(),
                                use_flash=False, dtype="bfloat16")
    port16 = dataclasses.replace(get_config("llama-3.2-vision-90b").reduced(),
                                 dtype="bfloat16")
    params = _with_gates(jax.tree.map(np.asarray, RefModel(
        dataclasses.replace(ref16, dtype="float32")).init(jax.random.PRNGKey(0))))
    prompts = np.random.default_rng(0).integers(0, ref16.vocab, (B, PROMPT), np.int32)
    _, want = RefModel(ref16).prefill(params, _prefill_batch(ref16, prompts))
    model = Model(port16, device="cpu")
    model.load_state_dict(params_from_reference(port16, params))
    batch = {k: torch.from_numpy(v) for k, v in _prefill_batch(port16, prompts).items()}
    _, got = model.prefill(batch.pop("tokens").long(), **batch)
    cross = [li for li, kind in enumerate(model.kinds) if kind == "xattn"]
    assert cross
    for li in cross:
        assert got[li]["attn"]["k"].dtype == got[li]["attn"]["v"].dtype == torch.float32
    got_ref, held = caches_to_reference(port16, got), 0
    for group_g, group_w in zip(got_ref, want):
        for sub_g, sub_w in zip(group_g, group_w):
            if "attn" in sub_w and sub_w["attn"]["k"].shape[-2] == ref16.n_image_tokens:
                held += 1
                for name in ("k", "v"):
                    assert sub_w["attn"][name].dtype == jnp.float32
                    np.testing.assert_allclose(sub_g["attn"][name],
                                               np.asarray(sub_w["attn"][name]),
                                               rtol=1e-5, atol=1e-6)
    assert held == 1  # the reduced config's one xattn layer group
