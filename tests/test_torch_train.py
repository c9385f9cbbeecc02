"""The port's train mode (``Model.loss`` and its gradients) against the JAX
package's ``jax.value_and_grad(model.loss)``, on the CPU.

Every registered arch at its ``reduced()`` config, f32, with the
reference's weights (``Model(cfg).init(PRNGKey(0))``) carried over by
``params_from_reference`` (the cross-attention gates set to 0.5 in both,
so the image layer's weights get a gradient), on a numpy batch (B = 2, S =
16; embeddings and image embeddings 0.02·N(0, 1)): the dense kinds, the
``local``/``global`` windows (gemma3), ``moe`` (granite, mixtral, and
granite at capacity factor 0.5, which drops), ``ssm`` (mamba2), ``hybrid``
(hymba), ``xattn`` with image embeddings (llama-vision) and embedding
inputs (musicgen), and ``loss_chunk`` 4 against 0. The loss within
rtol=atol=1e-5; every parameter's gradient, mapped through
``params_from_reference``, within 1e-4 of that tensor's max |g| (read: at
most 2.1e-5, the vision model's gate; the others at most 4.4e-6). The MoE
routing in training equals the reference's exactly: the reference's is
read off its combine's ``vmap`` arguments with its blocks run one by one.

Then one test per place where serving code stood in the way of autograd:
a gradient reaches every matrix in a bf16 model (the casts made in the
graph, not the serving path's detached copies); train mode calls no kernel
wrapper (K5, K6, K7, K8 replaced by stand-ins that raise, the tensors
taken for the card's); serving keeps its cast copies, remade after an
update; the serving modes record no graph; each layer is checkpointed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as ref_config
from repro.models import blocks as ref_blocks
from repro.models import moe as ref_moe
from repro.models.layers import _dtype as ref_dtype
from repro.models.model import Model as RefModel
from repro.models.model import _cast_group
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as model_mod
from repro_torch.models import moe
from repro_torch.models.model import Model, params_from_reference
from repro_torch.optim.optimizer import AdamW, AdamWConfig
from test_torch_moe import _VmapSpy

B, S = 2, 16
GATE = 0.5
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4  # of each tensor's max |g|
CASES = {name: {} for name in sorted(ARCHS)}
CASES["internlm2-1.8b+loss_chunk4"] = {"loss_chunk": 4}
CASES["granite-moe-3b-a800m+cf0.5"] = {"capacity_factor": 0.5}
MOE_CASES = ["granite-moe-3b-a800m", "mixtral-8x7b", "granite-moe-3b-a800m+cf0.5"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _configs(case):
    """(reference config, port config), reduced, with the case's fields."""
    cfg = dataclasses.replace(ref_config(case.split("+")[0]).reduced(), **CASES[case])
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _ref_params(cfg):
    params = _np(RefModel(cfg).init(jax.random.PRNGKey(0)))
    for gp in (v for k, v in params.items() if k.startswith("group")):
        for sub in gp.values():
            for gate in ("gate_attn", "gate_mlp"):
                if gate in sub:
                    sub[gate] = np.full_like(sub[gate], GATE)
    return params


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.embed_inputs:
        batch["embeds"] = (0.02 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    if cfg.n_image_tokens:
        batch["image_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _port_model(pcfg, params):
    model = Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(pcfg, params))
    return model.train_mode()


def _tensors(batch):
    return {k: _t(v) for k, v in batch.items()}


def _close_to(got: torch.Tensor, want: torch.Tensor, name: str, rel: float = GRAD_REL):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + 1e-30, f"{name}: max error {err} against max |g| {scale}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_match_the_reference(case):
    cfg, pcfg = _configs(case)
    params = _ref_params(cfg)
    batch = _batch(cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(RefModel(cfg).loss))(params, batch)
    want = params_from_reference(pcfg, _np(want_grads))

    model = _port_model(pcfg, params)
    loss = model.loss(**_tensors(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **LOSS_TOL)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _close_to(p.grad, want[name], name)


def _ref_routing(cfg, params, batch, monkeypatch):
    """The reference's routing (e_idx, s_idx) of each MoE layer in train
    mode: its blocks run one by one (not in its scan), the routing read off
    each combine's ``vmap`` arguments."""
    spy = _VmapSpy()
    monkeypatch.setattr(ref_moe, "jax", spy)
    ref = RefModel(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    x = ref._embed(params, jb)
    ctx = ref_blocks.BlockCtx(mode="train",
                              positions=jnp.broadcast_to(jnp.arange(S)[None], (B, S)),
                              image_embeds=jb.get("image_embeds"))
    for gi, (kinds, reps) in enumerate(cfg.layer_plan()):
        gp = _cast_group(params[f"group{gi}"], ref_dtype(cfg.dtype))
        for r in range(reps):
            for i, kind in enumerate(kinds):
                p = jax.tree.map(lambda a: a[r], gp[f"sub{i}"])
                x, _, _ = ref_blocks.block_fwd(p, x, cfg=cfg, kind=kind, ctx=ctx)
    monkeypatch.undo()
    return [(np.asarray(c[1]), np.asarray(c[2])) for c in spy.calls if len(c) == 4]


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_routing_in_training_equals_the_references(case, monkeypatch):
    cfg, pcfg = _configs(case)
    params = _ref_params(cfg)
    batch = _batch(cfg)
    want = _ref_routing(cfg, params, batch, monkeypatch)

    got, route = [], moe.route

    def spy(*args):
        r = route(*args)
        got.append(r)
        return r

    model = _port_model(pcfg, params)
    monkeypatch.setattr(moe, "route", spy)
    loss = model.loss(**_tensors(batch))
    routed = got[:]  # the forward's, before the backward runs each layer again
    loss.backward()
    assert len(routed) == len(want) == sum(k == "moe" for k in model.kinds)
    assert len(got) == 2 * len(want)  # the checkpointed layers' recompute
    dropped = 0
    for r, (e_idx, s_idx) in zip(routed, want):
        np.testing.assert_array_equal(r.e_idx.numpy(), e_idx)
        np.testing.assert_array_equal(r.s_idx.numpy(), s_idx)
        dropped += int((~r.keep).sum())
    assert (dropped > 0) == case.endswith("cf0.5")


def test_chunked_loss_equals_the_whole_one():
    _, pcfg = _configs("internlm2-1.8b")
    params = _ref_params(ref_config("internlm2-1.8b").reduced())
    batch = _tensors(_batch(pcfg))
    out = []
    for chunk in (0, 4, 8, 5):  # 5 does not divide S: the whole sequence at once
        model = _port_model(dataclasses.replace(pcfg, loss_chunk=chunk), params)
        loss = model.loss(**batch)
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}))
    for loss, grads in out[1:]:
        assert loss == pytest.approx(out[0][0], rel=1e-6)
        for n, g in grads.items():
            _close_to(g, out[0][1][n], n, rel=1e-5)


# ------------------------------------------- the places serving code stood


def _bf16_model(name, seed=0):
    cfg = dataclasses.replace(ref_config(name).reduced(), dtype="bfloat16")
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    return pcfg, _port_model(pcfg, _ref_params(cfg))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_gradient_reaches_every_matrix_in_a_bf16_model(name):
    """The matrices compute in bf16 casts of the f32 parameters: the casts
    are made in the graph, so every parameter gets a gradient and none of a
    matrix's is all zero (serving's detached copies would give None)."""
    pcfg, model = _bf16_model(name)
    loss = model.loss(**_tensors(_batch(pcfg)))
    loss.backward()
    assert bool(torch.isfinite(loss))
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, n
        assert p.grad.dtype == torch.float32, n
        if p.ndim >= 2:
            assert float(p.grad.abs().max()) > 0.0, n


class _KernelCalled(RuntimeError):
    pass


def _stand_in(*args, **kwargs):
    raise _KernelCalled("a kernel wrapper was called")


@pytest.mark.parametrize("name", ["internlm2-1.8b", "gemma3-4b", "mamba2-130m",
                                  "hymba-1.5b", "llama-3.2-vision-90b"])
def test_train_mode_calls_no_kernel_wrapper(name, monkeypatch):
    """Every tensor taken for the card's and every kernel wrapper a stand-in
    that raises: the prefill reaches one (the control), train mode's loss
    and its backward reach none, by mode and not by device."""
    cfg, pcfg = _configs(name)
    model = _port_model(pcfg, _ref_params(cfg))
    batch = _tensors(_batch(cfg))
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    for wrapper in ("_flash_kernel", "_decode_kernel", "_ssd_chunk_kernel",
                    "_rmsnorm_kernel"):
        monkeypatch.setattr(ops, wrapper, _stand_in)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with pytest.raises(_KernelCalled):
        model.prefill(**inputs)
    loss = model.loss(**batch)
    loss.backward()
    assert bool(torch.isfinite(loss))


def test_serving_keeps_its_cast_copies_until_an_update():
    """Serving reuses the bf16 copies of the matrices from call to call
    (the same tensors, no graph); an optimizer step bumps each parameter's
    version, so the next prefill casts anew and sees the new weights."""
    pcfg, model = _bf16_model("internlm2-1.8b")
    batch = _tensors(_batch(pcfg))
    prompt = batch["tokens"]
    logits0, _ = model.prefill(prompt)
    copies = {n: hit[1] for n, hit in model._cast_cache.items()}
    assert copies and all(c.dtype == torch.bfloat16 and not c.requires_grad
                          for c in copies.values())
    logits1, _ = model.prefill(prompt)
    assert torch.equal(logits0, logits1)
    assert all(model._cast_cache[n][1] is c for n, c in copies.items())

    train_step = steps_lib.make_train_step(model, AdamW(AdamWConfig(lr=1e-2, warmup_steps=1)))
    opt_state = AdamW().init(dict(model.named_parameters()))
    train_step(opt_state, batch)
    logits2, _ = model.prefill(prompt)
    assert not torch.equal(logits0, logits2)
    for n, c in copies.items():
        fresh = model._cast_cache[n][1]
        assert fresh is not c
        w = dict(model.named_parameters())[n]
        assert torch.equal(fresh, w.detach().to(torch.bfloat16)), n


def test_serving_modes_record_no_graph_after_train_mode():
    cfg, pcfg = _configs("hymba-1.5b")
    model = _port_model(pcfg, _ref_params(cfg))
    tokens = _t(_batch(cfg)["tokens"])
    hidden, caches, _ = model.forward(tokens, mode="prefill")
    assert not hidden.requires_grad
    logits, caches = model.prefill(tokens)
    assert not logits.requires_grad
    from repro_torch.launch.serve import _grow_caches
    caches = _grow_caches(model, caches, B, S + 1)
    logits, _ = model.decode_step(tokens[:, -1:], torch.full((B,), S, dtype=torch.int32),
                                  caches)
    assert not logits.requires_grad
    assert all(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        assert not model.loss(tokens, tokens).requires_grad


def test_train_mode_returns_no_caches_and_checkpoints_each_layer(monkeypatch):
    """forward(mode="train") writes no cache (None, as the reference's) and
    wraps each layer in torch.utils.checkpoint; a chunked loss also
    checkpoints each chunk."""
    cfg, pcfg = _configs("hymba-1.5b")
    pcfg = dataclasses.replace(pcfg, loss_chunk=4)
    model = _port_model(pcfg, _ref_params(cfg))
    calls, checkpoint = [], model_mod.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(fn.__name__)
        assert kwargs == {"use_reentrant": False}
        return checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(model_mod, "checkpoint", spy)
    batch = _tensors(_batch(cfg))
    hidden, caches, aux = model.forward(batch["tokens"], mode="train")
    assert caches is None and hidden.requires_grad and float(aux) == 0.0
    assert calls == ["_train_layer"] * len(model.kinds)
    calls.clear()
    model.loss(**batch).backward()
    assert calls == ["_train_layer"] * len(model.kinds) + ["_ce_sum"] * (S // 4)


def test_unknown_mode_is_refused():
    cfg, pcfg = _configs("internlm2-1.8b")
    model = _port_model(pcfg, _ref_params(cfg))
    with pytest.raises(ValueError, match="mode"):
        model.forward(torch.zeros((1, 2), dtype=torch.long), mode="score")
    with pytest.raises(ValueError, match="labels"):
        model.loss(torch.zeros((1, 2), dtype=torch.long))


@pytest.mark.parametrize("dim,n", [(0, 3), (1, 2), (2, 5)])
def test_repeat_heads_is_repeat_interleave(dim, n):
    """The plain attention's and SSD's head repeats: repeat_interleave's
    values, bit for bit, and its gradient (each copy's summed)."""
    from repro_torch.kernels.ref import repeat_heads

    x = torch.randn((2, 3, 4, 5), generator=torch.Generator().manual_seed(dim))
    assert torch.equal(repeat_heads(x, n, dim), x.repeat_interleave(n, dim=dim))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    w = torch.randn(repeat_heads(x, n, dim).shape, generator=torch.Generator().manual_seed(9))
    (repeat_heads(a, n, dim) * w).sum().backward()
    (b.repeat_interleave(n, dim=dim) * w).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def test_stacked_ndims_read_the_references_layout():
    """The reference stacks each layer group's tensors on a leading axis,
    and its AdamW decays what has 2 dims there: a layer's vectors, not its
    scalars; at the top level the matrices only."""
    cfg, pcfg = _configs("hymba-1.5b")
    model = _port_model(pcfg, _ref_params(cfg))
    nd = model.stacked_ndims()
    assert nd["embed"] == nd["head"] == 2 and nd["final_norm"] == 1
    assert nd["layers.0.norm1"] == nd["layers.0.ssm.A_log"] == 2
    assert nd["layers.0.fuse_a"] == 1 and nd["layers.0.attn.wq"] == 3
    cfg, pcfg = _configs("llama-3.2-vision-90b")
    model = _port_model(pcfg, _ref_params(cfg))
    xattn = model.kinds.index("xattn")
    assert model.stacked_ndims()[f"layers.{xattn}.gate_attn"] == 1
