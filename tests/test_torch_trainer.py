"""The port's trainer (``launch/steps.py``, ``launch/train.py``) and data
pipeline (``data/pipeline.py``) against the JAX package's, on the CPU.

- ``make_train_step`` at ``accum`` 1 and 2 on reduced internlm2,
  granite-moe and hymba (B = 4, S = 16), from the reference's weights and
  batch: the loss and ``grad_norm`` within rtol=1e-5, the moments within
  1e-4 of each tensor's max, every parameter after the update within
  atol=1e-4 of the reference's. The optimizer there takes lr 1e-2 and eps
  1e-3 in both packages, so an update moves each element by up to 1e-2 and
  is smooth in the gradient (Adam's first step is lr x g / (|g| + eps):
  with eps 1e-8 a gradient near 1e-8 flips its element's update between
  the two packages' roundings).
- ``train()`` over 6 steps, fed the reference's initial weights and
  batches (``Model.init`` and ``SyntheticTokenPipeline.batch_at`` stood in
  for), its losses within rtol=1e-5 of the reference ``train``'s.
- The reference's ``tests/test_checkpoint.py`` trainer-restart and
  pipeline cases on the port (its elastic restore across meshes needs a
  mesh: ROADMAP Queue 1 item 12, slice 23), the restart's losses bit for
  bit the uninterrupted run's.
- ``input_specs`` / ``abstract_*`` (meta tensors) for every arch and
  shape, ``step_flops_estimate`` equal to the reference's, the prefill and
  serve steps, the command line.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as ref_config
from repro.configs.registry import get_shape as ref_shape
from repro.data.pipeline import SyntheticTokenPipeline as RefPipeline
from repro.launch import steps as ref_steps
from repro.launch.train import train as ref_train
from repro.models.model import Model as RefModel
from repro.optim.optimizer import AdamW as RefAdamW
from repro.optim.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import _grow_caches
from repro_torch.models.model import Model, params_from_reference
from repro_torch.optim.optimizer import AdamW, AdamWConfig

STEP_ARCHS = ["internlm2-1.8b", "granite-moe-3b-a800m", "hymba-1.5b"]
OPT = dict(lr=1e-2, eps=1e-3, warmup_steps=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    a = np.array(a, copy=True)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _rel_close(got, want, rel, name):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + 1e-30, f"{name}: {err} against max {scale}"


# ------------------------------------------------------------- steps


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", STEP_ARCHS)
def test_train_step_matches_the_reference(name, accum):
    cfg = ref_config(name).reduced()
    pcfg = _port_cfg(cfg)
    params = _np(RefModel(cfg).init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ref_opt = RefAdamW(RefAdamWConfig(**OPT))
    step = jax.jit(ref_steps.make_train_step(RefModel(cfg), ref_opt, accum))
    new_p, ref_state, ref_m = step(params, ref_opt.init(params), batch)
    want = params_from_reference(pcfg, _np(new_p))
    want_m = params_from_reference(pcfg, _np(ref_state.m))

    model = Model(pcfg, device="cpu")
    model.load_state_dict(params_from_reference(pcfg, params))
    opt = AdamW(AdamWConfig(**OPT))
    train_step = steps_lib.make_train_step(model, opt, accum)
    named = dict(model.named_parameters())
    state, metrics = train_step(opt.init(named), {k: _t(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[key]), float(ref_m[key]), rtol=1e-5)
    assert int(state.step) == 1
    for n, p in named.items():
        assert p.grad is None, n  # the gradients' memory went back
        _rel_close(state.m[n], want_m[n], 1e-4, n)
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=1e-4,
                                   err_msg=n)


def test_accumulation_averages_the_microbatches():
    """accum 2 on a batch of two identical halves equals accum 1 on one
    half: the same loss, gradients and update."""
    cfg = get_config("internlm2-1.8b").reduced()
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(1))
    half = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for accum, batch in ((1, half), (2, {k: torch.cat([v, v]) for k, v in half.items()})):
        model = Model(cfg, device="cpu")
        opt = AdamW(AdamWConfig(**OPT))
        named = dict(model.named_parameters())
        state, metrics = steps_lib.make_train_step(model, opt, accum)(opt.init(named), batch)
        out.append((metrics, {n: p.detach().clone() for n, p in named.items()}))
    (m1, p1), (m2, p2) = out
    for key in ("loss", "grad_norm"):
        assert float(m2[key]) == pytest.approx(float(m1[key]), rel=1e-6)
    for n in p1:
        np.testing.assert_allclose(p2[n].numpy(), p1[n].numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        steps_lib.make_train_step(Model(cfg, device="cpu"), AdamW(), 3)(
            AdamW().init(dict(Model(cfg, device="cpu").named_parameters())), half)


def _feed_reference(monkeypatch, cfg, pcfg, B, S, seed=0):
    """The port's train() started from the reference's weights and fed the
    reference pipeline's batches."""
    sd = params_from_reference(pcfg, _np(RefModel(cfg).init(jax.random.PRNGKey(seed))))
    pipe = RefPipeline(cfg, ref_shape("train_4k"), seed=seed, batch_override=B,
                       seq_override=S)

    def init(self, seed=0):
        self.load_state_dict(sd)
        return self

    monkeypatch.setattr(Model, "init", init)
    monkeypatch.setattr(SyntheticTokenPipeline, "batch_at",
                        lambda self, step: {k: _t(v) for k, v in _np(pipe.batch_at(step)).items()})


@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-moe-3b-a800m", "hymba-1.5b",
                                  "musicgen-medium"])
def test_train_losses_match_the_reference_over_six_steps(name, monkeypatch):
    cfg = ref_config(name).reduced()
    want = ref_train(cfg, ref_shape("train_4k"), steps=6, batch=2, seq=16,
                     verbose=False, profile=False)
    pcfg = _port_cfg(cfg)
    _feed_reference(monkeypatch, cfg, pcfg, 2, 16)
    got = train_mod.train(pcfg, get_shape("train_4k"), steps=6, batch=2, seq=16,
                          verbose=False, profile=False, device="cpu")
    assert got.steps_run == 6 and got.restarts == 0
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.final_loss == got.losses[-1]
    assert all(np.isfinite(got.grad_norms))


def test_trainer_restart_matches_uninterrupted(tmp_path):
    """The reference's drill on the port: a crash at step 12, checkpoints
    every 8; the restart re-runs steps 8-11 and every loss equals the
    uninterrupted run's, bit for bit."""
    cfg = get_config("internlm2-1.8b").reduced()
    shape = get_shape("train_4k")
    kw = dict(steps=16, batch=2, seq=16, ckpt_every=8, verbose=False, profile=False,
              device="cpu")
    a = train_mod.train(cfg, shape, ckpt_dir=str(tmp_path / "x"), fail_at=(12,), **kw)
    b = train_mod.train(cfg, shape, ckpt_dir=str(tmp_path / "y"), **kw)
    assert a.restarts == 1 and b.restarts == 0
    assert len(a.losses) == 20 and len(b.losses) == 16
    assert a.losses[:12] == b.losses[:12]
    assert a.losses[12:] == b.losses[8:]


def test_checkpoints_hold_the_state_and_the_pipeline(tmp_path):
    cfg = get_config("mamba2-130m").reduced()
    train_mod.train(cfg, get_shape("train_4k"), steps=4, batch=2, seq=8, ckpt_every=2,
                    seed=3, ckpt_dir=str(tmp_path), verbose=False, profile=False,
                    device="cpu")
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["extra"] == {"step": 4, "pipeline": {"step": 4, "seed": 3}}
    keys = set(manifest["keys"])
    names = set(Model(cfg, device="cpu").state_dict())
    assert {f"params/{n}" for n in names} | {"opt/.step"} <= keys
    assert {f"opt/.m/{n}" for n in names} <= keys and {f"opt/.v/{n}" for n in names} <= keys


def test_train_reports_overheads_and_refuses_a_mesh(capsys):
    cfg = get_config("stablelm-3b").reduced()
    res = train_mod.train(cfg, get_shape("train_4k"), steps=3, batch=2, seq=8,
                          log_every=1, device="cpu")
    out = capsys.readouterr().out
    assert out.count("loss ") == 3 and "overhead report" in out
    assert res.report is not None and res.report.steps == 2
    with pytest.raises(NotImplementedError, match="slice 23"):
        train_mod.train(cfg, get_shape("train_4k"), steps=1, mesh=object(), device="cpu")


def test_cli_runs_reduced_on_the_cpu(capsys):
    assert train_mod.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "4",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "after 4 steps (0 restarts)" in out
    with pytest.raises(NotImplementedError, match="slice 23"):
        train_mod.main(["--arch", "internlm2-1.8b", "--reduced", "--mesh", "4:data"])


# --------------------------------------------------------- pipeline


def _pipe(name="internlm2-1.8b", **kw):
    cfg = get_config(name).reduced()
    kw.setdefault("batch_override", 2)
    kw.setdefault("seq_override", 8)
    return SyntheticTokenPipeline(cfg, get_shape("train_4k"), **kw)


def test_pipeline_deterministic_and_stateless():
    p1, p2 = _pipe(seed=3), _pipe(seed=3)
    b1, b2 = p1.batch_at(11), p2.batch_at(11)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], p1.batch_at(12)["tokens"])
    assert not torch.equal(b1["tokens"], _pipe(seed=4).batch_at(11)["tokens"])
    p1.batch_at(5)
    assert torch.equal(p1.batch_at(11)["tokens"], b1["tokens"])  # no state moved


def test_pipeline_labels_are_shifted_tokens():
    cfg = get_config("internlm2-1.8b").reduced()
    b = _pipe().batch_at(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].dtype == b["labels"].dtype == torch.int64
    assert bool((b["tokens"] < cfg.vocab).all()) and bool((b["tokens"] >= 0).all())


def test_pipeline_checkpoint_roundtrip():
    p = _pipe(seed=5)
    it = iter(p)
    next(it), next(it), next(it)
    sd = p.state_dict()
    assert sd == {"step": 3, "seed": 5}
    q = _pipe(seed=5)
    q.load_state_dict(sd)
    assert torch.equal(next(iter(p))["tokens"], next(iter(q))["tokens"])
    with pytest.raises(ValueError, match="seed"):
        _pipe(seed=6).load_state_dict(sd)


def test_pipeline_modality_extras():
    cfg = get_config("llama-3.2-vision-90b").reduced()
    b = _pipe("llama-3.2-vision-90b").batch_at(0)
    assert b["image_embeds"].shape == (2, cfg.n_image_tokens, cfg.d_model)
    cfg2 = get_config("musicgen-medium").reduced()
    b2 = _pipe("musicgen-medium").batch_at(0)
    assert b2["embeds"].shape == (2, 8, cfg2.d_model)
    assert "embeds" not in _pipe().batch_at(0)


def test_pipeline_extras_take_the_models_dtype_and_scale():
    cfg = dataclasses.replace(get_config("musicgen-medium").reduced(), dtype="bfloat16")
    pipe = SyntheticTokenPipeline(cfg, get_shape("train_4k"), batch_override=4,
                                  seq_override=64)
    e = pipe.batch_at(0)["embeds"]
    assert e.dtype == torch.bfloat16
    assert float(e.float().std()) == pytest.approx(0.02, rel=0.05)


def test_pipeline_skews_to_low_ids_as_the_references():
    """A squared uniform times the vocabulary: P(id < v/4) = 1/2, mean
    v/3, in both packages."""
    cfg = get_config("internlm2-1.8b")
    shape = get_shape("train_4k")
    got = SyntheticTokenPipeline(cfg, shape, batch_override=8, seq_override=512).batch_at(0)
    want = np.asarray(RefPipeline(ref_config("internlm2-1.8b"), ref_shape("train_4k"),
                                  batch_override=8, seq_override=512).batch_at(0)["tokens"])
    for toks in (got["tokens"].numpy(), want):
        assert np.mean(toks < cfg.vocab / 4) == pytest.approx(0.5, abs=0.02)
        assert np.mean(toks) / cfg.vocab == pytest.approx(1 / 3, abs=0.02)


def test_prefetch_yields_the_stream_in_order():
    p, q = _pipe(seed=1), _pipe(seed=1)
    ahead = p.prefetch()
    for step in range(3):
        assert torch.equal(next(ahead)["tokens"], q.batch_at(step)["tokens"])
    assert p.state.step == 4  # one batch made ahead


# --------------------------------------------------- specs and steps


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_abstract(arch, shape_name):
    """The reference's check on the port: meta tensors, the cell's shapes,
    a decode cache of the stated context (attention layers; SSM states are
    O(1) in it)."""
    cfg, shape = get_config(arch), get_shape(shape_name)
    specs = steps_lib.input_specs(cfg, shape)
    leaves = list(_leaves(specs))
    assert leaves and all(t.is_meta for t in leaves)
    tokens = specs["batch"]["tokens"]
    if shape.kind == "train":
        assert tokens.shape == specs["batch"]["labels"].shape == (shape.global_batch,
                                                                  shape.seq_len)
    if shape.kind == "decode":
        assert tokens.shape == (shape.global_batch, 1)
        assert specs["lengths"].shape == (shape.global_batch,)
        assert len(specs["caches"]) == cfg.n_layers
        if cfg.family != "ssm":
            kv = [t for t in _leaves(specs["caches"]) if t.ndim == 4]
            assert any(t.shape[2] == shape.seq_len for t in kv)
    want = ref_steps.input_specs(ref_config(arch), ref_shape(shape_name))["batch"]
    assert set(specs["batch"]) == set(want)
    for k, t in specs["batch"].items():
        assert tuple(t.shape) == tuple(want[k].shape), k


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_and_opt_state(arch):
    cfg = get_config(arch)
    params = steps_lib.abstract_params(cfg)
    assert all(t.is_meta for t in params.values())
    want = jax.tree.leaves(ref_steps.abstract_params(ref_config(arch)))
    assert sum(t.numel() for t in params.values()) == sum(int(np.prod(w.shape)) for w in want)
    opt = steps_lib.abstract_opt_state(cfg)
    assert set(opt.m) == set(opt.v) == set(params)
    for n, t in params.items():
        assert opt.m[n].is_meta and opt.m[n].dtype == torch.float32
        assert opt.m[n].shape == t.shape


def test_step_flops_estimate_orders():
    cfg = get_config("internlm2-1.8b")
    tr = steps_lib.step_flops_estimate(cfg, get_shape("train_4k"))
    pf = steps_lib.step_flops_estimate(cfg, get_shape("prefill_32k"))
    dc = steps_lib.step_flops_estimate(cfg, get_shape("decode_32k"))
    assert tr > pf > dc
    moe = get_config("mixtral-8x7b")
    assert steps_lib.step_flops_estimate(moe, get_shape("train_4k")) < \
        6.0 * moe.param_count() * 4096 * 256


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_step_flops_estimate_equals_the_references(arch):
    for shape in SHAPES:
        assert steps_lib.step_flops_estimate(get_config(arch), shape) == \
            ref_steps.step_flops_estimate(ref_config(arch), ref_shape(shape.name))


def test_prefill_and_serve_steps():
    cfg = get_config("gemma3-4b").reduced()
    model = Model(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(0))
    logits, caches = steps_lib.make_prefill_step(model)({"tokens": tokens})
    want, _ = model.prefill(tokens)
    assert torch.equal(logits, want)
    caches = _grow_caches(model, caches, 2, 8)
    lengths = torch.full((2,), 6, dtype=torch.int32)
    nxt = logits.argmax(-1)[:, None]
    got_tok, _ = steps_lib.make_serve_step(model)({"tokens": nxt}, lengths, caches)
    _, ref_caches = model.prefill(tokens)
    want_logits, _ = model.decode_step(nxt, lengths, _grow_caches(model, ref_caches, 2, 8))
    assert torch.equal(got_tok, want_logits.argmax(-1))
