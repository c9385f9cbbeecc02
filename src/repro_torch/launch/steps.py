"""Step builders + abstract input specs shared by train and serve.

Counterpart of ``repro.launch.steps`` on one device. ``input_specs(cfg,
shape)`` gives a stand-in for every model input of a cell, and
``abstract_params`` / ``abstract_caches`` / ``abstract_opt_state`` the
same for the parameters, caches and optimizer state: meta-device tensors,
shapes and dtypes with no storage (the reference's ``ShapeDtypeStruct``s
from ``jax.eval_shape``). The port's parameters and caches are one entry a
layer (``Model.state_dict()`` names; a list of per-layer caches), not the
reference's stacked layer groups, and its token ids are int64.

The parameters live in the ``Model``: a train step reads them and the
optimizer updates them in place. The reference's ``grad_shardings`` (ZeRO-1
over a mesh) is not ported yet (ROADMAP Queue 1 item 12, slice 23).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model
from repro_torch.optim.optimizer import AdamW, AdamWState

META = torch.device("meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch_override: Optional[int] = None,
                seq_override: Optional[int] = None) -> Dict[str, Any]:
    """The cell's step inputs as meta tensors: {"batch": {...}} for train
    and prefill, plus "lengths" and "caches" (capacity S) for decode."""
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    dt = dtype_of(cfg.dtype)

    def spec(*dims, dtype=torch.int64):
        return torch.empty(dims, dtype=dtype, device=META)

    S_in = 1 if shape.kind == "decode" else S
    batch = {"tokens": spec(B, S_in)}
    if shape.kind == "train":
        batch["labels"] = spec(B, S)
    if cfg.embed_inputs:
        batch["embeds"] = spec(B, S_in, cfg.d_model, dtype=dt)
    if cfg.n_image_tokens and shape.kind != "decode":
        batch["image_embeds"] = spec(B, cfg.n_image_tokens, cfg.d_model, dtype=dt)
    if shape.kind != "decode":
        return {"batch": batch}
    # decode: one new token against a cache of length S
    return {"batch": batch, "lengths": spec(B, dtype=torch.int32),
            "caches": abstract_caches(cfg, B, S)}


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    return dict(Model(cfg, device=META).state_dict())


def abstract_caches(cfg: ModelConfig, batch: int, capacity: int) -> List[Any]:
    return Model(cfg, device=META).init_caches(batch, capacity)


def abstract_opt_state(cfg: ModelConfig) -> AdamWState:
    return AdamW().init(abstract_params(cfg))


# ------------------------------------------------------------------ steps


def make_train_step(model: Model, optimizer: AdamW, accum: int = 1
                    ) -> Callable[[AdamWState, Dict[str, torch.Tensor]],
                                  Tuple[AdamWState, Dict[str, torch.Tensor]]]:
    """One optimizer step on ``model``'s parameters (made trainable here):
    ``train_step(opt_state, batch) -> (opt_state, metrics)``, metrics
    {"loss", "grad_norm", "lr"} as 0-d tensors. With ``accum > 1`` the
    batch is split into ``accum`` microbatches along its first dim; their
    gradients accumulate in f32 and are averaged, as is the loss, before
    the one update (the reference's scan), so peak activation memory scales
    1/accum."""
    model.train_mode()
    params = dict(model.named_parameters())
    ndims = model.stacked_ndims()  # the reference's decay rule, on its layout

    def grads_of(batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        model.zero_grad(set_to_none=True)
        loss = model.loss(**batch)
        loss.backward()
        return loss.detach(), {n: torch.zeros_like(p) if p.grad is None else p.grad
                               for n, p in params.items()}

    def train_step(opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        if accum <= 1:
            loss, grads = grads_of(batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into {accum} microbatches")
            loss = torch.zeros((), dtype=torch.float32, device=model.final_norm.device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in params.items()}
            for mb in range(accum):
                rows = slice(mb * (B // accum), (mb + 1) * (B // accum))
                li, gi = grads_of({k: v[rows] for k, v in batch.items()})
                loss = loss + li
                for n, g in gi.items():
                    grads[n].add_(g)
            loss = loss / accum
            for g in grads.values():
                g.div_(accum)
        _, opt_state, metrics = optimizer.update(grads, opt_state, params, ndims)
        model.zero_grad(set_to_none=True)  # the gradients' memory goes back
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(batch: Dict[str, torch.Tensor]):
        return model.prefill(**batch)  # (last-position logits, caches)

    return prefill_step


def make_serve_step(model: Model):
    """One decode step: append the token, read the cache, emit the next
    token greedily."""

    def serve_step(batch: Dict[str, torch.Tensor], lengths: torch.Tensor, caches):
        logits, caches = model.decode_step(lengths=lengths, caches=caches, **batch)
        return logits.argmax(dim=-1), caches

    return serve_step


def step_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the roofline: 6ND train, 2ND prefill, 2N_active x B
    decode (N = params, N_active = params with only top-k experts counted)."""
    n = cfg.param_count()
    if cfg.n_experts:
        ff = cfg.d_ff_expert or cfg.d_ff
        expert_params = cfg.n_experts * 3 * cfg.d_model * ff * cfg.n_layers
        active = n - expert_params + expert_params * cfg.top_k / cfg.n_experts
    else:
        active = n
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch  # decode: one token per seq
