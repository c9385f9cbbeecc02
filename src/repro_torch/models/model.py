"""Top-level model: embedding -> decoder layers -> norm -> LM head.

Counterpart of ``repro.models.model`` for training and serving (prefill
and decode) of every layer kind: ``attn``, ``local``, ``global``, ``moe``,
``ssm``, ``hybrid`` and ``xattn``, with token or embedding inputs, image
tokens and the int8 KV cache. The reference stacks each layer group's
parameters on a leading ``reps`` axis and scans it; the port keeps one
module per layer (``Model.layers``, in layer order) and loops.
``params_from_reference`` and ``caches_from_reference`` /
``caches_to_reference`` carry weights and caches (KV caches, int8 caches
and their scales, image K/V caches, SSM conv windows and states) between
the two layouts.

Inputs are the reference's batch keys as keyword tensors: ``tokens`` (B,
S) int, or ``embeds`` (B, S, d_model) with ``cfg.embed_inputs`` (then, with
untied embeddings, there is no ``embed`` parameter), and in the prefill
and in training ``image_embeds`` (B, n_image_tokens, d_model) with
``cfg.n_image_tokens``. ``tokens``' embeddings and ``embeds`` are cast to
``cfg.dtype``; ``image_embeds`` are not, as in the reference: the image
K/V take their dtype promoted with the weights' (f32 in a bf16 model fed
f32 embeddings).

Mixed precision as the reference's ``_cast_group``: parameters are stored
in ``cfg.param_dtype`` (f32); in the layers every matrix (>= 2 dims, the
SSM's conv taps and the MoE's stacked experts among them) computes in
``cfg.dtype`` (bf16 at full size) except the MoE ``router``, which stays
f32 as the reference's does, and vectors and scalars (the norms, the SSM's
A_log, D, dt_bias and conv bias, the hybrid's fuse scalars, the
cross-attention gates) stay in f32; the LM head multiplies in f32. Serving
keeps the ``cfg.dtype`` copies of the matrices (``_layer_params``) until a
parameter changes, where the reference casts them anew in every step;
training casts them anew in every forward, inside the autograd graph, so
the gradient reaches the f32 parameter. A float32 matrix product must not
run in TF32 on the card: callers set
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default;
``launch.serve`` and ``launch.train`` set it).

Forward modes return:
  train    (hidden, None, aux) from ``forward``, recording the autograd
           graph (the serving modes run under ``torch.no_grad()``); each
           layer is checkpointed (``torch.utils.checkpoint``, the
           counterpart of the reference's ``jax.checkpoint`` over its scan
           body): its activations are recomputed in the backward. The
           attention and SSD run their plain versions, never K5, K6 or K7,
           as the reference's train mode does. ``loss`` gives the mean
           next-token cross entropy + 0.01 x the MoE aux loss
  prefill  (hidden, caches, aux) from ``forward``; ``prefill`` gives the
           last position's logits and the caches
  decode   one token per sequence; ``decode_step`` gives its logits and the
           caches, updated in place

Parameters are created without gradients (serving records no graph);
``train_mode()`` makes every one trainable.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import BlockCtx, block_cache_init, block_fwd, block_init
from repro_torch.models.layers import dtype_of, embed_init, rmsnorm_fwd, rmsnorm_init

Params = Dict[str, Any]
NOT_PORTED = ("not ported yet (ROADMAP Queue 1 item 12, slice 23: the sharded LM "
              "stack over a mesh; item 13: the XLA tooling)")
MODES = ("train", "prefill", "decode")


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: leaves become parameters
    (created without gradients; see ``Model.train_mode``), dicts become
    submodules, so ``state_dict`` keys are the dict paths joined by dots."""

    def __init__(self, tree: Params):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))

    def tree(self, fn: Callable[[str, torch.Tensor], torch.Tensor],
             prefix: str = "") -> Params:
        """The nested dict again, each leaf mapped by fn(full name, leaf)."""
        out: Params = {n: fn(prefix + n, p) for n, p in self.named_parameters(recurse=False)}
        for n, m in self.named_children():
            out[n] = m.tree(fn, f"{prefix}{n}.")
        return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: Union[str, torch.device] = "cuda",
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.plan = cfg.layer_plan()
        self.kinds = cfg.layer_plan_flat()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model(device='cuda') needs a CUDA card; pass "
                               "device='cpu' to run the plain path on the CPU")
        params = self._draw(seed, device)
        if "embed" in params:
            self.embed = nn.Parameter(params["embed"], requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(params["head"], requires_grad=False)
        self.final_norm = nn.Parameter(params["final_norm"], requires_grad=False)
        self.layers = nn.ModuleList(ParamTree(p) for p in params["layers"])
        #: parameter name -> ((data_ptr, version), copy in cfg.dtype)
        self._cast_cache: Dict[str, Tuple[Tuple[int, int], torch.Tensor]] = {}

    # ------------------------------------------------------------- init

    def _draw(self, seed: int, device: torch.device) -> Params:
        cfg = self.cfg
        dtype = dtype_of(cfg.param_dtype)
        # a meta model (shapes and dtypes, no storage) draws nothing
        gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
        params: Params = {}
        if not cfg.embed_inputs or cfg.tie_embeddings:
            params["embed"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            params["head"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                        device).T.contiguous()
        params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
        params["layers"] = [block_init(gen, cfg, kind, dtype, device)
                            for kind in self.kinds]
        return params

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Redraw every parameter from ``seed`` (the values differ from the
        reference's ``jax.random`` stream); returns the model."""
        fresh = self._draw(seed, self.final_norm.device)
        flat = {k: fresh[k] for k in ("embed", "head", "final_norm") if k in fresh}
        for li, layer in enumerate(fresh["layers"]):
            flat.update(_flatten(layer, f"layers.{li}."))
        self.load_state_dict(flat)
        return self

    def stacked_ndims(self) -> Dict[str, int]:
        """Each parameter's dims as the reference stores it: a layer's
        tensors carry its layer group's leading ``reps`` axis (what its
        AdamW's decay rule reads)."""
        return {n: p.ndim + n.startswith("layers.") for n, p in self.named_parameters()}

    def train_mode(self) -> "Model":
        """Make every parameter trainable (``requires_grad``); returns the
        model. The serving modes still record no graph."""
        for p in self.parameters():
            p.requires_grad_(True)
        return self

    def init_caches(self, batch: int, capacity: int) -> List[Params]:
        """One zeroed cache per layer: {"attn": {"k", "v"}} of (B, Hkv,
        capacity, hd) in ``cfg.dtype`` for an attention layer (int8 with
        "k_scale" and "v_scale" under ``kv_quant``; n_image_tokens
        positions for an ``xattn`` layer), {"ssm": {"conv", "ssd"}} for an
        SSM layer, both for a hybrid one."""
        dtype = dtype_of(self.cfg.dtype)
        return [block_cache_init(self.cfg, kind, batch, capacity, dtype,
                                 self.final_norm.device) for kind in self.kinds]

    # ---------------------------------------------------------- forward

    def _layer_params(self, li: int, train: bool = False) -> Params:
        """Layer li's parameters with its matrices in ``cfg.dtype`` (the
        reference's ``_cast_group``: every floating matrix but the MoE
        router). For serving the cast copies are kept until the
        parameter's storage or version changes; for training (``train``)
        each is cast anew inside the autograd graph, so its gradient
        reaches the parameter."""
        act = dtype_of(self.cfg.dtype)

        def cast(name: str, w: torch.Tensor) -> torch.Tensor:
            if (w.ndim < 2 or not w.is_floating_point() or w.dtype == act
                    or name.endswith(".router")):
                return w
            if train:
                return w.to(act)
            key = (w.data_ptr(), w._version)
            hit = self._cast_cache.get(name)
            if hit is None or hit[0] != key:
                hit = self._cast_cache[name] = (key, w.detach().to(act))
            return hit[1]

        return self.layers[li].tree(cast, f"layers.{li}.")

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed.T if self.cfg.tie_embeddings else self.head
        return x.float() @ w.float()

    def _embed(self, tokens: Optional[torch.Tensor],
               embeds: Optional[torch.Tensor]) -> torch.Tensor:
        if self.cfg.embed_inputs:
            if embeds is None:
                raise ValueError(f"{self.cfg.name} takes embeds (B, S, d_model), "
                                 f"not tokens")
            x = embeds
        else:
            if tokens is None:
                raise ValueError(f"{self.cfg.name} takes tokens (B, S)")
            x = F.embedding(tokens, self.embed)
        return x.to(dtype_of(self.cfg.dtype))

    def forward(self, tokens: Optional[torch.Tensor] = None, *, mode: str,
                lengths: Optional[torch.Tensor] = None,
                caches: Optional[List[Params]] = None,
                embeds: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[List[Params]], torch.Tensor]:
        """tokens (B, S) or embeds (B, S, D) -> (hidden (B, S, D) after the
        final norm, caches' (None in train mode), aux: the MoE loss summed
        over layers). ``decode`` takes S == 1, ``lengths`` (B,) int32 and
        the caches; with image tokens, ``train`` and ``prefill`` take
        ``image_embeds`` (B, I, D). Only ``train`` records the autograd
        graph."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; the modes are {MODES}")
        with torch.set_grad_enabled(mode == "train" and torch.is_grad_enabled()):
            return self._forward(tokens, mode, lengths, caches, embeds, image_embeds)

    def _forward(self, tokens, mode, lengths, caches, embeds, image_embeds):
        cfg = self.cfg
        x = self._embed(tokens, embeds)
        B, S = x.shape[:2]
        if mode == "decode":
            if lengths is None or caches is None:
                raise ValueError("decode needs lengths and caches")
            positions = lengths[:, None]
        else:
            positions = torch.arange(S, device=x.device).expand(B, S)
            if cfg.n_image_tokens and image_embeds is None:
                raise ValueError(f"{cfg.name}'s {mode} takes image_embeds "
                                 f"(B, {cfg.n_image_tokens}, d_model)")
        ctx = BlockCtx(mode=mode, positions=positions, lengths=lengths,
                       image_embeds=image_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if mode == "train":
            for li, kind in enumerate(self.kinds):
                # per-layer activation checkpointing: the layer (its casts
                # included) runs again in the backward
                x, a = checkpoint(self._train_layer, li, kind, x, ctx, use_reentrant=False)
                aux = aux + a
            return rmsnorm_fwd(self.final_norm, x, cfg.norm_eps), None, aux
        new_caches = []
        for li, kind in enumerate(self.kinds):
            x, c, a = block_fwd(self._layer_params(li), x, cfg=cfg, kind=kind, ctx=ctx,
                                cache=caches[li] if caches is not None else None)
            new_caches.append(c)
            aux = aux + a
        x = rmsnorm_fwd(self.final_norm, x, cfg.norm_eps)
        return x, new_caches, aux

    def _train_layer(self, li: int, kind: str, x: torch.Tensor, ctx: BlockCtx):
        x, _, aux = block_fwd(self._layer_params(li, train=True), x, cfg=self.cfg,
                              kind=kind, ctx=ctx)
        return x, aux

    # -------------------------------------------------------------- loss

    def loss(self, tokens: Optional[torch.Tensor] = None,
             labels: Optional[torch.Tensor] = None, *,
             embeds: Optional[torch.Tensor] = None,
             image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean next-token cross entropy over ``labels`` (B, S), shifted by
        the caller (the pipeline), plus 0.01 x the MoE aux loss; logits in
        f32 through the head, ``cfg.loss_chunk`` positions at a time (each
        chunk checkpointed) when it divides S. Call ``backward()`` on it
        for the gradients."""
        if labels is None:
            raise ValueError("loss takes labels (B, S)")
        hidden, _, aux = self.forward(tokens, mode="train", embeds=embeds,
                                      image_embeds=image_embeds)
        B, S, _ = hidden.shape
        chunk = self.cfg.loss_chunk
        if chunk and S % chunk == 0 and chunk < S:
            total = sum(checkpoint(self._ce_sum, hidden[:, i:i + chunk],
                                   labels[:, i:i + chunk], use_reentrant=False)
                        for i in range(0, S, chunk))
        else:
            total = self._ce_sum(hidden, labels)
        return total / (B * S) + 0.01 * aux

    def _ce_sum(self, h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Summed cross entropy of hidden states h (B, c, D) at labels y."""
        logits = self._head(h)
        lse = torch.logsumexp(logits, dim=-1)
        return (lse - logits.gather(-1, y[..., None].long())[..., 0]).sum()

    # ------------------------------------------------------- serve steps

    @torch.no_grad()
    def prefill(self, tokens: Optional[torch.Tensor] = None, *,
                embeds: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, List[Params]]:
        """Run the whole prompt, tokens (B, S) or embeds (B, S, D); returns
        (last-position logits (B, V) f32, caches of capacity S)."""
        hidden, caches, _ = self.forward(tokens, mode="prefill", embeds=embeds,
                                         image_embeds=image_embeds)
        return self._head(hidden[:, -1]), caches

    @torch.no_grad()
    def decode_step(self, tokens: Optional[torch.Tensor] = None,
                    lengths: Optional[torch.Tensor] = None,
                    caches: Optional[List[Params]] = None, *,
                    embeds: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, List[Params]]:
        """One position per sequence, tokens (B, 1) or embeds (B, 1, D), at
        positions ``lengths``; returns (logits (B, V) f32, caches with the
        position written)."""
        hidden, caches, _ = self.forward(tokens, mode="decode", lengths=lengths,
                                         caches=caches, embeds=embeds)
        return self._head(hidden[:, 0]), caches


# ------------------------------------------------ weights across frameworks


def _flatten(tree: Params, prefix: str = ""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _tensor(a) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor; bfloat16 (``ml_dtypes``,
    which ``torch.from_numpy`` refuses) goes through float32."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _layer_slots(cfg: ModelConfig):
    """(layer index, group, sub-layer, rep) in layer order."""
    li = 0
    for gi, (kinds, reps) in enumerate(cfg.layer_plan()):
        for r in range(reps):
            for i in range(len(kinds)):
                yield li, gi, i, r
                li += 1


def params_from_reference(cfg: ModelConfig, params: Params) -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree (numpy arrays; each
    ``group{gi}/sub{i}`` leaf carries a leading ``reps`` axis) as this
    port's ``Model.state_dict()``, on the CPU."""
    sd = {k: _tensor(params[k]) for k in ("embed", "head", "final_norm") if k in params}
    for li, gi, i, r in _layer_slots(cfg):
        for path, leaf in _flatten(params[f"group{gi}"][f"sub{i}"]).items():
            sd[f"layers.{li}.{path}"] = _tensor(np.asarray(leaf)[r])
    return sd


def _map(tree: Params, fn: Callable) -> Params:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """int8 stays int8, every other dtype becomes float32."""
    return t.cpu().numpy() if t.dtype == torch.int8 else t.float().cpu().numpy()


def _stack(trees: List[Params]) -> Params:
    """Dicts of one structure -> one dict of their leaves stacked (float32
    numpy; int8 stays int8)."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else np.stack([_numpy(t[k]) for t in trees])
            for k, v in trees[0].items()}


def caches_from_reference(cfg: ModelConfig, caches) -> List[Params]:
    """The reference's per-group caches (a tuple per group, one dict per
    sub-layer, each leaf with a leading ``reps`` axis) as one cache per
    layer, on the CPU."""
    return [_map(caches[gi][i], lambda a, r=r: _tensor(np.asarray(a)[r]))
            for _, gi, i, r in _layer_slots(cfg)]


def caches_to_reference(cfg: ModelConfig, caches: List[Params]) -> List[tuple]:
    """One cache per layer back to the reference's layout, as float32 numpy
    (int8 caches as int8; their bf16 scales as float32)."""
    out = []
    li = 0
    for kinds, reps in cfg.layer_plan():
        n = len(kinds)
        out.append(tuple(_stack([caches[li + r * n + i] for r in range(reps)])
                         for i in range(n)))
        li += reps * n
    return out
