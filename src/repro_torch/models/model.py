"""Top-level model: embedding -> decoder layers -> norm -> LM head.

Counterpart of ``repro.models.model`` for serving (prefill and decode) of
the dense kinds ``attn``, ``local`` and ``global``, the Mamba-2 kind
``ssm`` and the Hymba kind ``hybrid``. The reference stacks each layer
group's parameters on a leading ``reps`` axis and scans it; the port keeps
one module per layer (``Model.layers``, in layer order) and loops.
``params_from_reference`` and ``caches_from_reference`` /
``caches_to_reference`` carry weights and caches (KV caches, SSM conv
windows and states) between the two layouts.

Mixed precision as the reference's ``_cast_group``: parameters are stored
in ``cfg.param_dtype`` (f32); in the layers every matrix (>= 2 dims, the
SSM's conv taps among them) computes in ``cfg.dtype`` (bf16 at full size)
and vectors and scalars (the norms, the SSM's A_log, D, dt_bias and conv
bias, the hybrid's fuse scalars) stay in f32; the LM head multiplies in
f32. The bf16 copies of the matrices are made once and kept
(``_layer_params``) until a parameter changes, where the reference casts
them anew in every step. A float32 matrix product must not run in TF32 on
the card: callers set ``torch.backends.cuda.matmul.allow_tf32 = False``
(PyTorch's default; ``launch.serve`` sets it).

Forward modes return:
  prefill  (hidden, caches, aux) from ``forward``; ``prefill`` gives the
           last position's logits and the caches
  decode   one token per sequence; ``decode_step`` gives its logits and the
           caches, updated in place

Not ported yet, each raising ``NotImplementedError`` when the model is
built (ROADMAP Queue 1 item 12): the ``moe`` and ``xattn`` layer kinds,
embedding inputs (``embed_inputs``), image tokens (``n_image_tokens``), the
int8 KV cache (``kv_quant``) and the ``train`` mode with its loss.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (
    KINDS,
    BlockCtx,
    block_cache_init,
    block_fwd,
    block_init,
)
from repro_torch.models.layers import dtype_of, embed_init, rmsnorm_fwd, rmsnorm_init

Params = Dict[str, Any]
NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 12)"


def unported_features(cfg: ModelConfig) -> List[str]:
    """What of ``cfg`` the port cannot run yet; empty when it can serve it."""
    out = [f"layer kind {k!r}" for k in dict.fromkeys(cfg.layer_plan_flat())
           if k not in KINDS]
    if cfg.embed_inputs:
        out.append("embedding inputs (embed_inputs)")
    if cfg.n_image_tokens:
        out.append("image tokens (n_image_tokens)")
    if cfg.kv_quant:
        out.append("the int8 KV cache (kv_quant)")
    return out


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: leaves become parameters (no
    gradient), dicts become submodules, so ``state_dict`` keys are the
    dict paths joined by dots."""

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
        missing = unported_features(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(missing)} {NOT_PORTED}")
        self.cfg = cfg
        self.plan = cfg.layer_plan()
        self.kinds = cfg.layer_plan_flat()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model(device='cuda') needs a CUDA card; pass "
                               "device='cpu' to run the plain path on the CPU")
        params = self._draw(seed, device)
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
        gen = torch.Generator(device=device).manual_seed(seed)
        params: Params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype, device)}
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
        fresh = self._draw(seed, self.embed.device)
        flat = {"embed": fresh["embed"], "final_norm": fresh["final_norm"]}
        if "head" in fresh:
            flat["head"] = fresh["head"]
        for li, layer in enumerate(fresh["layers"]):
            flat.update(_flatten(layer, f"layers.{li}."))
        self.load_state_dict(flat)
        return self

    def init_caches(self, batch: int, capacity: int) -> List[Params]:
        """One zeroed cache per layer: {"attn": {"k", "v"}} of (B, Hkv,
        capacity, hd) in ``cfg.dtype`` for an attention layer, {"ssm":
        {"conv", "ssd"}} for an SSM layer, both for a hybrid one."""
        dtype = dtype_of(self.cfg.dtype)
        return [block_cache_init(self.cfg, kind, batch, capacity, dtype,
                                 self.embed.device) for kind in self.kinds]

    # ---------------------------------------------------------- forward

    def _layer_params(self, li: int) -> Params:
        """Layer li's parameters with its matrices in ``cfg.dtype`` (the
        reference's ``_cast_group``); the cast copies are kept until the
        parameter's storage or version changes."""
        act = dtype_of(self.cfg.dtype)

        def cast(name: str, w: torch.Tensor) -> torch.Tensor:
            if w.ndim < 2 or not w.is_floating_point() or w.dtype == act:
                return w
            key = (w.data_ptr(), w._version)
            hit = self._cast_cache.get(name)
            if hit is None or hit[0] != key:
                hit = self._cast_cache[name] = (key, w.detach().to(act))
            return hit[1]

        return self.layers[li].tree(cast, f"layers.{li}.")

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed.T if self.cfg.tie_embeddings else self.head
        return x.float() @ w.float()

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, mode: str,
                lengths: Optional[torch.Tensor] = None,
                caches: Optional[List[Params]] = None,
                ) -> Tuple[torch.Tensor, List[Params], torch.Tensor]:
        """tokens (B, S) -> (hidden (B, S, D) after the final norm, caches',
        aux). ``decode`` takes S == 1, ``lengths`` (B,) int32 and the caches."""
        cfg = self.cfg
        if mode not in ("prefill", "decode"):
            raise NotImplementedError(f"mode {mode!r} {NOT_PORTED}: the port serves "
                                      f"(prefill, decode)")
        x = self.embed[tokens].to(dtype_of(cfg.dtype))
        B, S = tokens.shape
        if mode == "decode":
            if lengths is None or caches is None:
                raise ValueError("decode needs lengths and caches")
            positions = lengths[:, None]
        else:
            positions = torch.arange(S, device=x.device).expand(B, S)
        ctx = BlockCtx(mode=mode, positions=positions, lengths=lengths)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = []
        for li, kind in enumerate(self.kinds):
            x, c, a = block_fwd(self._layer_params(li), x, cfg=cfg, kind=kind, ctx=ctx,
                                cache=caches[li] if caches is not None else None)
            new_caches.append(c)
            aux = aux + a
        x = rmsnorm_fwd(self.final_norm, x, cfg.norm_eps)
        return x, new_caches, aux

    # ------------------------------------------------------- serve steps

    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, List[Params]]:
        """Run the whole prompt (B, S); returns (last-token logits (B, V) f32,
        caches of capacity S)."""
        hidden, caches, _ = self.forward(tokens, mode="prefill")
        return self._head(hidden[:, -1]), caches

    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    caches: List[Params]) -> Tuple[torch.Tensor, List[Params]]:
        """One token per sequence, tokens (B, 1) at positions ``lengths``;
        returns (logits (B, V) f32, caches with the token written)."""
        hidden, caches, _ = self.forward(tokens, mode="decode", lengths=lengths,
                                         caches=caches)
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
    return torch.from_numpy(np.array(a, copy=True))


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


def _stack(trees: List[Params]) -> Params:
    """Dicts of one structure -> one dict of their leaves stacked (float32
    numpy)."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else np.stack([t[k].float().cpu().numpy() for t in trees])
            for k, v in trees[0].items()}


def caches_from_reference(cfg: ModelConfig, caches) -> List[Params]:
    """The reference's per-group caches (a tuple per group, one dict per
    sub-layer, each leaf with a leading ``reps`` axis) as one cache per
    layer, on the CPU."""
    return [_map(caches[gi][i], lambda a, r=r: _tensor(np.asarray(a)[r]))
            for _, gi, i, r in _layer_slots(cfg)]


def caches_to_reference(cfg: ModelConfig, caches: List[Params]) -> List[tuple]:
    """One cache per layer back to the reference's layout, as float32 numpy."""
    out = []
    li = 0
    for kinds, reps in cfg.layer_plan():
        n = len(kinds)
        out.append(tuple(_stack([caches[li + r * n + i] for r in range(reps)])
                         for i in range(n)))
        li += reps * n
    return out
