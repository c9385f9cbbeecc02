"""AdamW + cosine schedule + global-norm clipping.

Counterpart of ``repro.optim.optimizer``, written by hand as the reference
is: ``torch.optim.AdamW`` decays every tensor and clips nothing. The
arithmetic is the reference's, step for step, in f32 on the parameters'
device (no host sync): the global gradient norm, ``scale = min(1, clip /
(gnorm + 1e-9))``, ``step + 1`` fed to the schedule, the bias corrections,
moments in f32 whatever the parameter's dtype, decoupled weight decay on
tensors of two or more dims added to ``delta`` before the ``lr`` multiply,
and the update computed in f32 and cast back to the parameter's dtype.
The reference reads the dims off its own parameter tree, which stacks
each layer group's tensors on a leading axis: a layer's norm weights and
SSM vectors have two dims there and are decayed, its scalars (the gates
and fuse weights) are not. ``update(..., ndims=)`` takes the dims to read,
and the train step passes ``Model.stacked_ndims()``, so the port decays
what the reference decays.

Parameters are a dict of name -> tensor (``dict(model.named_parameters())``)
and are updated in place under ``torch.no_grad()``: no parameter is
reallocated, so a ``Model``'s modules keep their tensors. The moments are
updated in place too. The reference's ZeRO-1 ``state_shardings`` needs a
mesh and is not ported yet (ROADMAP Queue 1 item 12, slice 23).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Params
    v: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """lr(step): linear warm-up to ``cfg.lr`` over ``warmup_steps``, then a
    cosine down to ``min_lr_ratio * lr`` at ``total_steps``; an f32 tensor
    on the step's device."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)

    return lr


class AdamW:
    def __init__(self, cfg: AdamWConfig = AdamWConfig()):
        self.cfg = cfg
        self.schedule = cosine_schedule(cfg)

    def init(self, params: Params) -> AdamWState:
        """Zero f32 moments beside each parameter (on its device; a meta
        parameter gives meta moments)."""
        dev = next(iter(params.values())).device
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for n, p in params.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), m=zeros,
                          v={n: torch.zeros_like(z) for n, z in zeros.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params,
               ndims: Optional[Dict[str, int]] = None
               ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
        """One step: ``params`` and the moments updated in place; returns
        (params, the state at step + 1, {"grad_norm", "lr"} as 0-d
        tensors). ``grads`` has a tensor for every parameter name.
        ``ndims`` gives the dims the decay rule reads for a parameter where
        they are not its own (``Model.stacked_ndims``: the reference stacks
        each layer group's tensors, so it decays a layer's vectors too)."""
        cfg = self.cfg
        b1, b2 = cfg.betas
        gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[n].float())) for n in params))
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
        for n, p in params.items():
            g = grads[n].float() * scale
            m = b1 * state.m[n] + (1 - b1) * g
            v = b2 * state.v[n] + (1 - b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if (p.ndim if ndims is None else ndims[n]) >= 2:  # decoupled weight decay
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)  # cast back to p's dtype
            state.m[n].copy_(m)
            state.v[n].copy_(v)
        return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
