"""Deterministic synthetic token pipeline.

Counterpart of ``repro.data.pipeline`` on one device. A batch is a pure
function of (seed, step): its generator is seeded from both (numpy's
``SeedSequence`` mixes them into one 64-bit seed), so there is no storage,
a restart reproduces the stream, and the iterator state is one integer,
which makes the pipeline checkpointable. The batch is drawn on the CPU and
moved to ``device``, so it is the same on every device. JAX's threefry
stream cannot be reproduced here: tests that compare numbers with the
reference feed its batches in.

The batch is the reference's: ``tokens`` and ``labels`` (B, S) int64 (the
reference's are int32), the labels the tokens shifted by one, over a
skewed distribution (a uniform squared, times the vocabulary, skews to low
ids); with ``cfg.embed_inputs`` ``embeds`` (B, S, d_model) and with image
tokens ``image_embeds`` (B, n_image_tokens, d_model), each 0.02·N(0, 1) in
``cfg.dtype``.

``prefetch()`` is the reference's one-deep double buffer: batch t + 1 is
made while step t runs. The reference's ``shardings`` (a device mesh) is
not ported yet (ROADMAP Queue 1 item 12, slice 23).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class SyntheticTokenPipeline:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        seed: int = 0,
        batch_override: Optional[int] = None,
        seq_override: Optional[int] = None,
        device: Union[str, torch.device] = "cpu",
    ):
        self.cfg = cfg
        self.batch = batch_override or shape.global_batch
        self.seq = seq_override or shape.seq_len
        self.seed = seed
        self.device = torch.device(device)
        self.state = PipelineState()

    # ------------------------------------------------------------------

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` (a pure function of seed and step)."""
        cfg = self.cfg
        mixed = np.random.SeedSequence([self.seed, step]).generate_state(1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(mixed))
        u = torch.rand((self.batch, self.seq + 1), generator=gen)
        toks = (u * u * cfg.vocab).long()  # squared uniform: skewed to low ids
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        dt = dtype_of(cfg.dtype)
        if cfg.embed_inputs:
            batch["embeds"] = 0.02 * torch.randn(
                (self.batch, self.seq, cfg.d_model), generator=gen).to(dt)
        if cfg.n_image_tokens:
            batch["image_embeds"] = 0.02 * torch.randn(
                (self.batch, cfg.n_image_tokens, cfg.d_model), generator=gen).to(dt)
        return {k: v.to(self.device) for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            b = self.batch_at(self.state.step)
            self.state.step += 1
            yield b

    def prefetch(self) -> Iterator[Dict[str, torch.Tensor]]:
        """One-deep prefetch (double buffering)."""
        it = iter(self)
        nxt = next(it)
        while True:
            cur, nxt = nxt, next(it)
            yield cur

    # -------------------------------------------------------- checkpoint

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.state.step, "seed": self.seed}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        if d["seed"] != self.seed:
            raise ValueError(f"pipeline seed mismatch on restore: checkpoint "
                             f"{d['seed']}, pipeline {self.seed}")
        self.state.step = int(d["step"])
