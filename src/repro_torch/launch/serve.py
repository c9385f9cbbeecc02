"""Batched serving loop: prefill a prompt batch, decode tokens step by step.

Counterpart of ``repro.launch.serve`` on one device, for every registered
arch. The serving path runs the KV caches (int8 with per-position scales
under ``kv_quant``), the flash attention kernel (K5) in prefill and the
decode attention kernel (K6) in every decode step; the ``ssm`` and
``hybrid`` kinds (mamba2-130m, hymba-1.5b) also run the SSD intra-chunk
kernel (K7) in prefill and carry O(1) SSM states through decode; the
``moe`` kind routes each token to its top-k experts. The OverheadProfiler
reports per-token dispatch overhead — the serving analogue of the paper's
per-task overhead measurement, where a "task" is one decode step of one
sequence. Each decode step's wall ends with a ``torch.cuda.synchronize()``.
Weights are random, drawn from ``seed``; prompts from ``seed + 1``;
sampling (when not greedy) from ``seed + 2``. The reference's ``mesh``
option is not ported yet (ROADMAP Queue 1).

Inputs as the reference's ``serve`` makes them: with ``embed_inputs``
(musicgen) the prompts are 0.02·N(0, 1) embeddings drawn from ``seed +
1``, and each decode step draws a fresh (B, 1, d_model) embedding from
``seed + 3``. With ``n_image_tokens`` (llama-3.2-vision) the prefill gets
zero image embeddings (B, n_image_tokens, d_model); with the
cross-attention gates at their zero init, the cross-attention layers then
add exactly 0, as in the reference.

On the card each decode step after the first is one CUDA graph replay, the
counterpart of the reference's jitted decode step: the step reads and
writes static buffers (the token ``tok``, ``lengths``, incremented in
place, the health flag, and the capacity-sized caches, updated in place).
Step 0 runs eagerly on the capture stream: it is a real step and the
warm-up; the step is captured after it (a capture runs nothing) and
replayed once for each later step. Sampled decoding and the per-step
embedding draw register their generators with the graph, so graph and
eager decode draw the same numbers. ``graph=False`` runs every step
eagerly (the ablation: what the graph removes); on the CPU every step is
eager.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --batch 8 --prompt-len 1024 --gen 64          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
      --reduced --device cpu       # also mixtral-8x7b, llama-3.2-vision-90b,
                                   # musicgen-medium, and every other arch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.instrumentation import OverheadProfiler
from repro_torch.core.runtimes._capture import Graphed
from repro_torch.models.model import Model
from repro_torch.resilience import DEFAULT_DEADLINE_FACTOR, DeadlineDetector


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray  # (B, gen)
    prefill_s: float
    decode_s: float
    tokens_per_s: float
    report: Optional[Any]
    #: decode steps whose wall blew the self-calibrated deadline
    #: (resilience.DeadlineDetector): [{step, wall_us, deadline_us,
    #: overshoot_us}] — a stalled step is REPORTED, never silently absorbed
    flagged_steps: List[dict] = dataclasses.field(default_factory=list)
    #: decode steps whose logits carried NaN/Inf (poisoned output)
    poisoned_steps: List[int] = dataclasses.field(default_factory=list)
    #: the decode step's graph: capture and instantiation seconds, nodes
    #: (None where every step ran eagerly)
    capture_s: Optional[float] = None
    graph_nodes: Optional[int] = None
    #: with ``keep_logits``: each decode step's logits, (gen - 1, B, V) f32
    logits: Optional[torch.Tensor] = None

    @property
    def healthy(self) -> bool:
        return not self.flagged_steps and not self.poisoned_steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    """The (batch, prompt_len) random prompts `serve` runs for ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), dtype=torch.int64,
                         generator=gen, device=device)


def make_inputs(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """The prefill's keyword inputs `serve` runs for ``seed``: ``tokens``
    (make_prompts) or, with ``embed_inputs``, ``embeds`` of 0.02·N(0, 1)
    from ``seed + 1``; with image tokens, zero ``image_embeds``."""
    if cfg.embed_inputs:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        out = {"embeds": 0.02 * torch.randn((batch, prompt_len, cfg.d_model),
                                            generator=gen, device=device)}
    else:
        out = {"tokens": make_prompts(cfg, batch, prompt_len, seed, device)}
    if cfg.n_image_tokens:
        out["image_embeds"] = torch.zeros((batch, cfg.n_image_tokens, cfg.d_model),
                                          device=device)
    return out


def step_embeds(cfg: ModelConfig, batch: int, gen: torch.Generator,
                device) -> torch.Tensor:
    """One decode step's fresh input embeddings (B, 1, d_model), 0.02·N(0,
    1) from ``gen`` (seeded ``seed + 3`` in `serve`)."""
    return 0.02 * torch.randn((batch, 1, cfg.d_model), generator=gen, device=device)


def serve(
    cfg: ModelConfig,
    *,
    batch: int,
    prompt_len: int,
    gen: int,
    seed: int = 0,
    greedy: bool = True,
    temperature: float = 1.0,
    verbose: bool = True,
    deadline_factor: Optional[float] = None,
    device: str = "cuda",
    graph: bool = True,
    keep_logits: bool = False,
) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen - 1`` more tokens per sequence (the first comes from the prefill's
    logits). Runs on the card unless ``device="cpu"``; raises when asked
    for the card and none is present. On the card each decode step after
    the first replays one CUDA graph unless ``graph=False``; a capture that
    fails raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("serve(device='cuda') needs a CUDA card; pass "
                               "device='cpu' to run the plain path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    model = Model(cfg, device=dev, seed=seed)
    capacity = prompt_len + gen
    inputs = make_inputs(cfg, batch, prompt_len, seed, dev)
    sampler = torch.Generator(device=dev).manual_seed(seed + 2)
    embedder = torch.Generator(device=dev).manual_seed(seed + 3)

    t0 = time.perf_counter()
    logits, caches = model.prefill(**inputs)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    # prefill caches hold exactly prompt_len entries; grow to capacity
    caches = _grow_caches(model, caches, batch, capacity)

    profiler = OverheadProfiler(
        devices=1,
        tasks_per_step=batch,  # one "task" = one sequence's token step
        tokens_per_step=batch,  # each decode step emits one token per seq
        device=str(dev),
    )
    # deadline detector around each decode step: no cost model prices a
    # decode step, so it self-calibrates from the run's own clean walls.
    # Step 0 carries the first launches (and, on the card, the kernels'
    # first load), the first replay the graph's first launch: their walls
    # are excluded from the calibration median.
    detector = DeadlineDetector(factor=deadline_factor or DEFAULT_DEADLINE_FACTOR)
    detector.note_recompile_boundary()
    flagged: List[dict] = []
    poisoned: List[int] = []
    # the decode step's static buffers
    lengths = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
    tok = logits.argmax(dim=-1)[:, None]
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    out: List[torch.Tensor] = [tok.clone()]
    kept: List[torch.Tensor] = []

    def step() -> torch.Tensor:
        """One decode step on the static buffers; returns its logits."""
        if cfg.embed_inputs:
            lg, _ = model.decode_step(lengths=lengths, caches=caches,
                                      embeds=step_embeds(cfg, batch, embedder, dev))
        else:
            lg, _ = model.decode_step(tok, lengths, caches)  # caches in place
        # argmax of poisoned logits still yields a legal token id, so
        # health is read off the logits
        torch.logical_not(torch.isfinite(lg).all(), out=bad)
        if greedy:
            tok.copy_(lg.argmax(dim=-1, keepdim=True))
        else:
            tok.copy_(torch.multinomial(torch.softmax(lg / temperature, dim=-1), 1,
                                        generator=sampler))
        lengths.add_(1)
        return lg

    use_graph = graph and dev.type == "cuda"
    stream = torch.cuda.Stream(dev) if use_graph else None
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(dev))
    graphed: Optional[Graphed] = None
    gens = (() if greedy else (sampler,)) + ((embedder,) if cfg.embed_inputs else ())
    t0 = time.perf_counter()
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        for i in range(gen - 1):
            if use_graph and i == 1:
                graphed = Graphed(step, stream, gens)
                detector.note_recompile_boundary()
            t1 = time.perf_counter()
            lg = step() if graphed is None else graphed.replay()
            _sync(dev)
            wall = time.perf_counter() - t1
            profiler.record(wall)
            det = detector.observe(wall * 1e6)
            if det is not None:
                flagged.append({"step": i, "wall_us": det.wall_us,
                                "deadline_us": det.deadline_us,
                                "overshoot_us": det.overshoot_us})
                profiler.flagged.append(i)
            if bool(bad):
                poisoned.append(i)
                profiler.poisoned.append(i)
            out.append(tok.clone())
            if keep_logits:
                kept.append(lg.clone())
    if stream is not None:
        torch.cuda.current_stream(dev).wait_stream(stream)
    decode_s = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1).cpu().numpy()

    report = profiler.report() if profiler.records else None
    tps = batch * (gen - 1) / decode_s if decode_s > 0 else 0.0
    if verbose:
        # the report's tokens_per_s is steady-state (warmup step dropped);
        # this one includes it, matching the returned decode_s
        print(f"prefill: {prefill_s*1e3:.1f} ms for {batch}x{prompt_len} "
              f"({batch*prompt_len/max(prefill_s,1e-9):.0f} tok/s)")
        print(f"decode : {decode_s*1e3:.1f} ms for {batch}x{gen-1} "
              f"({tps:.0f} tok/s)")
        if graphed is not None:
            print(f"decode step graph: captured after step 0 in "
                  f"{graphed.capture_s*1e3:.1f} ms (inside the decode time), "
                  f"{graphed.nodes} nodes, replayed {gen - 2} times")
        if report:
            print("\n-- per-token overhead (paper methodology, §3) --")
            for line in report.lines():
                print("  " + line)
        for f in flagged:
            print(f"WARNING: decode step {f['step']} blew its deadline: "
                  f"{f['wall_us']:.0f}us > {f['deadline_us']:.0f}us")
        for i in poisoned:
            print(f"WARNING: decode step {i} produced non-finite logits")
    if graphed is not None:
        graphed.close()
    return ServeResult(tokens=tokens, prefill_s=prefill_s, decode_s=decode_s,
                       tokens_per_s=tps, report=report, flagged_steps=flagged,
                       poisoned_steps=poisoned,
                       capture_s=None if graphed is None else graphed.capture_s,
                       graph_nodes=None if graphed is None else graphed.nodes,
                       logits=torch.stack(kept) if kept else None)


def _grow_caches(model: Model, caches, batch: int, capacity: int):
    """Copy prefill caches (length = prompt_len) into capacity-sized buffers.

    Attention K and V (int8 K/V and their scales too) grow along the
    sequence dim (zeros past the prompt); the SSM conv window and state are
    O(1) and the cross-attention image caches fixed-size: they pass
    through.
    """
    full = model.init_caches(batch, capacity)
    for dst, src in zip(full, caches):
        for part, tensors in src.items():
            for name, t in tensors.items():
                d = dst[part][name]
                if d.shape == t.shape:
                    dst[part][name] = t.to(d.dtype)
                else:  # attention K/V (B, Hkv, S, hd), scales (B, Hkv, S, 1)
                    d[:, :, :t.shape[2]] = t
    return full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                seed=args.seed, greedy=not args.sample, device=args.device)
    print(f"\ngenerated tokens (first 2 rows): {res.tokens[:2].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
