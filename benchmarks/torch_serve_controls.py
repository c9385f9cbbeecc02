"""The new serving paths' kernel-vs-plain readings on the card, sound and
under two broken controls: where chip_smoke.py's TOL_SERVE_MOE,
TOL_SERVE_VLM, TOL_SERVE_EMBED and TOL_SERVE_INT8 come from.

    python -m benchmarks.torch_serve_controls [--only sound,moe,k6]

Run from the repository root on a machine with a CUDA card. One process
builds the kernels and calls chip_smoke.py's own functions with those four
limits set to print only:

  sound  ``attention_kinds_parity`` and ``serve_kinds_phase`` ([serve-moe],
         [serve-xattn], [serve-embed], [serve-int8], [serve-archs])
  moe    ``models.moe.route`` wrapped so that on the kernel path
         (``cfg.use_flash``) every gate is 1/K: [serve-moe]
  k6     the ``ops`` that ``models.attention`` calls wrapped so that on the
         kernel path a self-attention decode reads ``lengths - 1`` of its
         ``lengths`` positions, so K6 misses each step's own token:
         [serve-xattn], [serve-embed], [serve-int8] and [serve-moe]

A control wraps a function in this process for its run and restores it
after; the sources stay as they are. Each ``serve_path`` prints its "kernel
vs plain path" line (max |diff| / max |logit| and ||diff|| / ||logits|| over
the prefill and 4 teacher-forced decode steps). A control fails by design
where the served tokens no longer follow. Imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIMITS = ("TOL_SERVE_MOE", "TOL_SERVE_VLM", "TOL_SERVE_EMBED", "TOL_SERVE_INT8")


@contextlib.contextmanager
def moe_one_over_k():
    """The MoE combine weighting each chosen expert 1/K on the kernel path."""
    import torch

    from repro_torch.models import moe

    route = moe.route

    def broken(p, xt, cfg, mode):
        r = route(p, xt, cfg, mode)
        if not cfg.use_flash:
            return r
        return r._replace(gates=torch.full_like(r.gates, 1.0 / cfg.top_k))

    moe.route = broken
    try:
        yield
    finally:
        moe.route = route


class _MissesOwnToken:
    """``ops`` with a ``decode_attention`` that, on the kernel path, reads
    one position less of a self-attention cache. A served self-attention
    read stops short of the cache's capacity; an image cache is read whole
    (lengths == capacity) and is left as it is. No host sync, so a decode
    step through it still captures as a graph."""

    def __init__(self, ops):
        self._ops = ops

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def decode_attention(self, q, k_cache, v_cache, lengths, *, use_kernel=True, **kw):
        import torch

        if use_kernel:
            lengths = torch.where(lengths < k_cache.shape[2], lengths - 1, lengths)
        return self._ops.decode_attention(q, k_cache, v_cache, lengths,
                                          use_kernel=use_kernel, **kw)


@contextlib.contextmanager
def k6_misses_own_token():
    """K6 missing each decode step's own token on the kernel path."""
    from repro_torch.models import attention

    ops = attention.ops
    attention.ops = _MissesOwnToken(ops)
    try:
        yield
    finally:
        attention.ops = ops


CONTROLS = {"moe": moe_one_over_k, "k6": k6_misses_own_token}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="sound,moe,k6")
    args = ap.parse_args(argv)
    runs = args.only.split(",")
    for which in runs:
        if which != "sound" and which not in CONTROLS:
            raise SystemExit(f"torch_serve_controls: unknown run {which!r}")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_controls: no CUDA device is available")
    t0 = time.perf_counter()
    for name in LIMITS:
        setattr(cs, name, {"max": None, "rms": None})
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip()
    _build.build_all()
    print(f"[controls] build {time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    dev = torch.device("cuda")

    def path(tag, cfg, B, P, G, tol, **kw):
        want = dict(flash_attention=cfg.n_layers, decode_attention=cfg.n_layers * (G - 1))
        if cfg.n_image_tokens:  # the cross-attention layers' K5 in its f32 form
            cross = sum(kind == "xattn" for kind in cfg.layer_plan_flat())
            want.update(flash_attention=cfg.n_layers - cross, flash_attention_f32=cross)
        cs.serve_path(dev, smi, tag, cfg, B, P, G, want, tol, **kw)

    for which in runs:
        t1 = time.perf_counter()
        if which == "sound":
            gen = torch.Generator(device=dev).manual_seed(0)
            print(f"[controls] sound: K5/K6 at the new shapes, max abs error "
                  f"{cs.attention_kinds_parity(dev, gen)}", flush=True)
            cs.serve_kinds_phase(dev, smi)
            print(f"[controls] sound: {time.perf_counter() - t1:.3f} s | {smi}", flush=True)
            continue
        try:  # a control may fail a check by design: the next run goes on
            with CONTROLS[which]():
                if which == "k6":
                    path("[k6-control xattn]", dataclasses.replace(
                        get_config(cs.VLM_ARCH), n_layers=cs.VLM_LAYERS), cs.VLM_B,
                        cs.VLM_PROMPT, cs.VLM_GEN, cs.TOL_SERVE_VLM, image_gate=cs.IMAGE_GATE)
                    path("[k6-control embed]", get_config(cs.EMB_ARCH), cs.EMB_B,
                         cs.EMB_PROMPT, cs.EMB_GEN, cs.TOL_SERVE_EMBED)
                    path("[k6-control int8]", dataclasses.replace(
                        get_config(cs.SERVE_ARCH), kv_quant=True), cs.SERVE_B,
                        cs.SERVE_PROMPT, cs.SERVE_GEN, cs.TOL_SERVE_INT8)
                path(f"[{which}-control moe]", get_config(cs.MOE_ARCH), cs.MOE_B,
                     cs.MOE_PROMPT, cs.MOE_GEN, cs.TOL_SERVE_MOE)
        except SystemExit as e:
            print(f"[controls] {which}: stopped by {e}", flush=True)
        torch.cuda.empty_cache()
        print(f"[controls] {which}: {time.perf_counter() - t1:.3f} s | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
