"""Which rounding of K7's output do mamba2-130m's served logits follow?

    PYTHONPATH=src python -m repro_torch.launch.ssd_rounding

chip_smoke.py's [serve-ssm] holds the model's logits on its kernel path
to those on its plain path (prefill and 4 teacher-forced decode steps,
||difference|| / ||logits||). This replays that comparison at the same
size (batch 8, prompt 1024, random weights from seed 0) with K7's y
computed with chosen steps in f32, as the plain version computes them,
and the rest in f64, then rounded to f32 (the state as the plain version
computes it):

  G  C B^T                  E  exp(a_i - a_j)
  S  (C B^T) * L            X  x * dt
  M  the product S (x dt)

"GESXM" is the plain version itself (0 by construction); "" is the exact
y. A kernel whose arithmetic differs from the plain version's in a step
moves the logits about as far as that step in f64 does. Last, the K7
kernel itself ("kernel"). Prints one line per variant. Needs a CUDA
card.
"""
from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.kernel_times import card
from repro_torch.launch.serve import _grow_caches, make_prompts
from repro_torch.models.model import Model

ARCH, BATCH, PROMPT, STEPS = "mamba2-130m", 8, 1024, 4
VARIANTS = ("GESXM", "", "G", "ESXM", "GE", "GESX", "SXM", "M", "kernel")


def ssd_chunk_mixed(x, b, c, dta, dt, f32: str):
    """K7's (y, state): y with the steps named in ``f32`` in f32 and the
    rest in f64, the state in f32 as the plain version computes it, and
    a = cumsum(dtA) in f32 and token order as in both versions."""
    T = x.shape[2]
    ratio = x.shape[1] // b.shape[1]
    a = torch.empty_like(dta)
    run = torch.zeros_like(dta[..., 0])
    for t in range(T):
        run = run + dta[..., t]
        a[..., t] = run

    def at(step, v):
        return v.to(torch.float32 if step in f32 else torch.float64)

    bh, ch = (v.repeat_interleave(ratio, dim=1).float() for v in (b, c))
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    logl = torch.where(causal, a[..., :, None] - a[..., None, :], float("-inf"))
    cbt = torch.einsum("bhin,bhjn->bhij", at("G", ch), at("G", bh))
    scores = at("S", cbt) * at("S", torch.exp(at("E", logl)))
    xdt = at("X", x.float()) * at("X", dt.float())[..., None]
    y = torch.einsum("bhij,bhjp->bhip", at("M", scores), at("M", xdt))
    w = torch.exp(a[..., -1:] - a) * dt
    return y.to(x.dtype), torch.einsum("bhtn,bhtp->bhnp", bh * w[..., None], x.float())


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_rounding: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    cap = PROMPT + STEPS
    kernel_model = Model(cfg, device=dev, seed=0)
    plain_model = Model(dataclasses.replace(cfg, use_flash=False), device=dev, seed=0)
    prompts = make_prompts(cfg, BATCH, PROMPT, 0, dev)
    lengths = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=dev)
    # the plain path's logits, and its greedy tokens to teacher-force with
    lg, caches = plain_model.prefill(prompts)
    caches = _grow_caches(plain_model, caches, BATCH, cap)
    want, tokens = [lg], [lg.argmax(-1).reshape(BATCH, 1)]
    for i in range(STEPS):
        lg, caches = plain_model.decode_step(tokens[-1], lengths + i, caches)
        want.append(lg)
        tokens.append(lg.argmax(-1).reshape(BATCH, 1))
    del caches
    kernel_chunk, smi = ops.ssd_chunk, card()
    try:
        for variant in VARIANTS:
            ops.ssd_chunk = kernel_chunk if variant == "kernel" else (
                lambda x, b, c, dta, dt, use_kernel=True, f32=variant:
                ssd_chunk_mixed(x, b, c, dta, dt, f32) if use_kernel
                else ref.ssd_chunk_plain(x, b, c, dta, dt))
            lg, caches = kernel_model.prefill(prompts)
            caches = _grow_caches(kernel_model, caches, BATCH, cap)
            got = [lg]
            for i in range(STEPS):
                lg, caches = kernel_model.decode_step(tokens[i], lengths + i, caches)
                got.append(lg)
            rms = [(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()
                   for g, w in zip(got, want)]
            print(json.dumps({"f32_steps": variant, "rms": rms, "card": smi}), flush=True)
            del caches
    finally:
        ops.ssd_chunk = kernel_chunk
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
