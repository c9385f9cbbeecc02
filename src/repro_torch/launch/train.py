"""End-to-end trainer on one device: config -> train loop with
checkpoint/restart, overhead instrumentation and an optional failure drill.

Counterpart of ``repro.launch.train``. The same code runs reduced configs
on the CPU (tests) and full configs on the card:

  * data: the deterministic synthetic pipeline (``data.pipeline``), one
    batch a step, a pure function of (seed, step)
  * step: ``launch.steps.make_train_step`` (``Model.loss``, its backward
    and AdamW in place on the model's parameters), run eagerly: the
    reference jits it; a CUDA graph of the step would change its speed,
    not its results, and is left to the queue that opens with the first
    benchmark PR
  * fault tolerance: atomic async checkpoints every ``ckpt_every`` steps
    (parameters, optimizer state, the pipeline's state in ``extra``), and
    on an (injected) ``SimulatedFailure`` a restart from the latest one
  * instrumentation: ``OverheadProfiler`` records each step's wall (ended
    by reading the step's metrics on the host, which waits for the device)

Training runs the plain attention and SSD (never K5, K6 or K7, which are
forward-only), as the reference's train mode does. f32 matrix products
run in f32, not TF32. The reference's ``mesh`` (a sharded train step) is
not ported yet (ROADMAP Queue 1 item 12, slice 23): ``mesh=`` and
``--mesh`` raise ``NotImplementedError``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --reduced --steps 4 --device cpu      # batch 8, seq 128 when reduced
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --steps 6 --batch 4 --seq 2048        # on the card, full width
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.elastic import FailureInjector, SimulatedFailure
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCHS, get_config, get_shape
from repro_torch.core.instrumentation import OverheadProfiler
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model import NOT_PORTED, Model
from repro_torch.optim.optimizer import AdamW, AdamWConfig

#: batch and sequence of a ``--reduced`` run when not given
REDUCED_BATCH, REDUCED_SEQ = 8, 128


@dataclasses.dataclass
class TrainResult:
    final_loss: float
    losses: list
    steps_run: int
    restarts: int
    report: Optional[Any]  # OverheadReport
    grad_norms: list = dataclasses.field(default_factory=list)


def train(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    steps: int,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
    mesh=None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    fail_at: tuple = (),
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 10,
    profile: bool = True,
    verbose: bool = True,
    device: str = "cuda",
) -> TrainResult:
    """Train ``steps`` steps from the weights of ``seed``; returns every
    step's loss (steps re-run after a restart appear again) and the
    restarts. Runs on the card unless ``device="cpu"``."""
    if mesh is not None:
        raise NotImplementedError(f"train(mesh=...) is {NOT_PORTED}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("train(device='cuda') needs a CUDA card; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    model = Model(cfg, device=dev, seed=seed)
    opt = AdamW(AdamWConfig(lr=lr, total_steps=max(steps, 2),
                            warmup_steps=max(steps // 10, 1)))
    B = batch or shape.global_batch
    S = seq or shape.seq_len
    pipeline = SyntheticTokenPipeline(cfg, shape, seed=seed, batch_override=B,
                                      seq_override=S, device=dev)
    step_fn = steps_lib.make_train_step(model, opt)
    params = dict(model.named_parameters())

    def fresh_state():
        model.init(seed)
        return {"params": params, "opt": opt.init(params)}

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    injector = FailureInjector(fail_at) if fail_at else None
    profiler = OverheadProfiler(
        devices=1, tasks_per_step=1,
        flops_per_step=steps_lib.step_flops_estimate(cfg, shape)
        * (B * S) / (shape.global_batch * shape.seq_len),
        tokens_per_step=B * S, device=str(dev),
    ) if profile else None

    restarts = 0
    losses: list = []
    gnorms: list = []
    while True:
        start = 0
        state = fresh_state()
        if ckpt is not None and ckpt.latest_step() is not None:
            restored, extra = ckpt.restore(state)
            with torch.no_grad():  # into the model's own tensors
                for n, p in params.items():
                    p.copy_(restored["params"][n])
            state = {"params": params, "opt": restored["opt"]}
            start = int(extra.get("step", ckpt.latest_step()))
            if "pipeline" in extra:
                pipeline.load_state_dict(extra["pipeline"])
        pipeline.state.step = start
        try:
            for step in range(start, steps):
                if injector is not None:
                    injector.maybe_fail(step)
                data = pipeline.batch_at(step)
                t0 = time.perf_counter()
                opt_state, metrics = step_fn(state["opt"], data)
                metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
                wall = time.perf_counter() - t0
                state = {"params": params, "opt": opt_state}
                if profiler is not None:
                    profiler.record(wall)
                losses.append(metrics["loss"])
                gnorms.append(metrics["grad_norm"])
                if verbose and (step % log_every == 0 or step == steps - 1):
                    print(f"step {step:5d}  loss {metrics['loss']:.4f}  "
                          f"gnorm {metrics['grad_norm']:.3f}  "
                          f"lr {metrics['lr']:.2e}  "
                          f"wall {wall*1e3:.1f} ms", flush=True)
                nxt = pipeline.state.step = step + 1
                if ckpt is not None and (nxt % ckpt_every == 0 or nxt == steps):
                    ckpt.async_save(nxt, state, {
                        "step": nxt, "pipeline": pipeline.state_dict()})
            if ckpt is not None:
                ckpt.wait()
            break
        except SimulatedFailure as e:
            restarts += 1
            if verbose:
                print(f"[failure] {e} -> restarting from latest checkpoint "
                      f"(restart #{restarts})", flush=True)
            if ckpt is not None:
                ckpt.wait()
            if restarts > 16:
                raise

    report = None
    if profiler is not None and profiler.records:
        report = profiler.report()
        if verbose:
            print("\n-- overhead report (paper methodology, §3) --")
            for line in report.lines():
                print("  " + line)
    return TrainResult(
        final_loss=losses[-1] if losses else float("nan"),
        losses=losses,
        steps_run=len(losses),
        restarts=restarts,
        report=report,
        grad_norms=gnorms,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true",
                    help="use the tiny same-family smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject SimulatedFailure at these steps (drill)")
    ap.add_argument("--mesh", default=None,
                    help="a device mesh, e.g. '4:data' (not ported yet)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(f"--mesh is {NOT_PORTED}")

    cfg = get_config(args.arch)
    batch, seq = args.batch, args.seq
    if args.reduced:
        cfg = cfg.reduced()
        batch, seq = batch or REDUCED_BATCH, seq or REDUCED_SEQ
    res = train(
        cfg, get_shape(args.shape), steps=args.steps, batch=batch, seq=seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        fail_at=tuple(args.fail_at), lr=args.lr, seed=args.seed, device=args.device,
    )
    print(f"\nfinal loss {res.final_loss:.4f} after {res.steps_run} steps "
          f"({res.restarts} restarts)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
