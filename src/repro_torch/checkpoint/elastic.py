"""Failure handling around the checkpointer: the whole-run restart loop.

The port of ``repro.checkpoint.elastic``. ``FailureInjector`` raises a
``SimulatedFailure`` at a chosen step; ``run_with_restarts`` restarts the
loop from the latest checkpoint that verifies. Tests hold the final state
bit for bit to an uninterrupted run: the checkpoint/restart path loses
nothing. This is the recovery of a backend with no launch-granular schedule
(``Runtime.build_ensemble_launches``); the reference's ``reshard_restore``,
onto another device mesh, comes with the sharding policy (ROADMAP Queue 1
item 12).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.resilience.faults import InjectedFault


class SimulatedFailure(InjectedFault):
    """Whole-process node death (the coarse fault class this module
    recovers from; intra-run fault classes live in repro_torch.resilience)."""


class FailureInjector:
    """Raises at the START of the given step indices (post-checkpoint)."""

    def __init__(self, fail_at: Tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


def run_with_restarts(
    *,
    total_steps: int,
    ckpt: Checkpointer,
    ckpt_every: int,
    init_state: Callable[[], Any],
    step_fn: Callable[[Any, int], Any],
    injector: Optional[FailureInjector] = None,
    max_restarts: int = 8,
    extra_state: Optional[Dict] = None,
) -> Tuple[Any, int]:
    """Generic fault-tolerant loop: state -> step_fn -> state, checkpointing
    every `ckpt_every` and restarting from the latest checkpoint on failure.

    Returns (final_state, restarts_used). `state` is any tree of tensors;
    step 0's state comes from init_state() or the latest checkpoint if one
    exists (init_state() is also the restore's structure donor).

    A checkpoint that fails its content checksum (or is otherwise
    unreadable) is not fatal: restore walks BACKWARD through the retained
    steps until one verifies, and restarts from there; only if every
    retained checkpoint is corrupt does the loop fall back to step 0.
    """
    restarts = 0
    while True:
        state, start = None, 0
        for candidate in reversed(ckpt.all_steps()):
            try:
                state, _ = ckpt.restore(init_state(), step=candidate)
                start = candidate
                break
            except ValueError:
                continue  # corrupt/truncated: try the previous good one
        if state is None:
            state, start = init_state(), 0
        try:
            for step in range(start, total_steps):
                if injector is not None:
                    injector.maybe_fail(step)
                state = step_fn(state, step)
                nxt = step + 1
                if nxt % ckpt_every == 0 or nxt == total_steps:
                    ckpt.save(nxt, state, extra_state)
            ckpt.wait() if hasattr(ckpt, "wait") else None
            return state, restarts
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
