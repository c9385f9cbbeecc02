"""Launch-depth resolution for ``pallas_step``: the explicit-depth shell.

Counterpart of ``repro.kernels.schedule``, its ``steps_per_launch`` option
parser only. Every plan of ``pallas_step`` resolves its depth through one
shell, `_resolve_depth`: None or 1 is the per-step schedule, an explicit
int is validated and clamped to the combine-step count, and ``"auto"``
goes to the plan's chooser. The choosers, the cost model they price and
the probes that measure it are not ported yet (ROADMAP.md, Queue 1 item
7), so here every chooser raises ``NotImplementedError``.

``DEFAULT_GATHER_WIDTH_CAP`` is the reference's: the widest state the
all-gather plan takes by default. Its value comes from a TPU core's VMEM
(the gathered working set and, for all_to_all, the (W, D, W) one-hot
expansion must stay resident there); it is kept for parity with the
reference's plan dispatch, and the ``gather_width_cap`` runtime option
overrides it. What the cap should be on the card waits for the cost model
of item 7.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

AUTO_NOT_PORTED = (
    "steps_per_launch='auto' needs the scheduler and cost model "
    "(kernels/schedule.py, kernels/probes.py), which are not ported yet: "
    "ROADMAP.md, Queue 1 item 7; pass an int depth")

#: Widths at or below this run the all-gather plan by default (the
#: ``gather_width_cap`` runtime option overrides it per run). A TPU-derived
#: value, kept for parity; see the module docstring.
DEFAULT_GATHER_WIDTH_CAP = 512


def is_auto(value: Union[int, str, None]) -> bool:
    """Whether a ``steps_per_launch`` value delegates the depth choice to
    the plan's chooser (the reference's spellings: "auto", 0, "0")."""
    return value in ("auto", 0, "0")


def auto_not_ported() -> int:
    """The chooser of every plan until the cost model is ported."""
    raise NotImplementedError(AUTO_NOT_PORTED)


def _resolve_depth(value, chooser: Callable[[], int],
                   total_steps: Optional[int]) -> int:
    """THE ``steps_per_launch`` option shell, shared by every plan: None/1
    -> per-step, "auto" -> the plan's chooser, explicit ints validated and
    clamped to the combine-step count (deeper than the run is all masked
    tail)."""
    if value in (None, 1):
        return 1
    if is_auto(value):
        return chooser()
    s = int(value)
    if s < 1:
        raise ValueError(f"steps_per_launch must be >= 1 or 'auto', got {value!r}")
    if total_steps and total_steps > 1:
        s = min(s, total_steps - 1)
    return s


def resolve_steps_per_launch_gathered(value: Union[int, str, None], *,
                                      total_steps: Optional[int] = None) -> int:
    """``steps_per_launch`` -> concrete S for the all-gather plan: explicit
    depths through the shared shell; "auto" (the reference's
    ``choose_steps_per_launch_gathered``) raises ``NotImplementedError``."""
    return _resolve_depth(value, auto_not_ported, total_steps)
