"""Fault detection for the port: ``DeadlineDetector`` (a copy of
``repro.resilience.detect``). Fault injection and the resilient engine are
not ported yet (ROADMAP Queue 1 item 10)."""
from repro_torch.resilience.detect import (  # noqa: F401
    DEFAULT_DEADLINE_FACTOR,
    DeadlineDetector,
    Detection,
)
