"""Structured runtime telemetry: the counterpart of ``repro.obs``.

tracer.py     span recorder (categories, monotonic us timestamps, the
              off-by-default NULL_TRACER fast path)
export.py     Chrome trace_event JSON + JSONL dumps
decompose.py  per-category wall attribution + the overlap verdict
"""
from repro_torch.obs.decompose import (
    DECOMPOSE_SCHEMA_VERSION,
    category_walls,
    decision_records,
    overlap_verdict,
    probe_costs,
    summarize,
    union_us,
    wall_extent_us,
)
from repro_torch.obs.export import (
    TRACE_SCHEMA_VERSION,
    span_dicts,
    to_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.tracer import (
    CAT_DECISION,
    CAT_FAULT,
    CAT_LAUNCH,
    CATEGORIES,
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    coerce_tracer,
)

__all__ = [
    "CATEGORIES", "CAT_DECISION", "CAT_FAULT", "CAT_LAUNCH",
    "NULL_TRACER", "NullTracer",
    "Span", "Tracer", "coerce_tracer",
    "TRACE_SCHEMA_VERSION", "span_dicts", "to_chrome_trace",
    "write_chrome_trace", "write_jsonl",
    "DECOMPOSE_SCHEMA_VERSION", "category_walls", "decision_records",
    "overlap_verdict", "probe_costs", "summarize", "union_us",
    "wall_extent_us",
]
