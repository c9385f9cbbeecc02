"""Trace exporters: Chrome ``trace_event`` JSON + JSONL dumps.

Counterpart of ``repro.obs.export``, a copy: either package's readers read
the files either package writes.

The Chrome format (load via chrome://tracing or https://ui.perfetto.dev)
uses complete events (``ph: "X"``, ts/dur in microseconds); zero-length
decision records become instant events (``ph: "i"``). JSONL is one span
dict per line — the grep/pandas-friendly raw form.

``TRACE_SCHEMA_VERSION`` stamps both so downstream consumers can refuse
drifted files loudly.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

from repro_torch.obs.tracer import CAT_DECISION, Span

TRACE_SCHEMA_VERSION = 1


def span_dict(s: Span) -> Dict:
    return {
        "name": s.name,
        "category": s.category,
        "start_us": s.start_us,
        "end_us": s.end_us,
        "depth": s.depth,
        "attrs": s.attrs,
    }


def span_dicts(spans: Sequence[Span]) -> List[Dict]:
    return [span_dict(s) for s in spans]


def to_chrome_trace(spans: Sequence[Span], *, pid: int = 0,
                    process_name: str = "repro_torch") -> Dict:
    events: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for s in spans:
        args = {k: v for k, v in s.attrs.items()}
        args["category"] = s.category
        if s.category == CAT_DECISION or s.end_us <= s.start_us:
            events.append({
                "name": s.name, "cat": s.category, "ph": "i", "s": "t",
                "ts": s.start_us, "pid": pid, "tid": s.depth, "args": args,
            })
        else:
            events.append({
                "name": s.name, "cat": s.category, "ph": "X",
                "ts": s.start_us, "dur": s.duration_us,
                "pid": pid, "tid": s.depth, "args": args,
            })
    return {
        "schemaVersion": TRACE_SCHEMA_VERSION,
        "displayTimeUnit": "ms",
        "traceEvents": events,
    }


def write_chrome_trace(path: str, spans: Sequence[Span], *,
                       process_name: str = "repro_torch") -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, process_name=process_name), f)
    return path


def write_jsonl(path: str, spans: Sequence[Span]) -> str:
    with open(path, "w") as f:
        f.write(json.dumps({"schema": TRACE_SCHEMA_VERSION}) + "\n")
        for s in spans:
            f.write(json.dumps(span_dict(s)) + "\n")
    return path
