"""One device's software-pipelined blocked launch on the card: the trace of
one graph replay, the METG rows it sets, and the same run through the
row-shard schedule on a ring of one shard.

    PYTHONPATH=src:. python -m benchmarks.torch_pipeline_trace [--only trace,metg,ring]
        [--repeats 3] [--out PATH]
    PYTHONPATH=src:. python -m benchmarks.torch_pipeline_trace --smoke --device cpu

``trace``: stencil_1d at W = SMs x 16 (2112 on an H100), payload 64,
``pallas_step(steps_per_launch=8)`` pipelined, T = 1 + 8 x 12, at grains
16384 and 64. One warm graph replay runs under ``torch.profiler`` after a
marker spin kernel; its trace, exported as Chrome JSON and read back, gives
every device kernel's start, duration, stream and grid. Per launch: the two
K4 nodes (the boundary phase, the smaller grid, and the interior), each
one's duration, which of them started first and how long they overlapped,
and the launch's wall (its first K4's start to the next launch's). Beside
them the graph's node count and the K4 grids the tile planner gives both
phases (``taskbench_step.blocked_plan``).

``metg``: ``benchmarks/torch_metg.py``'s D = 1 rows of its row-shard sweep
for ``pallas_step`` at S = 1 and S = 8 pipelined, and S = 8 serial beside
them (the PAPER preset, W = SMs x 16, ``--repeats`` sweeps), through its
``metg_record``.

``ring``: the one-device halo plan at S = 8, pipelined and serial, as
``pallas_step`` builds it and through the row-shard schedule
(``_halo_shard_steps``) on a ring of one shard, whose exchange is the
self-wrap; each captured as one graph. Per case: the two runs equal bit for
bit, their K4 launches and graph nodes, and µs a step at grains 64 and
16384 (T = 1000, the best of 3 interleaved rounds of 5 timed replays).

The trace and metg parts run against any checkout of the port placed first
on PYTHONPATH, so one call can compare two trees. Every record carries the
card's name and power limit; records print as JSON lines and go to
``--out`` (one JSON object a line). ``--smoke`` runs the ring part at W =
64, T = 17 (and, on the card, the trace at W = 64); with ``--device cpu``
the runs are the eager loops on the plain versions. The script imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import tempfile
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmarks.torch_metg import PAPER, SHARD_OD, card, metg_record
from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes._capture import GraphRun, time_runs
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "artifacts" / "bench_torch" / "pipeline_trace.json"
S_PIPE, PAYLOAD, TRACE_LAUNCHES = 8, 64, 12
TRACE_GRAINS, RING_GRAINS, RING_STEPS = (16384, 64), (64, 16384), 1000
#: the METG rows: (label, options), as torch_metg labels them
METG_ROWS = (("pallas_step", {}), ("pallas_step[S=8]", {"steps_per_launch": 8}),
             ("pallas_step[S=8,serial]", {"steps_per_launch": 8, "pipeline": False}))
#: K4's device kernels (`csrc/taskbench_blocked.cu`: the tiled form's, and
#: the cooperative form's compute body)
K4_KERNELS = ("blocked_tiled_kernel", "blocked_compute_kernel")


def _graph(width: int, steps: int, grain: int) -> TaskGraph:
    return TaskGraph(steps=steps, width=width, pattern="stencil_1d", payload=PAYLOAD,
                     kernel=KernelSpec("compute_bound", grain), seed=0)


def _init(width: int, device: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.uniform(0.1, 1.0, (width, PAYLOAD)).astype(np.float32)).to(device)


def _overlap(a, b) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def _device_kernels(prof) -> List[dict]:
    """The profiled window's device kernels after the last marker spin, as
    dicts of start and end (µs), name, stream and CTAs, in start order."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = sorted(({"start": e["ts"], "end": e["ts"] + e["dur"], "name": e["name"],
                       "stream": e.get("args", {}).get("stream"),
                       "ctas": int(np.prod(e["args"]["grid"]))
                       if "grid" in e.get("args", {}) else None}
                      for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"),
                     key=lambda k: k["start"])
    marks = [i for i, k in enumerate(kernels) if "sleep" in k["name"].lower()
             or "spin" in k["name"].lower()]
    if not marks:
        raise RuntimeError("the profiler recorded no marker kernel")
    return kernels[marks[-1] + 1:]


def trace_records(device: torch.device, width: int, grains=TRACE_GRAINS,
                  launches: int = TRACE_LAUNCHES):
    """One warm replay of the pipelined S = 8 run per grain, traced."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.taskbench_step import blocked_plan

    rt = get_runtime("pallas_step", device=device, steps_per_launch=S_PIPE)
    depth = S_PIPE  # stencil_1d: radius 1
    plans = {"interior": blocked_plan((1, width, PAYLOAD), (1, width, 3), S_PIPE, "window",
                                      False, 1, rt.cores),
             "boundary": blocked_plan((2, 3 * depth, PAYLOAD), (2, 3 * depth, 3), S_PIPE,
                                      "window", False, 1, rt.cores)}
    for grain in grains:
        g = _graph(width, 1 + S_PIPE * launches, grain)
        run = rt.build(g)
        x = _init(width, device)
        run(x)
        run.stage(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)  # the marker
            run.graphed.replay()
            torch.cuda.synchronize()
        kernels = _device_kernels(prof)
        k4 = [k for k in kernels if any(n in k["name"] for n in K4_KERNELS)]
        names = sorted({k["name"][:60] for k in kernels})
        if len(k4) != 2 * launches:  # the trace missed nodes: say what it holds
            yield {"kind": "trace", "grain": grain, "W": width, "S": S_PIPE,
                   "launches": launches, "graph_nodes": run.nodes,
                   "device_kernels": len(kernels), "k4_nodes": len(k4),
                   "kernel_names": names}
            continue
        per = []
        for l in range(launches):
            a, b = k4[2 * l], k4[2 * l + 1]
            if a["ctas"] is not None and b["ctas"] is not None:
                bnd, mid = (a, b) if a["ctas"] < b["ctas"] else (b, a)
            else:
                bnd, mid = a, b  # no grid recorded: in start order
            nxt = k4[2 * l + 2]["start"] if l + 1 < launches else None
            per.append({
                "boundary_us": bnd["end"] - bnd["start"], "interior_us": mid["end"] - mid["start"],
                "overlap_us": _overlap((a["start"], a["end"]), (b["start"], b["end"])),
                "first": "interior" if mid is a else "boundary",
                "gap_us": max(a["start"], b["start"]) - a["start"],
                "launch_us": None if nxt is None else nxt - a["start"],
                "streams": [bnd["stream"], mid["stream"]], "ctas": [bnd["ctas"], mid["ctas"]]})
        steady = per[1:]  # launch 0 follows the t = 0 K3

        def med(key):
            return statistics.median(p[key] for p in steady if p[key] is not None)

        yield {
            "kind": "trace", "grain": grain, "W": width, "S": S_PIPE, "launches": launches,
            "graph_nodes": run.nodes, "device_kernels": len(kernels), "k4_nodes": len(k4),
            "kernel_names": names,
            "planned_ctas": {key: (p.ctas if p is not None else None) for key, p in plans.items()},
            "boundary_us_median": med("boundary_us"), "interior_us_median": med("interior_us"),
            "overlap_us_median": med("overlap_us"), "gap_us_median": med("gap_us"),
            "launch_us_median": med("launch_us"),
            "interior_first": sum(p["first"] == "interior" for p in steady),
            "per_launch": per}
        del run


def metg_records(device: torch.device, repeats: int, cfg=PAPER):
    for label, options in METG_ROWS:
        yield metg_record(cfg, label, "pallas_step", options, SHARD_OD, repeats, device)


def ring_run(rt, graph: TaskGraph, S: int):
    """``rt``'s halo plan at depth S through `_halo_shard_steps` on a ring
    of one shard, under ``rt``'s pipeline gate: the t = 0 launch, then
    every launch with its act row."""
    from repro_torch.core.runtimes._halo import ShardMesh
    from repro_torch.core.runtimes.pallas_step import _act_schedule

    mesh = ShardMesh([rt.device])
    pair = rt._halo_shard_steps((graph,), S, mesh, graph.steps)
    acts = torch.from_numpy(_act_schedule((graph.steps,), graph.steps, S)).to(rt.device)

    def run(x):
        mesh.fork()
        carry = pair.t0([x[None]])
        for a in acts:
            carry = pair.launch(carry, [a])
        out = pair.states(carry)
        mesh.join(out)
        return out[0][0]

    return run


def _launches(run, x) -> Dict[str, int]:
    before = ops.launch_counts()
    run(x)
    if x.device.type == "cuda":
        torch.cuda.synchronize()
    return {k: n - before[k] for k, n in ops.launch_counts().items() if n - before[k]}


def ring_records(device: torch.device, width: int, steps: int = RING_STEPS,
                 grains=RING_GRAINS, rounds: int = 3, reps: int = 5):
    """Per (schedule, grain): the built run and the one-shard ring run."""
    for pipeline in (True, False):
        rt = get_runtime("pallas_step", device=device, steps_per_launch=S_PIPE,
                         pipeline=pipeline)
        pipelined = rt._pipeline_active(width, S_PIPE, 1, PAYLOAD)
        for grain in grains:
            g = _graph(width, steps, grain)
            x = _init(width, device)
            runs = {"built": rt.build(g), "ring": ring_run(rt, g, S_PIPE)}
            if device.type == "cuda":
                runs["ring"] = GraphRun(runs["ring"], torch.zeros_like(x))
            outs = {key: run(x) for key, run in runs.items()}
            launches = {key: _launches(run, x) for key, run in runs.items()}
            best = {key: float("inf") for key in runs}
            for _ in range(rounds):
                for key, run in runs.items():
                    best[key] = min(best[key], min(time_runs(run, x, reps=reps)))
            yield {"kind": "ring", "pipeline": pipeline, "pipelined": pipelined,
                   "grain": grain, "W": width,
                   "steps": steps, "S": S_PIPE,
                   "equal": bool(torch.equal(outs["built"], outs["ring"])),
                   "launches": launches,
                   "graph_nodes": {key: getattr(run, "nodes", None) for key, run in runs.items()},
                   "us_per_step": {key: t / steps * 1e6 for key, t in best.items()}}
            del runs, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="trace,metg,ring",
                    help="comma-separated parts: trace, metg, ring")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="W = 64, T = 17: the ring part (and the trace, on the card)")
    args = ap.parse_args(argv)
    parts = set(args.only.split(","))
    if parts - {"trace", "metg", "ring"}:
        raise SystemExit(f"torch_pipeline_trace: unknown parts {sorted(parts)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_pipeline_trace: no CUDA device is available; pass --device cpu")
    width = 64 if args.smoke else get_runtime("pallas_step", device=device).cores * SHARD_OD
    name = card(device)
    out = args.out or DEFAULT_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    gens = []
    if "trace" in parts and device.type == "cuda":
        gens.append(trace_records(device, width, launches=2 if args.smoke else TRACE_LAUNCHES))
    if "metg" in parts and not args.smoke:
        gens.append(metg_records(device, args.repeats))
    if "ring" in parts:
        gens.append(ring_records(device, width, *((17, (1, 16), 1, 2) if args.smoke else ())))
    with out.open("w") as f:
        for gen in gens:
            for rec in gen:
                rec["card"] = name
                line = json.dumps(rec)
                print(line, flush=True)
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
