"""METG of the PyTorch/CUDA port on one card, with repeated sweeps.

    PYTHONPATH=src python -m benchmarks.torch_metg [--repeats 5] [--out PATH]
        [--ensemble 2,4,8] [--cost-model PATH]
    PYTHONPATH=src python -m benchmarks.torch_metg --devices 4 [--out PATH]
    PYTHONPATH=src python -m benchmarks.torch_metg --fft-only [--devices 4] [--out PATH]
    PYTHONPATH=src python -m benchmarks.torch_metg --smoke --device cpu [--devices 4]

The port's counterpart of ``benchmarks/table2_metg.py`` (METG(50%) per
backend and overdecomposition) and of ``benchmarks/pallas_floor.py``'s
measurements 1-3 on one device. Every run is one CUDA graph replay
(``Runtime.build``). Protocol: ``configs/taskbench.py``'s ``PAPER`` preset
(stencil_1d, T = 1000, payload 64, grains 1..16384 in x4 steps, 5 timed
reps a point, best of them), widths W = SMs x overdecomposition {1, 8, 16},
on four schedules: ``fused(use_kernels=True)``, ``pallas_step`` (S = 1)
and ``pallas_step(steps_per_launch=8)`` pipelined and serial. Each
(schedule, W) sweep runs ``--repeats`` times; a record gives the METG(50%)
of each repeat, their median and their spread.

The paper's other rungs (Table 2's MPI and Charm++/HPX rows), each with the
kernels: ``bsp[kernels]`` (one graph replay a superstep from a host loop),
``bsp_scan[kernels]`` and ``overlap[kernels]`` (the run one graph replay),
on the PAPER preset at every W like the four schedules (cells the
regression guard lists as new; a width a rung refuses, e.g. ``overlap`` at
one point a row on the CPU, gives a ``"kind": "refused"`` record); and ``serialized[kernels]`` (one eager host
call a task), its sweep cut to what fits: T = 50 (the ``QUICK`` preset's
steps; the PAPER preset's T x W at W = 1056 is over its ``MAX_TASKS``), the
best of 1 rep a point, 3 sweeps at W = 132 and 1 at W = 1056 (od 1 and 8),
each record ``"kind": "metg_cut"`` with its ``cuts`` (another protocol than
the guard's cells, so the guard does not read it), its host us a task at
each grain (``us_per_task_median``) and whether its METG(50%) lies within
the sweep (``metg_within_sweep``: false when the FLOP/s peak is the top
grain's, as with a wall the host's issue sets at every grain).

``steps_per_launch="auto"`` runs under the cost model the run calibrates
first (``kernels/probes.py``'s ``run_probes`` on the run's device, or the
cache file ``--cost-model PATH`` names), printed as the first record
(``"kind": "cost_model"``): ``pallas_step[auto]``'s METG(50%) at each W
beside the four schedules (cells the regression guard lists as new), and
the ``Sauto`` row below.

At grain 1, the finest, where the runtime's per-step cost sets the wall,
for each W:
  1. the wall per step of ``pallas_step`` at S in {1, 2, 4, 8, 16},
     pipelined against serial, in interleaved rounds (pipelined, serial,
     pipelined, ...; best of each), and under "auto" (the ``Sauto`` row,
     ``"kind": "steps_per_launch_auto"``: the depth and schedule it
     resolved to, its reason and the model's ``describe()``);
  2. the eager loop (``Runtime._build_eager``) beside the graph at S = 1
     and S = 8 (both schedules), in interleaved rounds: what capture
     removes.

The butterfly floor (``benchmarks/pallas_floor.py``'s measurement 4, on
the non-halo plans): at grain 1 and T = 1000, the wall per step of
``fused[kernels]`` against ``pallas_step`` in interleaved rounds (best of
each), on fft and tree at W in {128, 1024, 2048} (the stride plan) and on
spread and all_to_all at W in {128, 512} (the all-gather plan), with
``pallas_step(steps_per_launch=8)`` beside S = 1 where it re-routes to the
blocked all-gather plan (butterfly under the 512-row gather cap) or blocks
it (the global patterns); each record names the plan each schedule ran.
Then the METG(50%) of fft at W = 2048 for ``fused[kernels]`` and
``pallas_step``, the PAPER preset otherwise, each sweep ``--repeats``
times.

The ensemble rows (``benchmarks/table2_metg.py``'s ``--ensemble``, Task
Bench's ``-and``, the paper's "multi-task per core" scenario): for each K of
``--ensemble`` (default the preset's ``ensemble_sizes`` above 1: 2, 4, 8),
K stencil_1d graphs of seeds 0..K-1 at W = SMs x od for od in {1, 16}, run
as one ``GraphEnsemble`` (one graph replay a run) on ``fused[kernels]``,
``pallas_step`` (S = 1: one K3 launch a step for all K members) and
``pallas_step[S=8,serial]``, the PAPER preset otherwise; each point through
``measure_ensemble``, whose one sample folds the members' tasks and FLOPs
against the ensemble's wall, so granularity is wall x SMs / (K x W x T).
Each (schedule, W, K) sweep runs ``--repeats`` times; single-graph records
carry K = 1.

Row shards (``--devices D``, D > 1): instead of the sweep above, the rows
of the runtimes that run over D row shards of one card
(``Runtime(devices=[card] * D)``), at W = SMs x 16 (2112 on an H100), the
PAPER preset, ``min(--repeats, 3)`` sweeps: ``bsp_scan[kernels]``,
``overlap[kernels]`` with ``overlap`` True and False, ``pallas_step`` S = 1
and ``pallas_step[S=8]`` pipelined, each at D = 1 and then at D (its label
suffixed ``[D=4]``, so the guard's keys never meet the one-device cells;
the guard reads the full sweep's file, not this one); then ``pallas_step``
S = 1 on fft at W = 2048 (the stride plan: in-block strides by the XOR
shuffle, the block strides by the XOR block exchange between shards) at D
= 1 and at D, with the same sweeps. Granularity stays
wall x SMs / tasks: the D shards share the card's SMs. A record
``"kind": "overlap_gain"`` gives, per D and grain, the step wall of
``overlap=False`` over ``overlap=True`` less one: what issuing the halo
transfer under the interior gains, the paper's latency hiding on one card.

``--fft-only``: fft's rows at W = 2048 alone, as the sweep above takes
them (at D = 1 ``fused[kernels]`` and ``pallas_step``; with ``--devices
D``, ``pallas_step`` at D = 1 and at D), each preceded by a ``"kind":
"auto_resolution"`` record: the (plan, S) and reason ``steps_per_launch=
"auto"`` resolves there under the analytic model, at D = 1 and at D.

Every record carries the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``). Records print as
JSON lines and are written to ``--out`` (one JSON object per line).
``--smoke`` is a sweep of a few seconds (T = 6, grains 1 and 16, 2 repeats,
the rungs too, serialized at T = 6 and 2 sweeps at each od;
the floor at W in {8, 16}, fft's METG at W = 16, the ensemble rows at K = 2
and od 1) that also runs with
``--device cpu``, where the runtimes run their eager
loops. The script imports nothing of JAX, of the JAX package ``repro`` or
of ``benchmarks/common.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.taskbench import PAPER, QUICK, TaskBenchConfig
from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, compute_metg, get_runtime
from repro_torch.core.patterns import halo_radius
from repro_torch.core.runtimes._capture import time_runs
from repro_torch.kernels import probes

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "artifacts" / "bench_torch" / "metg.json"
#: (label, backend, options): the schedules swept
SCHEDULES = (
    ("fused[kernels]", "fused", {"use_kernels": True}),
    ("pallas_step", "pallas_step", {}),
    ("pallas_step[S=8]", "pallas_step", {"steps_per_launch": 8}),
    ("pallas_step[S=8,serial]", "pallas_step", {"steps_per_launch": 8, "pipeline": False}),
)
#: the paper's other rungs, with the kernels, on the PAPER preset
RUNG_SCHEDULES = (
    ("bsp[kernels]", "bsp", {"use_kernels": True}),
    ("bsp_scan[kernels]", "bsp_scan", {"use_kernels": True}),
    ("overlap[kernels]", "overlap", {"use_kernels": True}),
)
#: serialized, cut to what fits: at most the QUICK preset's T, 1 rep a
#: point, and (od, sweeps) at each width (the smoke's own)
SERIALIZED_SCHEDULE = ("serialized[kernels]", "serialized", {"use_kernels": True})
SERIALIZED_STEPS, SERIALIZED_REPS = QUICK.steps, 1
SERIALIZED_ODS, SMOKE_SERIALIZED_ODS = ((1, 3), (8, 1)), ((1, 2), (8, 2))
#: the row-shard rows (``--devices``): schedules, od, sweeps at most
SHARD_SCHEDULES = (
    ("bsp_scan[kernels]", "bsp_scan", {"use_kernels": True}),
    ("overlap[kernels]", "overlap", {"use_kernels": True}),
    ("overlap[kernels,overlap=False]", "overlap", {"use_kernels": True, "overlap": False}),
    ("pallas_step", "pallas_step", {}),
    ("pallas_step[S=8]", "pallas_step", {"steps_per_launch": 8}),
)
SHARD_OD, SHARD_REPEATS, SMOKE_SHARD_OD = 16, 3, 8
#: the row-shard rows' stride plan: (label, backend, options, pattern)
SHARD_PLAN_SCHEDULES = (("pallas_step", "pallas_step", {}, "fft"),)
#: "auto" under the run's calibrated model (its cost_model option is added)
AUTO_SCHEDULE = ("pallas_step[auto]", "pallas_step", {"steps_per_launch": "auto"})
SWEEP_S = (1, 2, 4, 8, 16)
EAGER_S = (1, 8)
ROUNDS = 3
#: the butterfly floor: (pattern, widths); fft's METG at FLOOR_METG_W
FLOOR_CASES = (("fft", (128, 1024, 2048)), ("tree", (128, 1024, 2048)),
               ("spread", (128, 512)), ("all_to_all", (128, 512)))
FLOOR_S = 8
FLOOR_METG_W = 2048
#: the schedules of the floor and of fft's METG
FLOOR_SCHEDULES = SCHEDULES[:2]
#: the ensemble rows: the schedules, and the overdecompositions
ENSEMBLE_SCHEDULES = (SCHEDULES[0], SCHEDULES[1], SCHEDULES[3])
ENSEMBLE_ODS = (1, 16)
SMOKE = dataclasses.replace(PAPER, name="smoke", steps=6, grains=(1, 16), reps=2,
                            overdecomposition=(1, 8), ensemble_sizes=(1, 2))
SMOKE_FLOOR = (("fft", (8, 16)), ("tree", (8,)), ("spread", (8,)), ("all_to_all", (8,)))
SMOKE_FLOOR_METG_W = 16


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reads them ("cpu" on the
    CPU)."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _graph(cfg: TaskBenchConfig, width: int, grain: int,
           pattern: Optional[str] = None, seed: int = 0) -> TaskGraph:
    return TaskGraph(steps=cfg.steps, width=width, pattern=pattern or cfg.pattern,
                     payload=cfg.payload, kernel=KernelSpec("compute_bound", grain),
                     seed=seed)


def metg_record(cfg: TaskBenchConfig, label: str, backend: str, options: dict,
                od: Optional[int], repeats: int, device: torch.device,
                width: Optional[int] = None, K: int = 1,
                devices: int = 1) -> Dict[str, object]:
    """``repeats`` grain sweeps of one schedule at W = cores x od (or at
    ``width``, with od None); with K > 1 each point is an ensemble of K
    such graphs (seeds 0..K-1) through ``measure_ensemble``; with
    ``devices`` > 1 over that many row shards of ``device``."""
    shards = {"devices": [device] * devices} if devices > 1 else {}
    rt = get_runtime(backend, device=device, **options, **shards)
    width = rt.cores * od if width is None else width
    metgs: List[Optional[float]] = []
    peaks: List[float] = []
    walls: Dict[int, List[float]] = {grain: [] for grain in cfg.grains}
    capture: List[float] = []
    nodes = dispatches = host_calls = None
    for _ in range(repeats):
        samples = []
        for grain in cfg.grains:
            if K == 1:
                sample, st = rt.measure(_graph(cfg, width, grain), reps=cfg.reps, warmup=1)
            else:
                ens = GraphEnsemble([_graph(cfg, width, grain, seed=k) for k in range(K)])
                sample, st = rt.measure_ensemble(ens, reps=cfg.reps, warmup=1)
            samples.append(sample)
            walls[grain].append(sample.wall_time / cfg.steps * 1e6)
            dispatches, host_calls = st.dispatches, st.host_calls
            if st.capture_s is not None:
                capture.append(st.capture_s)
                nodes = st.graph_nodes
        m = compute_metg(samples)
        metgs.append(m.metg_us)
        peaks.append(m.peak_flops_per_second)
    reached = [m for m in metgs if m is not None]
    med = statistics.median(reached) if reached else None
    return {
        "kind": "metg", "runtime": label, "options": options, "W": width, "od": od, "K": K,
        "steps": cfg.steps, "payload": cfg.payload, "pattern": cfg.pattern,
        "grains": list(cfg.grains), "reps": cfg.reps, "repeats": repeats,
        "metg_us": metgs, "metg_us_median": med,
        "metg_us_min": min(reached) if reached else None,
        "metg_us_max": max(reached) if reached else None,
        "spread": (max(reached) - min(reached)) / med if reached and med else None,
        "unreached": len(metgs) - len(reached),
        "peak_gflops_median": statistics.median(peaks) / 1e9,
        "us_per_step_median": {g: statistics.median(w) for g, w in walls.items()},
        "us_per_step": walls,
        "dispatches_per_run": dispatches, "host_calls_per_run": host_calls,
        "graph_nodes": nodes,
        "capture_s_median": statistics.median(capture) if capture else None,
        "devices": devices,
    }


def shard_records(cfg: TaskBenchConfig, devices: int, repeats: int, device: torch.device,
                  od: int = SHARD_OD, plan_width: int = FLOOR_METG_W):
    """The row-shard rows: each of SHARD_SCHEDULES at D = 1, then over
    ``devices`` shards of ``device`` (label suffixed ``[D=devices]``), W =
    cores x ``od``, ``repeats`` sweeps; each of SHARD_PLAN_SCHEDULES on its
    pattern at W = ``plan_width`` alike; then per D the ``overlap_gain``
    record: per grain the medians' ``gain`` (off / on - 1), its range over
    the sweeps (``gain_range``: the least and most off / on - 1 over every
    pair of sweeps) and ``under``, how far on's median wall lies under
    off's (1 - on / off)."""
    walls = {}
    for label, backend, options in SHARD_SCHEDULES:
        for D in (1, devices):
            tag = label if D == 1 else f"{label}[D={D}]"
            rec = metg_record(cfg, tag, backend, options, od, repeats, device, devices=D)
            walls[(label, D)] = rec["us_per_step"]
            yield rec
    for label, backend, options, pattern in SHARD_PLAN_SCHEDULES:
        for D in (1, devices):
            tag = label if D == 1 else f"{label}[D={D}]"
            yield metg_record(dataclasses.replace(cfg, pattern=pattern), tag, backend, options,
                              None, repeats, device, width=plan_width, devices=D)
    for D in (1, devices):
        on, off = walls[("overlap[kernels]", D)], walls[("overlap[kernels,overlap=False]", D)]
        med_on = {g: statistics.median(w) for g, w in on.items()}
        med_off = {g: statistics.median(w) for g, w in off.items()}
        yield {"kind": "overlap_gain", "devices": D, "W": rec["W"],
               "us_per_step_overlap": med_on, "us_per_step_no_overlap": med_off,
               "gain": {g: med_off[g] / med_on[g] - 1 for g in on},
               "gain_range": {g: [min(off[g]) / max(on[g]) - 1, max(off[g]) / min(on[g]) - 1]
                              for g in on},
               "under": {g: 1 - med_on[g] / med_off[g] for g in on}}


def serialized_records(cfg: TaskBenchConfig, repeats: int, device: torch.device,
                       smoke: bool = False):
    """``serialized[kernels]``'s METG rows, its sweep cut to at most
    ``SERIALIZED_STEPS`` timesteps, ``SERIALIZED_REPS`` rep a point and each
    od's own number of sweeps (at most ``repeats``); each cut is written in
    the record. Its host time a task at each grain (the step wall over W)
    is the rung's own metric: a task's host issue (~70 us on an H100)
    sets its wall at every grain of the sweep, so the FLOP/s peak falls on
    the sweep's top grain and the METG(50%) is the top of the sweep's, not
    the runtime's (``metg_within_sweep`` false)."""
    steps = min(cfg.steps, SERIALIZED_STEPS)
    cut = dataclasses.replace(cfg, steps=steps, reps=SERIALIZED_REPS)
    label, backend, options = SERIALIZED_SCHEDULE
    for od, sweeps in SMOKE_SERIALIZED_ODS if smoke else SERIALIZED_ODS:
        rec = metg_record(cut, label, backend, options, od, min(sweeps, repeats), device)
        rec["kind"] = "metg_cut"
        walls = rec["us_per_step_median"]
        rec["us_per_task_median"] = {g: us / rec["W"] for g, us in walls.items()}
        rec["metg_within_sweep"] = max(walls, key=lambda g: g / walls[g]) != cfg.grains[-1]
        rec["cuts"] = {
            "steps": [steps, cfg.steps], "reps": [SERIALIZED_REPS, cfg.reps],
            "repeats": [rec["repeats"], repeats],
            "reason": "one host call a task: the preset's T x W at od 8 is over "
                      "serialized's MAX_TASKS, and its sweep at full protocol would "
                      "outlast the driver's time"}
        yield rec


def floor_records(cfg: TaskBenchConfig, cases, rounds: int, device: torch.device):
    """The butterfly floor at grain 1: per (pattern, W), ``fused[kernels]``
    against ``pallas_step`` (and ``pallas_step[S=8]`` where S = 8 blocks
    the all-gather plan), each built once and timed in interleaved rounds,
    best of each."""
    for pattern, widths in cases:
        for width in widths:
            g = _graph(cfg, width, 1, pattern)
            rts = {label: get_runtime(backend, device=device, **options)
                   for label, backend, options in FLOOR_SCHEDULES}
            blocked = get_runtime("pallas_step", device=device, steps_per_launch=FLOOR_S)
            plan = blocked._schedule_for_graph(g)
            if plan.steps_per_launch > 1:
                rts[f"pallas_step[S={FLOOR_S}]"] = blocked
            x = rts["pallas_step"]._init(g, None)
            runs = {label: rt.build(g) for label, rt in rts.items()}
            best = {label: float("inf") for label in runs}
            for _ in range(rounds):
                for label, run in runs.items():
                    best[label] = min(best[label], _step_us(cfg, run, x))
            plans = {label: list(rt._schedule_for_graph(g)[:2])
                     for label, rt in rts.items() if rt.name == "pallas_step"}
            yield {"kind": "floor", "pattern": pattern, "W": width, "grain": 1,
                   "steps": cfg.steps, "rounds": rounds, "us_per_step": best,
                   "plans": plans,
                   "launches_per_run": {k: rt.dispatches_per_run(g) for k, rt in rts.items()},
                   "pallas_step_strictly_lower": best["pallas_step"] < best["fused[kernels]"]}


def _step_us(cfg: TaskBenchConfig, run, x: torch.Tensor) -> float:
    """Best host wall per step over ``cfg.reps`` runs of ``run`` on fresh
    copies of ``x``."""
    return min(time_runs(run, x, reps=cfg.reps, warmup=1)) / cfg.steps * 1e6


def _schedules_at(S: int) -> Dict[str, dict]:
    """pallas_step's schedules at depth S: the one at S = 1, else pipelined
    and serial."""
    return {"S=1": {}} if S == 1 else {"pipelined": {}, "serial": {"pipeline": False}}


def grain1_records(cfg: TaskBenchConfig, od: int, sweep_s, eager_s, rounds: int,
                   device: torch.device, model: Optional[probes.CostModel] = None):
    """At grain 1 and W = cores x od: the S sweep (pipelined against serial),
    the ``Sauto`` row under ``model`` (when given), and the eager loop
    beside the graph, each in interleaved rounds."""
    probe = get_runtime("pallas_step", device=device)
    width = probe.cores * od
    g = _graph(cfg, width, 1)
    x = probe._init(g, None)
    for S in sweep_s:
        rts = {key: get_runtime("pallas_step", device=device, steps_per_launch=S, **opts)
               for key, opts in _schedules_at(S).items()}
        best = {key: float("inf") for key in rts}
        for _ in range(rounds):
            for key, rt in rts.items():
                best[key] = min(best[key], _step_us(cfg, rt.build(g), x))
        yield {"kind": "steps_per_launch", "W": width, "od": od, "S": S, "grain": 1,
               "steps": cfg.steps, "rounds": rounds, "us_per_step": best,
               "launches_per_run": {k: rt.dispatches_per_run(g) for k, rt in rts.items()}}
    if model is not None:
        rt = get_runtime("pallas_step", device=device, steps_per_launch="auto",
                         cost_model=model)
        plan = rt._schedule_for_graph(g)
        run = rt.build(g)
        best = min(_step_us(cfg, run, x) for _ in range(rounds))
        yield {"kind": "steps_per_launch_auto", "W": width, "od": od, "S": "auto",
               "grain": 1, "steps": cfg.steps, "rounds": rounds,
               "us_per_step": {"auto": best}, "resolved_S": plan.steps_per_launch,
               "pipelined": rt._pipeline_active(width, plan.steps_per_launch,
                                                halo_radius(g), g.payload),
               "reason": plan.reason, "cost_model": model.describe(),
               "launches_per_run": {"auto": rt.dispatches_per_run(g)}}
    for S in eager_s:
        for sched, opts in _schedules_at(S).items():
            rt = get_runtime("pallas_step", device=device, steps_per_launch=S, **opts)
            runs = {"graph": rt.build(g), "eager": rt._build_eager(g)}
            best = {key: float("inf") for key in runs}
            for _ in range(rounds):
                for key, fn in runs.items():
                    best[key] = min(best[key], _step_us(cfg, fn, x))
            yield {"kind": "graph_vs_eager", "W": width, "od": od, "S": S,
                   "schedule": sched, "grain": 1, "steps": cfg.steps, "rounds": rounds,
                   "us_per_step": best, "launches_per_run": rt.dispatches_per_run(g)}


def calibrate(cfg: TaskBenchConfig, device: torch.device, cost_model: Optional[Path],
              smoke: bool) -> Tuple[probes.CostModel, dict]:
    """The cost model "auto" runs under: the cache file ``cost_model`` names
    (its entry for this device's platform, one device, the preset's payload),
    else ``run_probes`` on ``device``; and its record."""
    t0 = time.perf_counter()
    if cost_model is not None:
        model = probes.coerce_cost_model(cost_model, devices=1, payload=cfg.payload,
                                         platform=probes._platform(device))
        source = str(cost_model)
    else:
        model = probes.run_probes(payload=cfg.payload, smoke=smoke, device=device)
        source = "run_probes"
    return model, {"kind": "cost_model", "source": source, "describe": model.describe(),
                   "model": model.to_dict(), "seconds": time.perf_counter() - t0}


def fft_records(cfg: TaskBenchConfig, repeats: int, device: torch.device, width: int,
                devices: int = 1):
    """fft's rows at W = ``width`` as the full sweep takes them (D = 1:
    FLOOR_SCHEDULES; D > 1: SHARD_PLAN_SCHEDULES at D = 1 and D), each D's
    preceded by what "auto" resolves there."""
    fft = dataclasses.replace(cfg, pattern="fft")
    for D in sorted({1, devices}):
        rt = get_runtime("pallas_step", devices=[device] * D, steps_per_launch="auto",
                         cost_model=probes.analytic_cost_model())
        plan = rt._schedule_for_graph(_graph(fft, width, 1))
        yield {"kind": "auto_resolution", "pattern": "fft", "W": width, "devices": D,
               "plan": plan.kind, "steps_per_launch": plan.steps_per_launch,
               "reason": plan.reason}
    if devices == 1:
        for label, backend, options in FLOOR_SCHEDULES:
            yield metg_record(fft, label, backend, options, None, repeats, device,
                              width=width)
        return
    for label, backend, options, pattern in SHARD_PLAN_SCHEDULES:
        for D in (1, devices):
            tag = label if D == 1 else f"{label}[D={D}]"
            yield metg_record(dataclasses.replace(cfg, pattern=pattern), tag, backend,
                              options, None, min(repeats, SHARD_REPEATS), device,
                              width=width, devices=D)


def run(cfg: TaskBenchConfig, repeats: int, device: torch.device, out: Path,
        sweep_s=SWEEP_S, eager_s=EAGER_S, rounds: int = ROUNDS,
        floor_cases=FLOOR_CASES, floor_metg_w: int = FLOOR_METG_W,
        ensembles=None, ensemble_ods=ENSEMBLE_ODS, cost_model: Optional[Path] = None,
        smoke: bool = False, devices: int = 1, fft_only: bool = False) -> List[dict]:
    """Every record of the sweep, emitted as it is taken; ``ensembles``
    (default the preset's ``ensemble_sizes`` above 1) are the K of the
    ensemble rows; "auto" runs under the model `calibrate` gives. With
    ``devices`` > 1, the row-shard rows instead (`shard_records`)."""
    if ensembles is None:
        ensembles = tuple(k for k in cfg.ensemble_sizes if k > 1)
    t0 = time.perf_counter()
    smi = card(device)
    records: List[dict] = []
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        def emit(rec):
            rec["card"] = smi
            records.append(rec)
            line = json.dumps(rec)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()

        if fft_only:
            for rec in fft_records(cfg, repeats, device, floor_metg_w, devices):
                emit(rec)
            emit({"kind": "summary", "preset": cfg.name, "repeats": repeats,
                  "devices": devices, "device": str(device), "fft_only": True,
                  "seconds": time.perf_counter() - t0})
            return records
        if devices > 1:
            for rec in shard_records(cfg, devices, min(repeats, SHARD_REPEATS), device,
                                     SMOKE_SHARD_OD if smoke else SHARD_OD, floor_metg_w):
                emit(rec)
            emit({"kind": "summary", "preset": cfg.name, "repeats": min(repeats, SHARD_REPEATS),
                  "devices": devices, "device": str(device),
                  "seconds": time.perf_counter() - t0})
            return records
        model, model_rec = calibrate(cfg, device, cost_model, smoke)
        emit(model_rec)
        auto_label, auto_backend, auto_options = AUTO_SCHEDULE
        for od in cfg.overdecomposition:
            for label, backend, options in SCHEDULES:
                emit(metg_record(cfg, label, backend, options, od, repeats, device))
            emit(metg_record(cfg, auto_label, auto_backend,
                             dict(auto_options, cost_model=model.to_dict()), od, repeats,
                             device))
            for label, backend, options in RUNG_SCHEDULES:
                rt = get_runtime(backend, device=device, **options)
                ok, why = rt.supports(_graph(cfg, rt.cores * od, 1))
                emit(metg_record(cfg, label, backend, options, od, repeats, device) if ok
                     else {"kind": "refused", "runtime": label, "od": od,
                           "W": rt.cores * od, "reason": why})
            for rec in grain1_records(cfg, od, sweep_s, eager_s, rounds, device, model):
                emit(rec)
        for rec in serialized_records(cfg, repeats, device, smoke):
            emit(rec)
        for rec in floor_records(cfg, floor_cases, rounds, device):
            emit(rec)
        fft = dataclasses.replace(cfg, pattern="fft")
        for label, backend, options in FLOOR_SCHEDULES:
            emit(metg_record(fft, label, backend, options, None, repeats, device,
                             width=floor_metg_w))
        for K in ensembles:
            for od in ensemble_ods:
                for label, backend, options in ENSEMBLE_SCHEDULES:
                    emit(metg_record(cfg, label, backend, options, od, repeats, device, K=K))
        emit({"kind": "summary", "preset": cfg.name, "repeats": repeats,
              "ensembles": list(ensembles), "device": str(device),
              "seconds": time.perf_counter() - t0})
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="a sweep of a few seconds (T = 6, grains 1 and 16, 2 repeats)")
    ap.add_argument("--cost-model", type=Path, default=None,
                    help="the cost-model cache file \"auto\" runs under (default: "
                         "calibrate with run_probes first)")
    ap.add_argument("--devices", type=int, default=1,
                    help="D > 1: the row-shard rows over D shards of the card instead "
                         "of the sweep (PAPER preset, W = SMs x 16, 3 sweeps)")
    ap.add_argument("--fft-only", action="store_true",
                    help="fft's rows at W = 2048 alone (with --devices D: at D = 1 and D)")
    ap.add_argument("--ensemble", default=None,
                    help="comma-separated ensemble sizes K > 1 of the ensemble rows "
                         "(default: the preset's above 1); 'none' for none")
    args = ap.parse_args(argv)
    ensembles = None
    if args.ensemble is not None:
        ensembles = () if args.ensemble == "none" else tuple(
            int(k) for k in args.ensemble.split(","))
        if any(k < 2 for k in ensembles):
            raise SystemExit(f"torch_metg: ensemble sizes must be > 1, got {ensembles}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_metg: no CUDA device is available; pass --device cpu")
    if args.smoke:
        out = args.out or DEFAULT_OUT.with_name("metg_smoke.json")
        run(SMOKE, min(args.repeats, 2), device, out, sweep_s=(1, 2), eager_s=(1, 2),
            rounds=1, floor_cases=SMOKE_FLOOR, floor_metg_w=SMOKE_FLOOR_METG_W,
            ensembles=ensembles, ensemble_ods=(1,), cost_model=args.cost_model, smoke=True,
            devices=args.devices, fft_only=args.fft_only)
    else:
        default = DEFAULT_OUT if args.devices == 1 else DEFAULT_OUT.with_name(
            f"metg_d{args.devices}.json")
        run(PAPER, args.repeats, device, args.out or default, ensembles=ensembles,
            cost_model=args.cost_model, devices=args.devices, fft_only=args.fft_only)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
