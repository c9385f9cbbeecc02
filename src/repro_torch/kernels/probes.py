"""Measured cost model: probes taken on the card behind the scheduling policy.

Counterpart of ``repro.kernels.probes``. ``schedule.py`` ranks launch
depths and plans with covers/pays-off rules in *row-steps* against one
exchange-cost constant; this module measures what the card costs:

  probe_launch_us          one K3 launch as a CUDA graph node (window mode,
                           8 rows: all fixed cost)
  probe_row_step_us        one working row advanced one depth: the slope of
                           K3's per-launch wall over widths
  probe_halo_exchange_us   the deep halo exchange per transport between D
                           row shards (D on one card unless the caller
                           names distinct devices); on one device a
                           self-wrap that launches nothing: {"self": 0.0}
  probe_stride_exchange_us the XOR block exchange (stride 1) per transport
                           between D shards; {} below 2 devices and at D
                           not a power of two
  probe_gather_us          the all-gather plan's gather per width; on one
                           device the gathered buffer is the state: 0.0
  probe_gather_impl_us     the gather per (transport, device count, width),
                           and per chunk group ("chunked:gG"): the table
                           behind `schedule.choose_gather_impl` and
                           `schedule.choose_gather_chunk_group`, the median
                           of its replays

Every run of the port is one CUDA graph replay, so a launch costs what it
costs as a graph node: each probe captures N chained launches in one graph,
replays it behind a device sleep (``launch.attention_times.gpu_ms``, CUDA
events) and takes the wall over N. A host-synchronised single call, as the
reference's ``_time_best_us`` takes, would measure the synchronisation.

The row-step probe's widths and floor. K3 costs the same fixed ~2 us at
every width up to 2112 rows (PERF.md §5, NVIDIA H100 80GB HBM3, 700 W), so
a slope over such widths is noise. The probe widths (16384, 65536, 262144
rows; 8 to 124 waves of K3's 132 CTAs of 16 rows at payload 64) are where
the wall grows with the rows: a row reads and writes 2 x 64 x 4 = 512
bytes, 1.5e-4 us at the card's 3.35 TB/s, so 262144 rows take ~40 us a
launch. The floor is restated in the card's units: a tenth of that byte
time, ``ROW_STEP_FLOOR_FRACTION x 8 x payload / HBM_BYTES_PER_S`` (1.5e-5
us at payload 64); a slope at the floor was not measured. The reference's
1e-3 us floor, a TPU-container number, would price a K = 4 stacked S = 8
launch (8448 rows) at ~70 us where K4 takes ~12.

``run_probes`` bundles the results into a :class:`CostModel` and
``save_cost_model`` persists it under ``artifacts/bench_torch/cost_model.json``
(the reference's cache, ``artifacts/bench/cost_model.json``, is never
written), keyed per (platform, device count, payload); the platform is the
CUDA device name (``torch.cuda.get_device_name``), "cpu" on the CPU. One
repair against the reference: the exchange ratio X = exchange / row-step is
derived when the exchange was measured at all (``is not None``), where the
reference tests its truth, so a measured exchange of 0.0 (one device) gives
X = max(1, 0) = 1, not the analytic 512. Then no depth's pipelined split
pays off and "auto" on one device runs the serial schedule. Across D > 1
row shards (``run_probes(devices=D)``) the halo probe times a real
exchange between D shards of the card (each transport started and joined,
as CUDA graph nodes), so X prices "auto"'s pipeline gate
(``schedule.pipeline_interior_covers_exchange``) by what the card pays; the
stride, gather and gather-transport probes time their transfers the same
way, and price the stride plan against the gathered one
(``schedule.gathered_beats_strides``) and the gather transports.

The transport-choice probe (`probe_gather_impl_us`) takes the median of its
replays, as the reference's does: a transport chosen for every launch is
ranked by the wall a launch typically pays, not by the best one. On the card
each of its replays is timed with its own pair of CUDA events, all queued
behind one device sleep.

``default_cost_model`` is the resolution every scheduling decision goes
through when no model is passed explicitly; precedence:

  explicit option  a CostModel handed to the resolver / runtime wins
  env              REPRO_PIPELINE_EXCHANGE_ROW_STEPS overrides the
                   exchange constant (source="env")
  cached probes    a matching entry in the cache file (REPRO_COST_MODEL
                   names the file; unset -> the default path; "off"
                   disables the cache, which the test suite pins)
  analytic         schedule.PIPELINE_EXCHANGE_ROW_STEPS, no absolute costs,
                   plans not rankable

CLI (calibrate on the card and persist; ``--devices D`` calibrates D
shards of the card, the ``|dD|`` entry)::

    PYTHONPATH=src python -m repro_torch.kernels.probes \
        --out artifacts/bench_torch/cost_model.json [--devices 4]

Nothing is timed or built when this module is imported; the probes import
the kernels inside their functions.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

from repro_torch.kernels import schedule as _schedule

#: Cache layout version (the reference's); loads fail on a mismatch.
SCHEMA_VERSION = 1

#: REPRO_COST_MODEL: path of the calibration cache file; empty/unset -> the
#: default path below; one of _DISABLE_VALUES -> no cache.
COST_MODEL_ENV = "REPRO_COST_MODEL"

_DISABLE_VALUES = ("off", "0", "none", "disabled")

#: the port's own cache, at the root of the checkout
DEFAULT_CACHE_PATH = (
    Path(__file__).resolve().parents[3] / "artifacts" / "bench_torch"
    / "cost_model.json"
)

#: The one-device halo exchange's key in ``halo_exchange_us``: a wrap of the
#: state onto itself, no launch.
SELF_EXCHANGE = "self"

#: The card's memory rate (H100 SXM data sheet, 700 W), bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: The row-step floor, as a fraction of the time one row's bytes (read and
#: write, f32) take at HBM_BYTES_PER_S.
ROW_STEP_FLOOR_FRACTION = 0.1

#: The launch probe: K3 over this many rows, N launches a graph.
LAUNCH_ROWS = 8
LAUNCH_NODES = 100
#: The row-step probe's widths and launches a graph (see the docstring).
ROW_WIDTHS = (16384, 65536, 262144)
ROW_NODES = 20
#: The smoke grids: the CPU tests' sizes.
SMOKE_ROW_WIDTHS = (64, 256, 512)
SMOKE_NODES = 4
#: The all-gather plan's widths the gather probe reports.
GATHER_WIDTHS = (64, 256, 512)
#: The stride probe's rows a shard.
STRIDE_BLOCK = 32
#: Replays the transport-choice probe takes the median of (smoke: 5).
GATHER_IMPL_REPS = 25


@dataclasses.dataclass(frozen=True)
class CostModel:
    """The costs the scheduling policy runs on, and where they came from
    (the reference's fields and codec). ``exchange_row_steps`` is the one
    number every covers/pays-off rule consumes; the rest exist only on
    measured models. All wall costs are microseconds."""

    source: str  # "analytic" | "env" | "measured"
    exchange_row_steps: float
    launch_us: Optional[float] = None
    row_step_us: Optional[float] = None
    halo_exchange_us: Dict[str, float] = dataclasses.field(default_factory=dict)
    stride_exchange_us: Dict[str, float] = dataclasses.field(default_factory=dict)
    gather_us: Dict[int, float] = dataclasses.field(default_factory=dict)
    #: impl -> devices -> width -> us: the devices-dimension gather probes
    #: behind `schedule.choose_gather_impl` (and, under "chunked:gG" keys,
    #: `schedule.choose_gather_chunk_group`); empty on one device
    gather_impl_us: Dict[str, Dict[int, Dict[int, float]]] = (
        dataclasses.field(default_factory=dict))
    platform: str = ""
    devices: int = 0
    payload: int = 0

    # ------------------------------------------------------------ queries

    @property
    def is_measured(self) -> bool:
        return self.source == "measured"

    @property
    def can_rank_plans(self) -> bool:
        """Plan ranking needs absolute costs: launch, row-step and at least
        one measured gather width."""
        return (self.is_measured and self.launch_us is not None
                and self.row_step_us is not None and bool(self.gather_us))

    @staticmethod
    def _interp_width(curve: Dict[int, float],
                      width: int) -> Optional[float]:
        """Piecewise-linear over probed widths, clamp-extrapolated with the
        end slopes. None on an empty curve."""
        if not curve:
            return None
        pts = sorted(curve.items())
        if len(pts) == 1 or width <= pts[0][0]:
            lo, hi = pts[0], pts[min(1, len(pts) - 1)]
        elif width >= pts[-1][0]:
            lo, hi = pts[-2], pts[-1]
        else:
            lo = max(p for p in pts if p[0] <= width)
            hi = min(p for p in pts if p[0] >= width)
        if lo[0] == hi[0]:
            return float(lo[1])
        slope = (hi[1] - lo[1]) / (hi[0] - lo[0])
        return float(max(0.0, lo[1] + slope * (width - lo[0])))

    def gather_us_at(self, width: int) -> Optional[float]:
        """Measured gather wall at ``width``, interpolated per
        :meth:`_interp_width`. None when the model has no gather probes."""
        return self._interp_width(self.gather_us, width)

    def gather_walls_at(self, width: int,
                        devices: Optional[int] = None) -> Dict[str, float]:
        """Per-transport gather walls at (devices, width) from the
        devices-dimension probes: impl -> interpolated us, only for the
        transports probed at exactly ``devices`` (default the model's own
        count): a wall measured at another D says nothing of this one's
        rendezvous. Empty when nothing was probed at that count."""
        d = int(devices) if devices is not None else self.devices
        out: Dict[str, float] = {}
        for impl, by_devices in self.gather_impl_us.items():
            us = self._interp_width(by_devices.get(d, {}), width)
            if us is not None:
                out[impl] = us
        return out

    def stride_us_for(self, impl: str = "xla") -> Optional[float]:
        """One XOR block-exchange wall for ``impl``, falling back to any
        probed transport; None when none was probed."""
        if impl in self.stride_exchange_us:
            return float(self.stride_exchange_us[impl])
        if self.stride_exchange_us:
            return float(min(self.stride_exchange_us.values()))
        return None

    def describe(self, width: Optional[int] = None) -> str:
        """The verdict source, for reason strings: a wrong auto-pick must be
        diagnosable from the message alone."""
        if self.source == "env":
            return (f"env override {_schedule._EXCHANGE_ROW_STEPS_ENV}="
                    f"{self.exchange_row_steps:g} row-steps")
        if not self.is_measured:
            return (f"analytic fallback "
                    f"(exchange={self.exchange_row_steps:g} row-steps)")
        parts = [f"measured on {self.platform} x{self.devices}"]
        costs = []
        if self.halo_exchange_us:
            costs.append(f"exchange={min(self.halo_exchange_us.values()):.1f}us")
        stride = self.stride_us_for()
        if stride is not None:
            costs.append(f"stride={stride:.1f}us")
        g = self.gather_us_at(width) if width else None
        if g is not None:
            costs.append(f"gather={g:.1f}us@w{width}")
        elif self.gather_us:
            w, us = sorted(self.gather_us.items())[-1]
            costs.append(f"gather={us:.1f}us@w{w}")
        if self.launch_us is not None:
            costs.append(f"launch={self.launch_us:.1f}us")
        if self.row_step_us is not None:
            costs.append(f"row-step={self.row_step_us:.3f}us")
        return (f"{parts[0]}: " + ", ".join(costs)
                + f" -> exchange={self.exchange_row_steps:g} row-steps")

    # -------------------------------------------------------------- codec

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["gather_us"] = {str(k): v for k, v in sorted(self.gather_us.items())}
        d["gather_impl_us"] = {
            impl: {str(dd): {str(w): us for w, us in sorted(curve.items())}
                   for dd, curve in sorted(by_d.items())}
            for impl, by_d in sorted(self.gather_impl_us.items())}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown CostModel fields {sorted(extra)}")
        d = dict(d)
        d["gather_us"] = {int(k): float(v)
                          for k, v in d.get("gather_us", {}).items()}
        d["gather_impl_us"] = {
            str(impl): {int(dd): {int(w): float(us)
                                  for w, us in curve.items()}
                        for dd, curve in by_d.items()}
            for impl, by_d in d.get("gather_impl_us", {}).items()}
        return cls(**d)

    def cache_key(self) -> str:
        return f"{self.platform}|d{self.devices}|p{self.payload}"


def analytic_cost_model() -> CostModel:
    """The documented fallback: schedule.py's constant, no absolute costs,
    plans not rankable."""
    return CostModel(source="analytic",
                     exchange_row_steps=float(
                         _schedule.PIPELINE_EXCHANGE_ROW_STEPS))


def _env_cost_model(raw: str) -> CostModel:
    """REPRO_PIPELINE_EXCHANGE_ROW_STEPS as a model; invalid values raise."""
    value = int(raw)
    if value <= 0:
        raise ValueError(
            f"{_schedule._EXCHANGE_ROW_STEPS_ENV} must be a positive "
            f"integer, got {raw!r}")
    return CostModel(source="env", exchange_row_steps=float(value))


# --------------------------------------------------------------- cache file


def save_cost_model(model: CostModel, path=None) -> Path:
    """Merge one calibration into the cache file (other keys survive)."""
    path = Path(path) if path is not None else DEFAULT_CACHE_PATH
    entries: Dict[str, CostModel] = {}
    if path.exists():
        entries = load_cost_model(path)
    entries[model.cache_key()] = model
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "schema": SCHEMA_VERSION,
        "entries": {k: m.to_dict() for k, m in sorted(entries.items())},
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return path


def load_cost_model(path=None) -> Dict[str, CostModel]:
    """All cached calibrations, keyed "platform|dD|pP". Corrupt files and
    schema mismatches raise ValueError."""
    path = Path(path) if path is not None else DEFAULT_CACHE_PATH
    try:
        raw = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt cost-model cache {path}: {e}") from None
    if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
        schema = raw.get("schema") if isinstance(raw, dict) else None
        raise ValueError(
            f"cost-model cache {path} has schema {schema!r}, "
            f"this build reads schema {SCHEMA_VERSION}: re-run "
            f"`python -m repro_torch.kernels.probes` to recalibrate")
    try:
        return {k: CostModel.from_dict(v)
                for k, v in raw.get("entries", {}).items()}
    except (TypeError, ValueError) as e:
        raise ValueError(f"corrupt cost-model cache {path}: {e}") from None


def _match_entry(entries: Dict[str, CostModel], platform: str,
                 devices: Optional[int],
                 payload: Optional[int]) -> Optional[CostModel]:
    """Best cached calibration for the current context: platform must match
    exactly; device count must match when known; payload picks the nearest
    probe."""
    pool = [m for m in entries.values() if m.platform == platform]
    if devices is not None:
        pool = [m for m in pool if m.devices == devices]
    if not pool:
        return None
    if payload is not None:
        pool.sort(key=lambda m: (abs(m.payload - payload), m.payload))
    else:
        pool.sort(key=lambda m: m.payload)
    return pool[0]


def _device(device=None):
    """The probes' device: the card unless ``device`` says "cpu"; asking
    for the card where there is none raises."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on the card and no CUDA device is "
                           "available; pass device='cpu' for the plain path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the probes run on cuda or cpu, not {dev}")
    return dev


def _platform(device=None) -> str:
    """The cache's platform key: the CUDA device name on the card, "cpu" on
    the CPU. With no device, the card if there is one."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev.index or 0)


_default_cache: Dict[tuple, CostModel] = {}


def default_cost_model(devices: Optional[int] = None,
                       payload: Optional[int] = None,
                       platform: Optional[str] = None) -> CostModel:
    """The model scheduling decisions use when none is passed explicitly:
    env constant > cached probes > analytic fallback (the explicit tier
    lives at the call sites). Re-reads the environment per call; memoizes
    file loads per (path, mtime). ``platform`` defaults to `_platform()`."""
    raw_env = os.environ.get(_schedule._EXCHANGE_ROW_STEPS_ENV)
    if raw_env:
        return _env_cost_model(raw_env)
    raw_path = os.environ.get(COST_MODEL_ENV)
    if raw_path and raw_path.strip().lower() in _DISABLE_VALUES:
        return analytic_cost_model()
    path = Path(raw_path) if raw_path else DEFAULT_CACHE_PATH
    if not path.exists():
        return analytic_cost_model()
    platform = _platform() if platform is None else platform
    mtime = path.stat().st_mtime_ns
    key = (str(path), mtime, platform, devices, payload)
    if key not in _default_cache:
        entry = _match_entry(load_cost_model(path), platform, devices, payload)
        _default_cache[key] = entry if entry is not None \
            else analytic_cost_model()
    return _default_cache[key]


def coerce_cost_model(value, devices: Optional[int] = None,
                      payload: Optional[int] = None,
                      platform: Optional[str] = None) -> CostModel:
    """A runtime's ``cost_model`` option -> CostModel. Accepts a CostModel,
    a to_dict()-shaped dict, or a cache-file path; None falls through to
    ``default_cost_model``."""
    if value is None:
        return default_cost_model(devices=devices, payload=payload,
                                  platform=platform)
    if isinstance(value, CostModel):
        return value
    if isinstance(value, dict):
        return CostModel.from_dict(value)
    if isinstance(value, (str, os.PathLike)):
        platform = _platform() if platform is None else platform
        entry = _match_entry(load_cost_model(Path(value)), platform,
                             devices, payload)
        if entry is None:
            raise ValueError(
                f"cost-model file {value} has no entry for platform "
                f"{platform!r} at {devices} devices")
        return entry
    raise TypeError(
        f"cost_model option must be a CostModel, dict, or path; "
        f"got {type(value).__name__}")


# ------------------------------------------------------------------- probes


def row_step_floor_us(payload: int) -> float:
    """The row-step probe's floor: ROW_STEP_FLOOR_FRACTION of the time one
    row's f32 bytes, read and written, take at the card's memory rate."""
    return ROW_STEP_FLOOR_FRACTION * 8 * payload / HBM_BYTES_PER_S * 1e6


def _replay_walls_ms(replay: Callable[[], object], n: int) -> list:
    """Device time of each of ``n`` calls of ``replay``, in ms: each call
    between its own pair of CUDA events, all queued behind one device sleep
    long enough to cover their enqueue (taken again behind a sleep twice as
    long where it was not, as `attention_times.gpu_ms` does)."""
    import torch

    from repro_torch.launch.attention_times import COVER_ATTEMPTS

    for _ in range(3):
        replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(max(200_000_000, 4e6 * host_ms * n))
    for attempt in range(COVER_ATTEMPTS):
        asleep = torch.cuda.Event(enable_timing=True)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        t0 = time.perf_counter()
        asleep.record()
        torch.cuda._sleep(cycles << attempt)
        for i in range(n):
            marks[i].record()
            replay()
        marks[n].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        marks[n].synchronize()
        if enqueue_ms < asleep.elapsed_time(marks[0]):
            return [marks[i].elapsed_time(marks[i + 1]) for i in range(n)]
    raise RuntimeError(
        f"enqueueing {n} replays took {enqueue_ms:.3f} ms, longer than the device "
        f"sleep meant to cover it, {COVER_ATTEMPTS} times")


def time_best_us(fn: Callable[[], object], device, reps: int = 2) -> float:
    """Best of ``reps`` walls of ``fn()``, in us: the reference's
    ``_time_best_us``, which prices the traced runs' phase probes. On the
    card ``fn`` (work issued on the current stream of ``device``, or forked
    from it and joined back) runs once as a warm-up, is captured as one CUDA
    graph, and each of ``reps`` replays is timed between its own CUDA events
    (`_replay_walls_ms`); the warm-up and the capture count as a build and
    the replays are not counted, so a probe leaves the launch counters as
    they were. On the CPU the best of ``reps`` host walls after one
    warm-up call."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        fn()
        best = float("inf")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6
    from repro_torch.core.runtimes._capture import Graphed
    from repro_torch.kernels import _build

    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with _build.building(), torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = Graphed(fn, stream)
    try:
        with torch.cuda.device(dev):
            return min(_replay_walls_ms(graph.graph.replay, max(1, reps))) * 1e3
    finally:
        graph.close()


def _launch_us(step: Callable, x, nodes: int, reps: int, device=None,
               stat: str = "mean") -> float:
    """Wall of one of ``nodes`` chained ``x = step(x)`` launches, in us: on
    the card the chain captured as one CUDA graph, ``reps`` replays queued
    back to back behind a device sleep and timed with CUDA events (their
    mean; ``stat="median"``: each replay timed alone, the median); on the
    CPU the best (``stat="median"``: the median) of ``reps`` host walls of
    the chain."""
    def chain():
        y = x
        for _ in range(nodes):
            y = step(y)
        return y

    dev = x.device if device is None else device
    if dev.type == "cuda":
        import torch

        from repro_torch.core.runtimes._capture import Graphed
        from repro_torch.launch.attention_times import gpu_ms

        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            chain()  # the warm-up (loads the kernel) before capture
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = Graphed(chain, stream)
        try:
            if stat == "median":
                return statistics.median(_replay_walls_ms(graph.replay, max(1, reps))) * 1e3 / nodes
            return gpu_ms(graph.replay, max(1, reps)) * 1e3 / nodes
        finally:
            graph.close()
    chain()
    walls = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        chain()
        walls.append(time.perf_counter() - t0)
    return (statistics.median(walls) if stat == "median" else min(walls)) * 1e6 / nodes


def _step_call(width: int, payload: int, device):
    """(step, x): ONE single-step window-mode K3 launch over ``width`` rows
    (radius-1 three-point stencil, grain 1, the one-device wrap folded in),
    the launch and combine the halo plan issues at S = 1, and its state."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as _kops

    x = torch.zeros((1, width, payload), dtype=torch.float32, device=device)
    idx = torch.zeros((1, width, 1), dtype=torch.int32, device=device)
    wgt = torch.from_numpy(np.full((1, width, 3), 1.0 / 3.0, np.float32)).to(device)
    kw = dict(kind="compute_bound", iterations=1, scratch=2048, combine="window")
    return (lambda s: _kops.taskbench_step(s, idx, wgt, wrap=1, **kw)), x


def probe_launch_us(payload: int = 64, *, reps: int = 5, device=None,
                    nodes: int = LAUNCH_NODES) -> float:
    """Per-launch cost: K3 over LAUNCH_ROWS rows, too few for the body to
    matter, as one of ``nodes`` graph nodes."""
    step, x = _step_call(LAUNCH_ROWS, payload, _device(device))
    return _launch_us(step, x, nodes, reps)


def probe_row_step_us(payload: int = 64, *,
                      widths: Sequence[int] = ROW_WIDTHS,
                      reps: int = 5, device=None,
                      nodes: int = ROW_NODES) -> float:
    """Marginal cost of one working row advanced one depth: the
    least-squares slope of K3's per-launch wall over ``widths``, floored at
    `row_step_floor_us` (a slope at or under it is noise)."""
    dev = _device(device)
    reps = max(reps, 3)  # the slope is a difference of walls
    ws = sorted(set(int(w) for w in widths))
    ts = [_launch_us(*_step_call(w, payload, dev), nodes, reps) for w in ws]
    n = len(ws)
    mw, mt = sum(ws) / n, sum(ts) / n
    var = sum((w - mw) ** 2 for w in ws)
    slope = sum((w - mw) * (t - mt) for w, t in zip(ws, ts)) / var
    return max(row_step_floor_us(payload), slope)


def _probe_mesh(devices, device=None, count: Optional[int] = None):
    """The probe's `_halo.ShardMesh`: ``devices`` shards on the probes'
    device (a count), or on the devices named (a sequence); ``count``: the
    first ``count`` of them."""
    from repro_torch.core.runtimes import _halo

    if isinstance(devices, int):
        return _halo.ShardMesh([_device(device)] * (count or devices))
    devs = [_device(d) for d in devices]
    return _halo.ShardMesh(devs[:count or len(devs)])


def _device_count(devices) -> int:
    return devices if isinstance(devices, int) else len(devices)


def _sharded_wall_us(step: Callable, mesh, rows_per_device: int, payload: int,
                     reps: int, nodes: int, stat: str = "mean") -> float:
    """Wall of one ``step(shards)`` over D (rows, payload) f32 shards, as
    one of ``nodes`` chained steps in one CUDA graph on the card (each
    step's shard streams forked from the capture and joined back), host
    walls on the CPU (`_launch_us`, ``stat`` its aggregate)."""
    import torch

    xs = [torch.zeros((rows_per_device, payload), dtype=torch.float32, device=d)
          for d in mesh.devices]

    def one(shards):
        mesh.fork()
        out = step(shards)
        mesh.join()
        return out

    return _launch_us(one, xs, nodes, reps, device=mesh.devices[0], stat=stat)


def probe_halo_exchange_us(devices=1, payload: int = 64, *, depth: int = 8,
                           reps: int = 5, device=None,
                           nodes: int = LAUNCH_NODES) -> Dict[str, float]:
    """One deep ring exchange per HALO_ASYNC_IMPLS transport, started and
    joined, between ``devices`` row shards (a count: that many shards on
    the probes' device; or a sequence of devices) of max(2 * depth, 16)
    rows, ``depth`` rows each way. Fixed costs dominate at these sizes, so
    one depth stands in for all.

    On one device the exchange is a wrap of the state onto itself that
    launches nothing: the serial blocked launch reads the wrapped rows
    through ``halo_rows`` and the pipelined one takes the boundary phase's
    outputs as the next launch's halos (``pallas_step._pipelined_launch``),
    the first ones sliced from the state (``_prologue_exchange``). So it
    costs nothing: {"self": 0.0}."""
    from repro_torch.core.runtimes import _halo

    if isinstance(devices, int) and devices == 1:
        return {SELF_EXCHANGE: 0.0}
    mesh = _probe_mesh(devices, device)
    out: Dict[str, float] = {}
    for impl in sorted(_halo.HALO_ASYNC_IMPLS):
        def step(xs, impl=impl):
            _halo.exchange_edges_start(mesh, [x[:depth] for x in xs],
                                       [x[-depth:] for x in xs], impl=impl).join()
            return xs

        out[impl] = _sharded_wall_us(step, mesh, max(2 * depth, 16), payload, reps, nodes)
    return out


def probe_stride_exchange_us(devices=1, payload: int = 64, *, block: int = STRIDE_BLOCK,
                             reps: int = 5, device=None,
                             nodes: int = LAUNCH_NODES) -> Dict[str, float]:
    """One XOR block exchange (stride 1: shard d takes shard d XOR 1's
    block) per STRIDE_ASYNC_IMPLS transport, started and joined, between
    ``devices`` row shards (a count on the probes' device, or a sequence of
    devices) of ``block`` rows. {} below 2 devices (every stride is
    in-block there) and at device counts that are not powers of two (the
    transport refuses them), as the reference's."""
    from repro_torch.core.runtimes import _halo

    D = _device_count(devices)
    if D < 2 or D & (D - 1):
        return {}
    mesh = _probe_mesh(devices, device)
    out: Dict[str, float] = {}
    for impl in sorted(_halo.STRIDE_ASYNC_IMPLS):
        def step(xs, impl=impl):
            _halo.exchange_stride_start(mesh, xs, (1,), impl=impl).join()
            return xs

        out[impl] = _sharded_wall_us(step, mesh, block, payload, reps, nodes)
    return out


def _gather_wall_us(mesh, width: int, payload: int, reps: int, nodes: int, *,
                    impl: str = "xla", group: Optional[int] = None,
                    stat: str = "mean") -> float:
    """Wall of one ``gather_global`` of a (width, payload) state over
    ``mesh``'s shards, joined: every shard's global-order buffer made."""
    from repro_torch.core.runtimes import _halo

    def step(xs):
        _halo.gather_global_start(mesh, xs, impl=impl, chunk_group=group).join()
        return xs

    return _sharded_wall_us(step, mesh, width // mesh.size, payload, reps, nodes, stat)


def probe_gather_us(devices=1, payload: int = 64, *,
                    widths: Sequence[int] = GATHER_WIDTHS, reps: int = 5,
                    device=None, nodes: int = LAUNCH_NODES) -> Dict[int, float]:
    """The all-gather plan's gather (the default "xla" transport) per
    width, between ``devices`` row shards; widths that D does not divide
    are skipped, as the plan never runs them. On one device the gathered
    buffer is the state itself (the plan gathers nothing): 0.0 at each
    width."""
    D = _device_count(devices)
    ws = sorted(set(int(w) for w in widths))
    if D == 1:
        return {w: 0.0 for w in ws}
    mesh = _probe_mesh(devices, device)
    return {w: _gather_wall_us(mesh, w, payload, reps, nodes)
            for w in ws if w >= D and w % D == 0}


def _gather_probe_device_counts(devices: int) -> Tuple[int, ...]:
    """The devices-dimension grid: the calibration count and its /2 and /4
    where they divide it (meshes over a prefix of the same devices), all
    >= 2."""
    counts = []
    for d in (devices, devices // 2, devices // 4):
        if d >= 2 and devices % d == 0 and d not in counts:
            counts.append(d)
    return tuple(counts)


def _chunk_group_candidates(devices: int) -> Tuple[int, ...]:
    """The proper divisors 1 < G < D: every grouping the chunked gather runs
    without falling back to the monolithic one."""
    return tuple(g for g in range(2, devices) if devices % g == 0)


def probe_gather_impl_us(devices=1, payload: int = 64, *,
                         widths: Sequence[int] = GATHER_WIDTHS,
                         impls: Sequence[str] = ("xla", "chunked"),
                         device_counts: Optional[Sequence[int]] = None,
                         reps: int = GATHER_IMPL_REPS,
                         chunk_groups: Union[str, Sequence[int], None] = "auto",
                         device=None, nodes: int = LAUNCH_NODES,
                         ) -> Dict[str, Dict[int, Dict[int, float]]]:
    """``gather_global``'s wall per (transport, device count, width): the
    table behind `schedule.choose_gather_impl`, the median of ``reps``
    replays. Each count of ``device_counts`` (default
    `_gather_probe_device_counts`) runs on the first that many shards;
    widths a count does not divide are skipped for it, and so is "chunked"
    where it falls back to the monolithic gather (the analytic group 1 or
    D), so the table never ranks a transport against itself.

    ``chunk_groups`` adds the chunked transport's grouping rows under
    pseudo-transport keys "chunked:g{G}" (`schedule.choose_gather_chunk_group`
    ranks them; `choose_gather_impl` leaves them out): "auto" probes every
    proper divisor of each count, a sequence its members that divide it,
    None none; a count with fewer than two groupings has nothing to rank
    and is skipped."""
    from repro_torch.core.runtimes import _halo

    for impl in impls:
        if impl not in _halo.GATHER_IMPLS:
            raise ValueError(
                f"unknown gather impl {impl!r}; known {sorted(_halo.GATHER_IMPLS)}")
    D = _device_count(devices)
    counts = tuple(device_counts) if device_counts is not None \
        else _gather_probe_device_counts(D)
    out: Dict[str, Dict[int, Dict[int, float]]] = {}

    def measure(key, impl, mesh, width, group=None):
        us = _gather_wall_us(mesh, width, payload, reps, nodes, impl=impl, group=group,
                             stat="median")
        out.setdefault(key, {}).setdefault(mesh.size, {})[width] = us

    for d in counts:
        mesh = _probe_mesh(devices, device, count=d)
        ws = [w for w in sorted(set(int(w) for w in widths)) if w >= d and w % d == 0]
        for impl in impls:
            if impl == "chunked" and _halo.gather_chunk_group(d) in (1, d):
                continue  # the monolithic gather at this count
            for w in ws:
                measure(impl, impl, mesh, w)
        if chunk_groups is None or "chunked" not in impls:
            continue
        groups = _chunk_group_candidates(d) if chunk_groups == "auto" else tuple(
            int(g) for g in chunk_groups if 1 < int(g) < d and d % int(g) == 0)
        if len(groups) < 2:
            continue
        for g in groups:
            for w in ws:
                measure(f"chunked:g{g}", "chunked", mesh, w, group=g)
    return out


def run_probes(devices: Optional[int] = None, payload: int = 64, *,
               reps: int = 5, smoke: bool = False, device=None) -> CostModel:
    """All probes -> one measured CostModel (not yet persisted), on the card
    unless ``device="cpu"`` (the plain path, for the tests), over
    ``devices`` row shards of it (default 1). ``smoke`` shrinks reps,
    widths and graph lengths, and probes the gather transports at the
    calibration count alone (a full run adds its /2 and /4); the schema and
    the derivation are identical."""
    dev = _device(device)
    devices = 1 if devices is None else int(devices)
    row_widths, nodes = ROW_WIDTHS, (LAUNCH_NODES, ROW_NODES)
    impl_reps = max(reps, GATHER_IMPL_REPS)
    if smoke:
        reps = min(reps, 3)
        row_widths, nodes = SMOKE_ROW_WIDTHS, (SMOKE_NODES, SMOKE_NODES)
        impl_reps = max(reps, 5)
    launch = probe_launch_us(payload, reps=reps, device=dev, nodes=nodes[0])
    row_step = probe_row_step_us(payload, widths=row_widths, reps=reps,
                                 device=dev, nodes=nodes[1])
    halo = probe_halo_exchange_us(devices, payload, reps=reps, device=dev, nodes=nodes[0])
    stride = probe_stride_exchange_us(devices, payload, reps=reps, device=dev,
                                      nodes=nodes[0])
    gather = probe_gather_us(devices, payload, reps=reps, device=dev, nodes=nodes[0])
    gather_impl = probe_gather_impl_us(
        devices, payload, device_counts=(devices,) if smoke else None, reps=impl_reps,
        device=dev, nodes=nodes[0]) if devices >= 2 else {}
    # The covers/pays-off unit: one exchange in row-steps. Tested for a
    # measurement, not for truth: a measured 0.0 exchange gives X = 1.
    exch = halo.get("xla", min(halo.values()) if halo else None)
    x = (exch / row_step) if exch is not None else float(
        _schedule.PIPELINE_EXCHANGE_ROW_STEPS)
    return CostModel(
        source="measured",
        exchange_row_steps=float(max(1.0, x)),
        launch_us=float(launch),
        row_step_us=float(row_step),
        halo_exchange_us={k: float(v) for k, v in halo.items()},
        stride_exchange_us={k: float(v) for k, v in stride.items()},
        gather_us={k: float(v) for k, v in gather.items()},
        gather_impl_us={impl: {d: {w: float(us) for w, us in curve.items()}
                               for d, curve in by_d.items()}
                        for impl, by_d in gather_impl.items()},
        platform=_platform(dev),
        devices=devices,
        payload=int(payload),
    )


# ---------------------------------------------------------------------- CLI


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Calibrate on the card (or the CPU) and persist."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="row shards of the one device to calibrate for (the |dD| entry)")
    ap.add_argument("--payload", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grids and reps (the CPU tests' sizes)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(DEFAULT_CACHE_PATH),
                    help="cache file to merge into ('-' = don't persist)")
    ap.add_argument("--json", action="store_true",
                    help="print the model as JSON on stdout")
    args = ap.parse_args(argv)
    model = run_probes(devices=args.devices, payload=args.payload, reps=args.reps,
                       smoke=args.smoke, device=args.device)
    if args.out != "-":
        path = save_cost_model(model, args.out)
        print(f"cost model [{model.cache_key()}] -> {path}")
    print(model.describe())
    if args.json:
        print(json.dumps(model.to_dict(), indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(main())
