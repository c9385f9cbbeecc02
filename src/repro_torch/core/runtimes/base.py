"""Runtime backend ABC + timing harness.

Counterpart of ``repro.core.runtimes.base``. A *runtime* executes a
TaskGraph; each backend models one way of scheduling the same dataflow, and
all must produce the same final states (tests enforce cross-backend
allclose). The six backends of the paper's overhead ladder, and how each
dispatches a run:

  fused        the whole run one program: combine + body per step (OpenMP)
  serialized   one host call per task (the AMT worst case: per-task spawn)
  bsp          one host call per superstep: exchange + compute (MPI)
  bsp_scan     bsp with the timestep loop in one program (amortised MPI)
  overlap      bsp_scan's loop with each step split into interior and
               boundary work, overdecomposed (Charm++/HPX)
  pallas_step  one megakernel launch per timestep (or per S timesteps): the
               METG floor

Each backend writes its run as an eager loop (``_build_eager``). On the
card ``build`` captures that loop as one CUDA graph (``_capture.GraphRun``,
the counterpart of the reference's ``jax.jit`` of a whole run), so a run is
one host call; on the CPU it returns the eager loop. ``bsp`` captures one
graph per distinct superstep instead and replays them from a host loop
(``_capture.ReplayLoop``), and ``serialized`` stays eager: each task is its
own host call. A capture that fails raises: nothing falls back to the eager
loop on the card. ``dispatches_per_run`` counts the device operations a run
issues, ``host_calls_per_run`` the host calls that issue them.

Ensembles (`GraphEnsemble`, Task Bench's ``-and``) run the same way: each
backend writes an ensemble's run as an eager loop over a tuple of member
states (``_build_ensemble_eager``), and ``build_ensemble`` captures it as one
CUDA graph on the card. `EnsembleLaunchPlan` is the host-steppable form of
an ensemble run, one launch per call (``build_ensemble_launches``; only
``pallas_step`` has one).

Runtimes run on the card (``device="cuda"``, the default) unless the caller
asks for the CPU; with no card they raise rather than run on the CPU.

Row shards (``devices=``, the reference's option): a sequence of D devices,
which may name one card D times; the default is ``[device]``. Shard d owns
rows [d*B, (d+1)*B) with B = W / D, as its own tensor on ``devices[d]``,
computing on its own stream, and reads other shards' rows only through the
transports of ``_halo`` (`_halo.ShardMesh`). ``bsp``, ``bsp_scan``,
``overlap`` and ``pallas_step`` run sharded; ``fused`` and ``serialized``
are one program or one host call a task by design and take one device.
``execute`` and ``measure`` still take and give the global (W, payload)
state: at D > 1 ``build`` returns a `_capture.ShardedRun`, which splits the
state into the shards (``stage``) and gathers the output (``replay``). Where
the shards sit on one card the shards' run is captured as on one device
(one CUDA graph, or ``bsp``'s graph a superstep); where they sit on
distinct cards a capture would span devices, so the shards' run is the
eager loop (`ShardedRun` over it), every operation issued from the host.

Tracing (the reference's ``trace=`` option; ``repro_torch.obs``): every
backend takes ``trace=`` (None or False: the shared ``NULL_TRACER``, which
records nothing; True, "on" or 1: a fresh ``Tracer``; or a tracer to share)
and ``trace_probe_reps`` (pallas_step's phase probes, 16 by default).
``trace_once`` runs the traced twin of the run (``_build_traced``): the
eager loop's operations, issued from the host, with a device synchronize at
each span's end (at D > 1 every shard's device), so the spans attribute the
wall to dispatch, exchange, gather and compute; it never captures a graph,
and ``build``, ``measure`` and their launch accounting do not read the
tracer. Its warm-up run counts as a build (``_build.BUILD_LAUNCHES``), so a
trace's delta of the launch counters is one traced run's.

Resilience (``repro_torch.resilience``): ``execute_ensemble_resilient`` runs
an ensemble's launch plan under the resilience engine, which detects,
retries and replays at launch boundaries; a backend without a launch plan
recovers by whole-run restart (``checkpoint.elastic.run_with_restarts``).
"""
from __future__ import annotations

import abc
import contextlib
import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import GraphEnsemble, TaskGraph
from repro_torch.core.metg import GrainSample, combine_grain_samples
from repro_torch.core.runtimes import _halo
from repro_torch.core.runtimes._capture import GraphRun, ShardedRun, time_runs
from repro_torch.core.task_kernels import initial_state, state_from_reference
from repro_torch.kernels import _build
from repro_torch.obs import coerce_tracer

#: Options every backend reads: the tracer and pallas_step's probe depth.
TRACE_OPTIONS = ("trace", "trace_probe_reps")


@dataclasses.dataclass(frozen=True)
class TimingStats:
    best: float
    mean: float
    walls: Tuple[float, ...]
    dispatches: int  # device launches for one graph execution
    #: seconds to capture and instantiate the run's graph (one replay a
    #: run), and its node count (summed over ``bsp``'s superstep graphs);
    #: None for an eager loop
    capture_s: Optional[float] = None
    graph_nodes: Optional[int] = None
    #: host calls that issue one run (``Runtime.host_calls_per_run``)
    host_calls: Optional[int] = None


@dataclasses.dataclass
class EnsembleLaunchPlan:
    """A host-steppable launch schedule for one ensemble run.

    Counterpart of the reference's ``EnsembleLaunchPlan``: the launch
    boundaries of an ensemble run, visible to the host, for the resilience
    engine (``resilience.engine``) and the serving fabric
    (``serving.fabric``), which detect, retry, replay, evict or admit at a
    boundary. Every ``launch_fn`` call is a deterministic
    function of (carry, act row), so a replay from the pre-launch carry
    gives the same bits. ``acts`` is the host (L, K, S) activity schedule;
    a caller edits its own copy to evict a member (zero its (K, S) slot from
    the eviction launch on) or to re-admit a fresh one into a freed slot.
    """

    #: lockstep timesteps advanced per launch (the blocked cadence)
    steps_per_launch: int
    #: each member's own horizon T_k
    member_steps: Tuple[int, ...]
    #: (L, K, S) float32 per-depth activity masks, on the host
    acts: np.ndarray
    #: per-member initial states (a sequence of tensors on the runtime's
    #: device) -> carry (the t = 0 body-only launch)
    init_fn: Callable[[Sequence[torch.Tensor]], Any]
    #: (carry, act row (K, S) numpy array, launch's first lockstep timestep)
    #: -> next carry; a stacked plan also takes the act row as a float32
    #: tensor already on the card, which it reads there (a caller that
    #: stages the rows ahead keeps the host-to-card copy out of the launch)
    launch_fn: Callable[[Any, np.ndarray, int], Any]
    #: carry -> tuple of per-member (W_k, P_k) final states
    finalize: Callable[[Any], Tuple[torch.Tensor, ...]]
    #: (carry, slot, init state) -> carry with the slot's rows replaced by
    #: the fresh member's t = 0 state (re-admission); None where the
    #: schedule cannot replace rows in place
    admit_fn: Optional[Callable[[Any, int, torch.Tensor], Any]] = None
    #: the cost model's expected wall per launch
    #: (`schedule.expected_launch_wall_us`): a number under a measured model,
    #: None under the analytic one (a deadline detector then self-calibrates)
    expected_launch_us: Optional[float] = None
    #: "stacked" or "stepwise"
    kind: str = ""
    #: zero-argument callable giving the CUDA graphs captured so far
    #: (``_build.CAPTURES``): editing ``acts`` or admitting a member must
    #: not make it grow (no re-capture under membership churn)
    compile_counter: Optional[Callable[[], int]] = None
    #: where ``launch_fn`` reads its act rows (`act_rows`): the runtime's
    #: device for a stacked plan; None for a stepwise one (host arrays)
    act_device: Optional[torch.device] = None
    #: whether one launch is one CUDA graph replay, the work the cost model
    #: prices; an eagerly issued launch (the stepwise plan, row shards over
    #: several cards, the CPU) also pays the host's issue of each operation
    replayed: bool = False

    @property
    def num_launches(self) -> int:
        return int(self.acts.shape[0])

    @property
    def deadline_expected_us(self) -> Optional[float]:
        """The expected wall a deadline holds one host-stepped launch to:
        ``expected_launch_us`` where a launch is one replay; None where it
        is issued eagerly, which the model does not price (a
        `DeadlineDetector` then self-calibrates from the observed walls)."""
        return self.expected_launch_us if self.replayed else None

    def launch_t0(self, launch: int) -> int:
        """First lockstep timestep executed by launch ``launch``."""
        return 1 + launch * self.steps_per_launch

    def act_rows(self, acts: Optional[np.ndarray] = None) -> "ActRows":
        """The rows of ``acts`` (the plan's own by default; a caller's
        edited copy) staged as ``launch_fn`` reads them."""
        return ActRows(self.acts if acts is None else acts, self.act_device)


class ActRows:
    """A launch plan's act rows as its ``launch_fn`` reads them: on a device,
    rows of a float32 table staged there in one copy, so no host-to-card
    copy lands inside a launch; without one, host arrays. ``edited()``
    after a change to ``acts`` (an eviction, an admission, a longer
    horizon) stages the table again at the next row asked for."""

    def __init__(self, acts: np.ndarray, device: Optional[torch.device]):
        self.acts, self.device = acts, device
        self._table: Optional[torch.Tensor] = None

    def edited(self, acts: Optional[np.ndarray] = None) -> None:
        if acts is not None:
            self.acts = acts
        self._table = None

    def __getitem__(self, launch: int):
        if self.device is None:
            return np.array(self.acts[launch], dtype=np.float32, copy=True)
        if self._table is None:
            self._table = torch.tensor(self.acts, dtype=torch.float32, device=self.device)
        return self._table[launch]


class Runtime(abc.ABC):
    """Executes task graphs under one scheduling strategy on one device."""

    #: registry name; subclasses set this
    name: str = "abstract"
    #: options this backend reads; any other option raises
    known_options: Tuple[str, ...] = ()
    #: whether the backend runs over row shards (``devices`` of more than one)
    sharded: bool = False

    def __init__(self, device="cuda", devices: Optional[Sequence] = None, **options):
        devices = [device] if devices is None else list(devices)
        if not devices:
            raise ValueError(f"runtime {self.name}: devices is empty")
        for dev in devices:
            dev = torch.device(dev)
            if dev.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        f"runtime {self.name}: no CUDA device is available; pass "
                        f"device='cpu' to run the plain versions on the CPU")
            elif dev.type != "cpu":
                raise ValueError(f"runtime {self.name}: unsupported device {dev}")
        if len({torch.device(d).type for d in devices}) != 1:
            raise ValueError(f"runtime {self.name}: mixed device types {devices}")
        if len(devices) > 1 and not self.sharded:
            raise ValueError(
                f"runtime {self.name} runs on one device; got {len(devices)} "
                f"(the sharded backends are bsp, bsp_scan, overlap, pallas_step)")
        #: the row mesh over ``devices`` (None on one device)
        self.mesh = _halo.ShardMesh(devices) if len(devices) > 1 else None
        self.devices = list(self.mesh.devices) if self.mesh else [torch.device(devices[0])]
        self.device = self.devices[0]
        known = self.known_options + TRACE_OPTIONS
        unknown = sorted(set(options) - set(known))
        if unknown:
            raise ValueError(
                f"runtime {self.name}: unknown options {unknown}; known {list(known)}")
        self.options = options
        #: the span recorder `trace_once` writes into (the ``trace=``
        #: option; by default the shared NULL_TRACER): `build` and
        #: `measure` never read it
        self.tracer = coerce_tracer(options.get("trace"))

    @property
    def num_devices(self) -> int:
        """D, the row shards the points are block-distributed over."""
        return len(self.devices)

    def _block(self, graph: TaskGraph) -> int:
        return graph.width // self.num_devices

    @property
    def cores(self) -> int:
        """Parallel workers METG's granularity is taken over: the card's
        SMs (an SM takes the place of the paper's core), summed over the
        distinct cards the shards sit on; 1 on the CPU."""
        if self.device.type == "cuda":
            return sum(torch.cuda.get_device_properties(d).multi_processor_count
                       for d in dict.fromkeys(self.devices))
        return 1

    # -- row shards --------------------------------------------------------

    def _split(self, x, devices: Optional[Sequence[torch.device]] = None):
        """The global (W, payload) state, or an ensemble's tuple of them, as
        separate shard tensors over ``devices`` (default the D row shards'):
        shard d a copy of rows [d*B, (d+1)*B) on ``devices[d]``."""
        if not isinstance(x, torch.Tensor):
            return tuple(self._split(m, devices) for m in x)
        devices = self.devices if devices is None else devices
        B = x.shape[0] // len(devices)
        return tuple(x.narrow(0, d * B, B).to(dev, copy=True)
                     for d, dev in enumerate(devices))

    def _gather(self, shards):
        """The inverse of `_split`: the shards concatenated on ``device``."""
        if not isinstance(shards[0], torch.Tensor):
            return tuple(self._gather(m) for m in shards)
        return torch.cat([s.to(self.device) for s in shards])

    def _on(self, d: int, mesh: Optional[_halo.ShardMesh] = None):
        """A context in which shard d's work is issued (its stream on
        ``mesh``, by default the row mesh)."""
        mesh = self.mesh if mesh is None else mesh
        return mesh.on(d) if mesh is not None else contextlib.nullcontext()

    def _map(self, fn: Callable, *lists, mesh: Optional[_halo.ShardMesh] = None) -> List:
        """``fn(d, *args)`` for each shard d, issued on shard d's stream (of
        ``mesh``, by default the row mesh)."""
        out = []
        for d, args in enumerate(zip(*lists)):
            with self._on(d, mesh):
                out.append(fn(d, *args))
        return out

    def _sharded_run(self, eager, example, split: Optional[Callable] = None):
        """At D > 1: the shards' eager loop ``eager`` over ``example``'s
        shard tuple(s), captured as one CUDA graph where every shard sits on
        one card and run eagerly on the CPU or across distinct cards,
        wrapped to take and give the global state (`ShardedRun`, splitting
        with ``split``, by default `_split`)."""
        inner = eager
        if self.device.type == "cuda" and self.mesh.one_card:
            inner = GraphRun(eager, example)
        return ShardedRun(inner, split or self._split, self._gather)

    def _zero_shards(self, graph: TaskGraph,
                     devices: Optional[Sequence[torch.device]] = None):
        devices = self.devices if devices is None else devices
        B = graph.width // len(devices)
        return tuple(torch.zeros((B, graph.payload), dtype=torch.float32, device=dev)
                     for dev in devices)

    def _member_devices(self, ensemble: GraphEnsemble) -> List[List[torch.device]]:
        """The devices each ensemble member's rows are split over at D > 1:
        every row shard's, unless the backend shards the members too."""
        return [self.devices] * len(ensemble.members)

    # -- capabilities ------------------------------------------------------

    def supports(self, graph: TaskGraph) -> Tuple[bool, str]:
        """Whether this backend can run the graph (and why not, if not)."""
        return True, ""

    def supports_ensemble(self, ensemble: GraphEnsemble) -> Tuple[bool, str]:
        """Whether this backend can run every member of the ensemble."""
        for i, g in enumerate(ensemble.members):
            ok, why = self.supports(g)
            if not ok:
                return False, f"member {i} ({g.describe()}): {why}"
        return True, ""

    def _require_support(self, graph: TaskGraph) -> None:
        ok, why = self.supports(graph)
        if not ok:
            raise ValueError(f"runtime {self.name} cannot run {graph.describe()}: {why}")

    def _require_ensemble_support(self, ensemble: GraphEnsemble) -> None:
        ok, why = self.supports_ensemble(ensemble)
        if not ok:
            raise ValueError(f"runtime {self.name} cannot run ensemble: {why}")

    # -- execution ---------------------------------------------------------

    @abc.abstractmethod
    def _build_eager(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        """The run as an eager loop: initial (W, payload) state on the
        device -> final state, every operation issued from the host; at D >
        1 a tuple of D shards -> a tuple of D shards (`_split`)."""

    def build(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        """An executor: initial (W, payload) state on the device -> final
        state. On the card, the eager loop captured as one CUDA graph
        (`GraphRun`: ``stage(x)`` then ``replay()``, or a call); on the
        CPU, the eager loop. At D > 1 a `ShardedRun` over the shards' run
        (see `_sharded_run`), which also takes and gives the global state."""
        self._require_support(graph)
        eager = self._build_eager(graph)
        if self.mesh is not None:
            return self._sharded_run(eager, self._zero_shards(graph))
        if self.device.type != "cuda":
            return eager
        return GraphRun(eager, torch.zeros((graph.width, graph.payload),
                                           dtype=torch.float32, device=self.device))

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Device launches for one execution (overhead model)."""
        return 1

    def host_calls_per_run(self, work) -> int:
        """Host calls that issue one run of ``work``, a `TaskGraph` or a
        `GraphEnsemble`: the reference's count of host dispatches. One for
        a backend whose run is one graph replay."""
        return 1

    @abc.abstractmethod
    def _build_ensemble_eager(
            self, ensemble: GraphEnsemble
    ) -> Callable[[Tuple[torch.Tensor, ...]], Tuple[torch.Tensor, ...]]:
        """The ensemble's run as an eager loop: one initial (W_k, payload_k)
        state per member on the device -> each member's final state. Member
        dataflows never mix; the backend decides only how members share
        launches."""

    def build_ensemble(
            self, ensemble: GraphEnsemble
    ) -> Callable[[Tuple[torch.Tensor, ...]], Tuple[torch.Tensor, ...]]:
        """An executor for K concurrent member graphs: a tuple of initial
        states -> a tuple of final states. On the card, the eager loop
        captured as one CUDA graph (a `GraphRun` over the tuple); on the
        CPU, the eager loop."""
        self._require_ensemble_support(ensemble)
        eager = self._build_ensemble_eager(ensemble)
        if self.mesh is not None:
            cols = self._member_devices(ensemble)
            return self._sharded_run(
                eager, tuple(self._zero_shards(g, c) for g, c in zip(ensemble.members, cols)),
                lambda xs: tuple(self._split(x, c) for x, c in zip(xs, cols)))
        if self.device.type != "cuda":
            return eager
        return GraphRun(eager, tuple(
            torch.zeros((g.width, g.payload), dtype=torch.float32, device=self.device)
            for g in ensemble.members))

    def ensemble_dispatches_per_run(self, ensemble: GraphEnsemble) -> int:
        """Device launches for one ensemble execution: by default every
        member's own, summed."""
        return sum(self.dispatches_per_run(g) for g in ensemble.members)

    def _init(self, graph: TaskGraph, init) -> torch.Tensor:
        if init is None:
            return initial_state(graph.width, graph.payload, graph.seed, self.device)
        if isinstance(init, torch.Tensor):
            return init.to(self.device, torch.float32)
        return state_from_reference(init, self.device)

    def _ensemble_inits(self, ensemble: GraphEnsemble,
                        inits=None) -> Tuple[torch.Tensor, ...]:
        """Each member's initial state on the device: the port's own
        `initial_state` by default, else ``inits`` (tensors or numpy arrays,
        e.g. the reference's), one per member."""
        members = ensemble.members
        if inits is None:
            inits = (None,) * len(members)
        elif len(inits) != len(members):
            raise ValueError(f"got {len(inits)} initial states for "
                             f"{len(members)} ensemble members")
        return tuple(self._init(g, x) for g, x in zip(members, inits))

    def execute(self, graph: TaskGraph, init=None) -> np.ndarray:
        """Build the run (on the card, capture its CUDA graph) and run it
        once, returning the final (width, payload) state.

        ``init`` may be a tensor or a numpy array (e.g. the reference's
        initial state); by default the port's own `initial_state`.
        """
        self._require_support(graph)
        x = self._init(graph, init)
        out = self.build(graph)(x)
        return out.cpu().numpy()

    def execute_ensemble(self, ensemble: GraphEnsemble,
                         inits=None) -> Tuple[np.ndarray, ...]:
        """Build the ensemble's run (on the card, capture its CUDA graph)
        and run all members once; returns each member's final state."""
        self._require_ensemble_support(ensemble)
        xs = self._ensemble_inits(ensemble, inits)
        outs = self.build_ensemble(ensemble)(xs)
        return tuple(o.cpu().numpy() for o in outs)

    def build_ensemble_launches(self, ensemble: GraphEnsemble) -> EnsembleLaunchPlan:
        """A host-steppable launch schedule (`EnsembleLaunchPlan`). A backend
        whose run is one opaque program has no launch boundaries to expose:
        fault recovery for it is whole-run restart (``checkpoint/elastic.py``).
        ``pallas_step`` overrides this."""
        raise NotImplementedError(
            f"runtime {self.name} has no launch-granular schedule; resilient "
            f"execution needs pallas_step (or whole-run restart via "
            f"checkpoint.elastic.run_with_restarts)")

    def execute_ensemble_resilient(self, ensemble: GraphEnsemble, *, plan=None,
                                   policy=None, inits=None):
        """Run the ensemble under the resilience engine
        (`resilience.run_resilient`), launch by launch from the host.

        ``plan`` is a `resilience.FaultPlan` (None: no injection; the
        engine's per-launch hook is one predicate check, so the no-fault
        path adds no work beyond the host-stepped dispatch). ``inits`` as
        for `execute_ensemble`. Returns a `resilience.ResilientResult`
        whose ``outputs`` match ``execute_ensemble``."""
        from repro_torch.resilience import run_resilient

        self._require_ensemble_support(ensemble)
        return run_resilient(self, ensemble, plan=plan, policy=policy, inits=inits)

    # -- tracing -----------------------------------------------------------

    def _drain(self) -> None:
        """Wait, on the host, until the work issued so far on every device
        of the run has finished (the end of a traced span): at D > 1 every
        shard's device (`_halo.ShardMesh.drain`); nothing on the CPU."""
        if self.mesh is not None:
            self.mesh.drain()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_traced(self, graph: TaskGraph) -> Callable:
        """The traced twin of the run: an executor over what the eager loop
        takes (the state, or at D > 1 its shard tuple) that records spans
        into ``self.tracer`` as it runs.

        Default (``fused``, ``bsp_scan``, ``overlap``, whose run is one
        graph replay with no host boundary inside): the eager loop under
        two run-level spans, ``run_dispatch`` (dispatch: the host issuing
        every operation) and ``device_drain`` (compute.interior: the wait
        for the device to finish what is still queued). The backends with
        host boundaries (``bsp``, ``serialized``, ``pallas_step``) override
        it with spans a step, a launch or a phase."""
        eager = self._build_eager(graph)
        tr = self.tracer
        dispatches = self.dispatches_per_run(graph)

        def run(x):
            with tr.span("run_dispatch", "dispatch", runtime=self.name,
                         dispatches=dispatches):
                out = eager(x)
            with tr.span("device_drain", "compute.interior", runtime=self.name):
                self._drain()
            return out

        return run

    def trace_once(self, graph: TaskGraph, init=None) -> np.ndarray:
        """Run the graph once recording spans, a separate execution from
        `measure` (the timed path stays untouched); returns the final
        (width, payload) state, as `execute` does, bit for bit.

        The traced executor runs once first as a warm-up (counted as a
        build, `_build.building`) and that run's spans are dropped, while
        the decision records made when it was built stay. The input is
        staged (at D > 1 split into the shards) and drained before the
        first span, and the output gathered after the last. With the null
        tracer this is `execute`."""
        tr = self.tracer
        if not tr.enabled:
            return self.execute(graph, init)
        self._require_support(graph)
        x = self._init(graph, init)
        fn = self._build_traced(graph)

        def staged():
            s = x.clone() if self.mesh is None else self._split(x)
            self._drain()
            return s

        mark = len(tr.spans)
        with _build.building():
            fn(staged())
        self._drain()
        del tr.spans[mark:]
        out = fn(staged())
        if self.mesh is not None:
            out = self._gather(out)
        return out.cpu().numpy()

    # -- measurement -------------------------------------------------------

    def measure(self, graph: TaskGraph, *, reps: int = 3, warmup: int = 1,
                init=None) -> Tuple[GrainSample, TimingStats]:
        """Timed execution -> a GrainSample for the METG machinery.

        Host clock around each run (on the card one graph replay), which
        ends in a device synchronize; the build, the warmup and each run's
        fresh input copy, staged as the reference's ``_fresh``, stay outside
        the timed region.
        """
        self._require_support(graph)
        x = self._init(graph, init)
        fn = self.build(graph)
        walls = time_runs(fn, x, reps=reps, warmup=warmup)
        stats = TimingStats(
            best=min(walls),
            mean=sum(walls) / len(walls),
            walls=tuple(walls),
            dispatches=self.dispatches_per_run(graph),
            capture_s=getattr(fn, "capture_s", None),
            graph_nodes=getattr(fn, "nodes", None),
            host_calls=self.host_calls_per_run(graph),
        )
        sample = GrainSample(
            iterations=graph.kernel.iterations,
            wall_time=stats.best,
            total_flops=float(graph.total_flops()),
            num_tasks=graph.num_tasks,
            cores=self.cores,
        )
        return sample, stats

    def _ensemble_sample(self, ensemble: GraphEnsemble, wall: float) -> GrainSample:
        """The members' samples folded into one at the ensemble's wall
        (`metg.combine_grain_samples`): FLOPs and tasks sum, the grain is
        the task-weighted mean."""
        return combine_grain_samples([
            GrainSample(iterations=g.kernel.iterations, wall_time=wall,
                        total_flops=float(g.total_flops()), num_tasks=g.num_tasks,
                        cores=self.cores)
            for g in ensemble.members], wall_time=wall)

    def measure_ensemble(self, ensemble: GraphEnsemble, *, reps: int = 3,
                         warmup: int = 1, inits=None) -> Tuple[GrainSample, TimingStats]:
        """Timed concurrent execution of all members -> one aggregate
        sample, so `compute_metg` runs unchanged on ensemble sweeps. Timed
        as `measure` times a single graph (on the card one graph replay of
        the whole ensemble)."""
        self._require_ensemble_support(ensemble)
        xs = self._ensemble_inits(ensemble, inits)
        fn = self.build_ensemble(ensemble)
        walls = time_runs(fn, xs, reps=reps, warmup=warmup)
        stats = TimingStats(
            best=min(walls), mean=sum(walls) / len(walls), walls=tuple(walls),
            dispatches=self.ensemble_dispatches_per_run(ensemble),
            capture_s=getattr(fn, "capture_s", None),
            graph_nodes=getattr(fn, "nodes", None),
            host_calls=self.host_calls_per_run(ensemble))
        return self._ensemble_sample(ensemble, stats.best), stats

    def measure_launch_plan(self, ensemble: GraphEnsemble, *, reps: int = 3,
                            warmup: int = 1) -> Tuple[GrainSample, TimingStats]:
        """Timed host-stepped execution of ``build_ensemble_launches``: the
        init launch, then each launch followed by a device synchronize, the
        cadence of the resilience engine and the serving loop."""
        self._require_ensemble_support(ensemble)
        lp = self.build_ensemble_launches(ensemble)
        xs = self._ensemble_inits(ensemble)
        acts = np.asarray(lp.acts, dtype=np.float32)

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def run_once():
            carry = lp.init_fn(tuple(x.clone() for x in xs))
            sync()
            for l in range(lp.num_launches):
                carry = lp.launch_fn(carry, acts[l], lp.launch_t0(l))
                sync()
            return lp.finalize(carry)

        for _ in range(max(warmup, 1)):
            run_once()
        walls: List[float] = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run_once()
            walls.append(time.perf_counter() - t0)
        stats = TimingStats(best=min(walls), mean=sum(walls) / len(walls),
                            walls=tuple(walls), dispatches=1 + lp.num_launches)
        return self._ensemble_sample(ensemble, stats.best), stats


# ----------------------------------------------------------------- registry

_REGISTRY: dict = {}


def register(cls):
    _REGISTRY[cls.name] = cls
    return cls


def get_runtime(name: str, **kwargs) -> Runtime:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown runtime {name!r}; known: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)


def available_runtimes() -> List[str]:
    return sorted(_REGISTRY)
