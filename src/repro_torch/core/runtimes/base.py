"""Runtime backend ABC + timing harness.

Counterpart of ``repro.core.runtimes.base``. A *runtime* executes a
TaskGraph; each backend models one way of scheduling the same dataflow, and
all must produce the same final states (tests enforce cross-backend
allclose). The port has two backends so far:

  fused        timestep loop: combine + body per step
  pallas_step  one megakernel launch per timestep (or per S timesteps)

Each backend writes its run as an eager loop (``_build_eager``). On the
card ``build`` captures that loop as one CUDA graph (``_capture.GraphRun``,
the counterpart of the reference's ``jax.jit`` of a whole run), so a run is
one host call; on the CPU it returns the eager loop. A capture that fails
raises: nothing falls back to the eager loop on the card.

Runtimes run on the card (``device="cuda"``, the default) unless the caller
asks for the CPU; with no card they raise rather than run on the CPU. Not
ported yet (ROADMAP.md): the ``trace=`` option, ``EnsembleLaunchPlan`` and
the ensemble methods.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import TaskGraph
from repro_torch.core.metg import GrainSample
from repro_torch.core.runtimes._capture import GraphRun, time_runs
from repro_torch.core.task_kernels import initial_state, state_from_reference


@dataclasses.dataclass(frozen=True)
class TimingStats:
    best: float
    mean: float
    walls: Tuple[float, ...]
    dispatches: int  # device launches for one graph execution
    #: seconds to capture and instantiate the run's graph (one replay a
    #: run), and its node count; None for the eager loop on the CPU
    capture_s: Optional[float] = None
    graph_nodes: Optional[int] = None


class Runtime(abc.ABC):
    """Executes task graphs under one scheduling strategy on one device."""

    #: registry name; subclasses set this
    name: str = "abstract"
    #: options this backend reads; any other option raises
    known_options: Tuple[str, ...] = ()

    def __init__(self, device="cuda", **options):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"runtime {self.name}: no CUDA device is available; pass "
                    f"device='cpu' to run the plain versions on the CPU")
        elif self.device.type != "cpu":
            raise ValueError(f"runtime {self.name}: unsupported device {self.device}")
        unknown = sorted(set(options) - set(self.known_options))
        if unknown:
            raise ValueError(
                f"runtime {self.name}: unknown options {unknown}; known "
                f"{list(self.known_options)}")
        self.options = options

    @property
    def cores(self) -> int:
        """Parallel workers METG's granularity is taken over: the card's
        SMs (an SM takes the place of the paper's core), 1 on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_properties(self.device).multi_processor_count
        return 1

    # -- capabilities ------------------------------------------------------

    def supports(self, graph: TaskGraph) -> Tuple[bool, str]:
        """Whether this backend can run the graph (and why not, if not)."""
        return True, ""

    def _require_support(self, graph: TaskGraph) -> None:
        ok, why = self.supports(graph)
        if not ok:
            raise ValueError(f"runtime {self.name} cannot run {graph.describe()}: {why}")

    # -- execution ---------------------------------------------------------

    @abc.abstractmethod
    def _build_eager(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        """The run as an eager loop: initial (W, payload) state on the
        device -> final state, every operation issued from the host."""

    def build(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        """An executor: initial (W, payload) state on the device -> final
        state. On the card, the eager loop captured as one CUDA graph
        (`GraphRun`: ``stage(x)`` then ``replay()``, or a call); on the
        CPU, the eager loop."""
        self._require_support(graph)
        eager = self._build_eager(graph)
        if self.device.type != "cuda":
            return eager
        return GraphRun(eager, torch.zeros((graph.width, graph.payload),
                                           dtype=torch.float32, device=self.device))

    def dispatches_per_run(self, graph: TaskGraph) -> int:
        """Device launches for one execution (overhead model)."""
        return 1

    def _init(self, graph: TaskGraph, init) -> torch.Tensor:
        if init is None:
            return initial_state(graph.width, graph.payload, graph.seed, self.device)
        if isinstance(init, torch.Tensor):
            return init.to(self.device, torch.float32)
        return state_from_reference(init, self.device)

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
        graphed = isinstance(fn, GraphRun)
        stats = TimingStats(
            best=min(walls),
            mean=sum(walls) / len(walls),
            walls=tuple(walls),
            dispatches=self.dispatches_per_run(graph),
            capture_s=fn.capture_s if graphed else None,
            graph_nodes=fn.nodes if graphed else None,
        )
        sample = GrainSample(
            iterations=graph.kernel.iterations,
            wall_time=stats.best,
            total_flops=float(graph.total_flops()),
            num_tasks=graph.num_tasks,
            cores=self.cores,
        )
        return sample, stats


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
