"""Runtime backend ABC + timing harness.

Counterpart of ``repro.core.runtimes.base``. A *runtime* executes a
TaskGraph; each backend models one way of scheduling the same dataflow, and
all must produce the same final states (tests enforce cross-backend
allclose). The port has two backends so far:

  fused        eager timestep loop: combine + body per step
  pallas_step  one megakernel launch per timestep

Runtimes run on the card (``device="cuda"``, the default) unless the caller
asks for the CPU; with no card they raise rather than run on the CPU. Not
ported yet (ROADMAP.md): the ``trace=`` option, ``EnsembleLaunchPlan`` and
the ensemble methods.
"""
from __future__ import annotations

import abc
import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import TaskGraph
from repro_torch.core.metg import GrainSample
from repro_torch.core.task_kernels import initial_state, state_from_reference


@dataclasses.dataclass(frozen=True)
class TimingStats:
    best: float
    mean: float
    walls: Tuple[float, ...]
    dispatches: int  # device launches for one graph execution


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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
    def build(self, graph: TaskGraph) -> Callable[[torch.Tensor], torch.Tensor]:
        """An executor: initial (W, payload) state on the device -> final state."""

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
        """Run the graph once, returning the final (width, payload) state.

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

        Host clock around each run, which ends in a device synchronize; the
        warmup and each run's fresh input copy stay outside the timed region.
        """
        self._require_support(graph)
        x = self._init(graph, init)
        fn = self.build(graph)
        for _ in range(max(warmup, 1)):
            fn(x.clone())
        self._sync()
        walls: List[float] = []
        for _ in range(reps):
            arg = x.clone()
            self._sync()
            t0 = time.perf_counter()
            fn(arg)
            self._sync()
            walls.append(time.perf_counter() - t0)

        stats = TimingStats(
            best=min(walls),
            mean=sum(walls) / len(walls),
            walls=tuple(walls),
            dispatches=self.dispatches_per_run(graph),
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
