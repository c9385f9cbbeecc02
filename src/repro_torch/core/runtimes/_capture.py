"""A run of the port captured as one CUDA graph: the counterpart of the
reference's ``jax.jit``.

The reference compiles each whole Task Bench run and each decode step into
one XLA program. Here the eager loop that issues that work is captured once
into a ``torch.cuda.CUDAGraph`` and replayed: one host call per run in place
of one per operation.

`Graphed` captures a function of no arguments that reads and writes static
tensors (the decode step). `GraphRun` captures a runtime's eager loop
``eager(init) -> final`` on a static input: it warms up once, eagerly, on a
side stream, then captures the loop there; ``stage(x)`` copies ``x`` into
the static input and ``replay()`` runs the graph and returns a clone of the
static output. A failed capture raises: nothing falls back to the eager
loop. Launch counters (``kernels/_build.py``): the warm-up and the capture
count as build launches, and each replay adds the capture's launches to
the run counters. Dropping either object frees its graph and memory pool.
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable, List, Sequence

import torch

from repro_torch.kernels import _build


def node_count(graph: "torch.cuda.CUDAGraph") -> int:
    """Nodes of a captured graph kept with ``keep_graph=True`` (CUDA's
    ``cuGraphGetNodes``)."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    return n.value


class Graphed:
    """``fn()`` captured as one CUDA graph on ``stream`` (the stream it was
    warmed up on), with ``generators`` registered so that a replay draws
    fresh random numbers from them. ``out`` is what ``fn`` returned at
    capture: static tensors that each `replay` rewrites. ``capture_s`` is
    the capture and instantiation time, ``nodes`` the graph's node count,
    ``launches`` the port's kernel launches per replay."""

    def __init__(self, fn: Callable[[], object], stream: "torch.cuda.Stream",
                 generators: Sequence[torch.Generator] = ()):
        self.graph = None
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        with _build.building() as launches:
            with torch.cuda.graph(graph, stream=stream):
                self.out = fn()
        graph.instantiate()
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        self.nodes = node_count(graph)
        self.launches = launches
        _build.captured()

    def replay(self):
        """Run the graph (enqueued on the current stream); returns ``out``."""
        self.graph.replay()
        _build.replayed(self.launches)
        return self.out

    def close(self) -> None:
        """Free the graph and its memory pool."""
        graph, self.graph, self.out = getattr(self, "graph", None), None, None
        if graph is not None:
            graph.reset()

    def __del__(self):
        self.close()


class GraphRun:
    """``eager(init) -> final`` captured on a static input shaped like
    ``example`` (on the card): ``stage(x)``, then ``replay()``; or call it
    with ``x`` for both. ``eager`` stays reachable, the loop the graph
    records."""

    def __init__(self, eager: Callable[[torch.Tensor], torch.Tensor],
                 example: torch.Tensor):
        self.eager = eager
        dev = example.device
        self.static_in = example.clone()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with _build.building(), torch.cuda.stream(stream):
            eager(self.static_in)  # the warm-up, not counted as a run
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graphed = Graphed(lambda: eager(self.static_in), stream)

    @property
    def capture_s(self) -> float:
        return self.graphed.capture_s

    @property
    def nodes(self) -> int:
        return self.graphed.nodes

    def stage(self, x: torch.Tensor) -> None:
        self.static_in.copy_(x)

    def replay(self) -> torch.Tensor:
        return self.graphed.replay().clone()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.stage(x)
        return self.replay()

    def close(self) -> None:
        self.graphed.close()


def time_runs(run: Callable, x: torch.Tensor, *, reps: int, warmup: int = 1
              ) -> List[float]:
    """Host seconds of each of ``reps`` runs of ``run`` (a `GraphRun`, or an
    eager loop) on fresh copies of ``x``: each copy is staged outside the
    timed region, which holds the run and a device synchronize;
    ``max(warmup, 1)`` untimed runs first."""
    if isinstance(run, GraphRun):
        stage, replay = run.stage, run.replay
    else:
        held: List[torch.Tensor] = []

        def stage(x):
            held[:] = [x.clone()]

        def replay():
            return run(held[0])

    def sync():
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    for _ in range(max(warmup, 1)):
        stage(x)
        replay()
    walls: List[float] = []
    for _ in range(reps):
        stage(x)
        sync()
        t0 = time.perf_counter()
        replay()
        sync()
        walls.append(time.perf_counter() - t0)
    return walls
