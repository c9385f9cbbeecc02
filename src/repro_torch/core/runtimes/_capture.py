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
static output. An ensemble's loop takes and returns a tuple of member
states: its static input is a tuple, ``stage`` copies each member's state
and ``replay`` returns a tuple of clones. A failed capture raises: nothing
falls back to the eager loop. Launch counters (``kernels/_build.py``): the warm-up and the capture
count as build launches, and each replay adds the capture's launches to
the run counters. Dropping either object frees its graph and memory pool.

`HostLoop` and `ReplayLoop` are the run of a backend that pays one host call
per superstep (``bsp``, the counterpart of the reference's ``jax.jit`` call
per step): a host loop over programs, zero-argument callables that read and
write static state buffers. `HostLoop` calls the programs eagerly;
`ReplayLoop` captures each program once as its own CUDA graph and replays
them in the loop's order, one replay a host call.

A run over D row shards (``Runtime(devices=...)``) takes and gives a tuple of
D shard tensors, or per ensemble member such a tuple: the states nest, and
``stage``, ``replay`` and ``clone_states`` follow the nesting. Where every
shard sits on one card the loop forks the shards' streams from the capturing
stream and joins them back, so one capture records the D shards as parallel
branches. `ShardedRun` wraps such a run so that it takes and gives the
global state: ``stage(x)`` splits x into the shards, ``replay()`` gathers
the output.
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

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


#: One state, or a tuple of states (an ensemble's members, a run's shards,
#: or an ensemble's members' shards).
States = Union[torch.Tensor, Tuple["States", ...]]


def clone_states(x: States) -> States:
    """A copy of a state, or of each state of a (nested) tuple."""
    return x.clone() if isinstance(x, torch.Tensor) else tuple(clone_states(t) for t in x)


def copy_states(dst: States, src: States) -> None:
    """``dst.copy_(src)`` for a state or each state of a (nested) tuple."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    if len(src) != len(dst):
        raise ValueError(f"staged {len(src)} states into a graph of {len(dst)}")
    for a, b in zip(dst, src):
        copy_states(a, b)


def _first(x: States) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else _first(x[0])


class GraphRun:
    """``eager(init) -> final`` captured on a static input shaped like
    ``example`` (on the card), a tensor or a tuple of tensors:
    ``stage(x)``, then ``replay()``; or call it with ``x`` for both.
    ``eager`` stays reachable, the loop the graph records."""

    def __init__(self, eager: Callable[[States], States], example: States):
        self.eager = eager
        dev = _first(example).device
        self.static_in = clone_states(example)
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

    def stage(self, x: States) -> None:
        copy_states(self.static_in, x)

    def replay(self) -> States:
        return clone_states(self.graphed.replay())

    def __call__(self, x: States) -> States:
        self.stage(x)
        return self.replay()

    def close(self) -> None:
        self.graphed.close()


class HostLoop:
    """A run as a host loop over ``programs``, zero-argument callables that
    read and write static state buffers: ``stage(x)`` copies an initial
    state (or an ensemble's tuple) into the buffers, ``order`` lists the
    program each host call runs, and ``output()`` gives the static final
    state(s). ``run()`` calls the programs in order, eagerly; calling the
    loop with ``x`` stages it, runs, and returns a clone of the output."""

    def __init__(self, stage: Callable[[States], None], programs: Sequence[Callable[[], None]],
                 order: Sequence[int], output: Callable[[], States]):
        self.stage = stage
        self.programs = tuple(programs)
        self.order = tuple(order)
        self.output = output

    def run(self) -> None:
        for i in self.order:
            self.programs[i]()

    def replay(self) -> States:
        self.run()
        return clone_states(self.output())

    def __call__(self, x: States) -> States:
        self.stage(x)
        return self.replay()


class ReplayLoop:
    """A `HostLoop` on the card with each program captured as its own CUDA
    graph (each warmed up once, eagerly, on a side stream first): ``replay()``
    replays the programs' graphs in the loop's order, one host call each,
    and returns a clone of the output. ``eager`` is the `HostLoop`, on the
    same buffers; ``capture_s`` and ``nodes`` are summed over the graphs."""

    def __init__(self, loop: HostLoop, device: torch.device):
        self.eager = loop
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with _build.building(), torch.cuda.stream(stream):
            for program in loop.programs:  # the warm-ups, not counted as a run
                program()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graphs = [Graphed(program, stream) for program in loop.programs]

    @property
    def capture_s(self) -> float:
        return sum(g.capture_s for g in self.graphs)

    @property
    def nodes(self) -> int:
        return sum(g.nodes for g in self.graphs)

    def stage(self, x: States) -> None:
        self.eager.stage(x)

    def replay(self) -> States:
        for i in self.eager.order:
            self.graphs[i].replay()
        return clone_states(self.eager.output())

    def __call__(self, x: States) -> States:
        self.stage(x)
        return self.replay()

    def close(self) -> None:
        for g in self.graphs:
            g.close()


class ShardedRun:
    """A run over D row shards that takes and gives the global state.

    ``inner`` is the shards' run (a `GraphRun`, `ReplayLoop`, `HostLoop`, or
    an eager loop) over the tuple ``split(x)`` gives; ``gather`` turns its
    output back into the global state. ``stage(x)`` splits (outside a timed
    region), ``replay()`` runs and gathers. ``eager`` is the same wrapper
    over the inner run's eager loop; ``capture_s``, ``nodes`` and
    ``graphs`` are the inner run's."""

    def __init__(self, inner, split: Callable, gather: Callable):
        self.inner, self.split, self.gather = inner, split, gather
        self._held = None

    @property
    def eager(self) -> "ShardedRun":
        inner = getattr(self.inner, "eager", None)
        return self if inner is None else ShardedRun(inner, self.split, self.gather)

    def __getattr__(self, name):
        if name in ("capture_s", "nodes", "graphs", "graphed"):
            return getattr(self.inner, name)
        raise AttributeError(name)

    def stage(self, x: States) -> None:
        shards = self.split(x)
        if hasattr(self.inner, "stage"):
            self.inner.stage(shards)
        else:
            self._held = shards

    def replay(self) -> States:
        if hasattr(self.inner, "replay"):
            return self.gather(self.inner.replay())
        return self.gather(self.inner(self._held))

    def __call__(self, x: States) -> States:
        self.stage(x)
        return self.replay()


def time_runs(run: Callable, x: States, *, reps: int, warmup: int = 1,
              outputs: Optional[List[States]] = None) -> List[float]:
    """Host seconds of each of ``reps`` runs of ``run`` (a `GraphRun`, a
    `HostLoop` or `ReplayLoop`, or an eager loop) on fresh copies of ``x``
    (a state, or an ensemble's tuple): each copy is staged outside the
    timed region, which holds the run and a device synchronize;
    ``max(warmup, 1)`` untimed runs first. Each timed run's output is
    appended to ``outputs``, where given."""
    if isinstance(run, (GraphRun, HostLoop, ReplayLoop, ShardedRun)):
        stage, replay = run.stage, run.replay
    else:
        held: List[States] = []

        def stage(x):
            held[:] = [clone_states(x)]

        def replay():
            return run(held[0])

    dev = _first(x).device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(max(warmup, 1)):
        stage(x)
        replay()
    walls: List[float] = []
    for _ in range(reps):
        stage(x)
        sync()
        t0 = time.perf_counter()
        out = replay()
        sync()
        walls.append(time.perf_counter() - t0)
        if outputs is not None:
            outputs.append(out)
    return walls
