"""The port's runs as CUDA graphs: launch accounting under replay, the eager
loop that a capture records, the Task Bench presets, and ``serve`` with its
static decode buffers, on the CPU.

Launch accounting: a stub C entry stands in for a kernel, and stand-ins for
``torch.cuda.CUDAGraph``, ``torch.cuda.graph`` and the streams stand in for
the card, so that the counters are checked without one: launches made while
a graph is built (its warm-up and its capture) count apart, and each replay
adds the capture's launches to the run counters.

Parity: ``Runtime.build`` on ``device="cpu"`` (the eager loop) against the
JAX package's runtimes on the same initial state, ``rtol=1e-5, atol=1e-6``;
``serve`` on the reduced internlm2, mamba2 and hymba configs with the
reference's weights and prompts against the reference's greedy tokens
(jitted, its Pallas kernels in interpret mode). Inputs are drawn with numpy.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import taskbench as ref_taskbench
from repro.configs.registry import get_config as ref_config
from repro.core import KernelSpec as RefSpec
from repro.core import TaskGraph as RefGraph
from repro.core import get_runtime as ref_runtime
from repro.core.task_kernels import initial_state as ref_initial_state
from repro.launch.serve import _grow_caches as ref_grow
from repro.models.model import Model as RefModel
from repro_torch.configs import taskbench
from repro_torch.configs.registry import get_config
from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import _capture
from repro_torch.kernels import _build, ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models.model import Model, params_from_reference

COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=0, atol=1e-5)
HALO = ("trivial", "no_comm", "stencil_1d", "stencil_1d_periodic", "dom",
        "nearest", "random_nearest")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ launch accounting


class _StubLibrary:
    """A library whose every C entry launches nothing and succeeds."""

    def __getattr__(self, entry):
        return lambda *args: 0


@pytest.fixture
def stub_entries(monkeypatch):
    monkeypatch.setattr(_build, "_library", lambda name: _StubLibrary())
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts replays, runs nothing."""

    made = []

    def __init__(self, keep_graph=False):
        self.keep_graph, self.replays, self.generators = keep_graph, 0, []
        self.was_reset = False
        _FakeGraph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def instantiate(self):
        pass

    def replay(self):
        self.replays += 1

    def reset(self):
        self.was_reset = True


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_card(monkeypatch, stub_entries):
    """The capture machinery without a card: a capture runs the function
    once (the launches it makes are the graph's), a replay runs nothing."""
    _FakeGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(_capture, "node_count", lambda graph: 7)


def _two_launches(x):
    """An eager loop of two K3 launches (stub) on ``x``."""
    _build.launch("taskbench_step")
    _build.launch("taskbench_step")
    return x + 1.0


def test_launches_in_a_build_count_apart(stub_entries):
    _build.launch("taskbench_compute")
    with _build.building() as rec:
        for _ in range(3):
            _build.launch("taskbench_step")
        _build.launch("taskbench_compute", ctas=9)
    assert ops.launch_counts()["taskbench_compute"] == 1
    assert ops.launch_counts()["taskbench_step"] == 0
    assert rec == {"taskbench_step": 3, "taskbench_compute": 1}
    assert _build.BUILD_LAUNCHES == rec
    assert _build.LAST_CTAS["taskbench_compute"] == 9


@pytest.mark.parametrize("replays", [0, 1, 4])
def test_each_replay_adds_the_launches_of_its_capture(stub_entries, replays):
    with _build.building() as rec:
        _build.launch("decode_attention")
        _build.launch("decode_attention")
        _build.launch("taskbench_step")
    for _ in range(replays):
        _build.replayed(rec)
    counts = ops.launch_counts()
    assert counts["decode_attention"] == 2 * replays
    assert counts["taskbench_step"] == replays
    assert sum(_build.BUILD_LAUNCHES.values()) == 3


def test_reset_clears_the_run_build_and_capture_counters(fake_card):
    _capture.GraphRun(_two_launches, torch.zeros(3, 2))(torch.zeros(3, 2))
    assert any(_build.LAUNCHES.values()) and any(_build.BUILD_LAUNCHES.values())
    assert _build.CAPTURES["graphs"] == 1
    ops.reset_launch_counts()
    assert not any(_build.LAUNCHES.values())
    assert not any(_build.BUILD_LAUNCHES.values())
    assert not any(_build.CAPTURES.values())


def test_graph_run_counts_its_warmup_and_capture_apart(fake_card):
    """The warm-up run and the capture are build launches; each replay adds
    the capture's two to the run counters; the outputs of two replays are
    two tensors."""
    run = _capture.GraphRun(_two_launches, torch.zeros(3, 2))
    graph = _FakeGraph.made[-1]
    assert graph.keep_graph
    assert run.graphed.launches == {"taskbench_step": 2}
    assert _build.BUILD_LAUNCHES["taskbench_step"] == 4
    assert ops.launch_counts()["taskbench_step"] == 0
    assert _build.CAPTURES["graphs"] == 1 and run.nodes == 7
    x = torch.arange(6.0).reshape(3, 2)
    a = run(x)
    run.stage(x)
    b = run.replay()
    assert graph.replays == 2
    assert ops.launch_counts()["taskbench_step"] == 4
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(run.static_in, x)
    run.close()
    assert graph.was_reset and run.graphed.graph is None


def _member_launches(xs):
    """An ensemble's eager loop (stub): one K3 launch for each member."""
    outs = []
    for x in xs:
        _build.launch("taskbench_step")
        outs.append(x * 2.0)
    return tuple(outs)


def test_graph_run_over_a_tuple_stages_each_member(fake_card):
    """An ensemble's graph: a tuple of static inputs, each member staged
    into its own; the replay gives a tuple of clones, one a member; a
    staged tuple of another length raises; the launches of one member each
    count per replay."""
    example = (torch.zeros(3, 2), torch.zeros(5, 4))
    run = _capture.GraphRun(_member_launches, example)
    assert isinstance(run.static_in, tuple) and len(run.static_in) == 2
    assert all(s is not e for s, e in zip(run.static_in, example))
    assert run.graphed.launches == {"taskbench_step": 2}
    xs = (torch.arange(6.0).reshape(3, 2), torch.ones(5, 4))
    a = run(xs)
    assert all(torch.equal(s, x) for s, x in zip(run.static_in, xs))
    b = run.replay()
    assert isinstance(a, tuple) and len(a) == 2
    assert [t.shape for t in a] == [(3, 2), (5, 4)]
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a, b))
    assert ops.launch_counts()["taskbench_step"] == 4
    with pytest.raises(ValueError, match="staged 1 states"):
        run.stage(xs[:1])
    walls = _capture.time_runs(run, xs, reps=2)
    assert len(walls) == 2
    assert ops.launch_counts()["taskbench_step"] == 4 + 2 * 3


def test_sharded_run_stages_each_shard_and_gathers(fake_card):
    """A run over D row shards: its graph's static input nests (member,
    shard); ``ShardedRun`` splits each global state into its shards when
    staging, outside the run, and gathers the output after it; ``eager``
    is the same wrapper over the eager loop; the graph's capture seconds
    and nodes pass through, and its launches count per replay."""
    rt = get_runtime("bsp_scan", devices=["cpu"] * 2)
    gs = (TaskGraph(steps=2, width=4, payload=2), TaskGraph(steps=2, width=6, payload=3))

    def eager(states):  # member -> shard
        _build.launch("taskbench_step")
        return tuple(tuple(s * 2.0 for s in m) for m in states)

    inner = _capture.GraphRun(eager, tuple(rt._zero_shards(g) for g in gs))
    run = _capture.ShardedRun(inner, rt._split, rt._gather)
    assert [[t.shape for t in m] for m in inner.static_in] == [[(2, 2)] * 2, [(3, 3)] * 2]
    xs = (torch.arange(8.0).reshape(4, 2), torch.ones(6, 3))
    out = run(xs)
    assert torch.equal(inner.static_in[0][1], xs[0][2:])
    assert torch.equal(inner.static_in[1][0], xs[1][:3])
    assert [o.shape for o in out] == [(4, 2), (6, 3)]
    assert all(torch.equal(o, 2 * x) for o, x in zip(run.eager(xs), xs))
    assert run.nodes == 7 and run.capture_s >= 0
    assert ops.launch_counts()["taskbench_step"] == 2  # the replay and the eager loop
    assert len(_capture.time_runs(run, xs, reps=2)) == 2


def test_time_runs_takes_a_tuple_of_states():
    seen = []

    def run(xs):
        seen.append(xs)
        for x in xs:
            x.add_(1.0)
        return xs

    xs = (torch.zeros(2), torch.zeros(3))
    walls = _capture.time_runs(run, xs, reps=2, warmup=1)
    assert len(walls) == 2 and len(seen) == 3
    assert all(isinstance(s, tuple) and s[0] is not xs[0] for s in seen)
    assert torch.equal(xs[0], torch.zeros(2)) and torch.equal(xs[1], torch.zeros(3))


def test_graphed_registers_the_generators_it_is_given(fake_card):
    gen = torch.Generator().manual_seed(1)
    g = _capture.Graphed(lambda: torch.ones(2), _FakeStream(), (gen,))
    assert _FakeGraph.made[-1].generators == [gen]
    assert torch.equal(g.replay(), torch.ones(2))


def test_build_on_the_cpu_is_the_eager_loop():
    g = TaskGraph(steps=4, width=8, pattern="stencil_1d", payload=4,
                  kernel=KernelSpec("compute_bound", 2))
    for rt in (get_runtime("fused", device="cpu"),
               get_runtime("pallas_step", device="cpu", steps_per_launch=2)):
        run = rt.build(g)
        assert not isinstance(run, _capture.GraphRun)
        x = torch.rand(8, 4)
        assert torch.equal(run(x), rt._build_eager(g)(x))


def test_time_runs_stages_a_fresh_copy_outside_the_timed_run():
    seen = []

    def run(x):
        seen.append(x)
        x.add_(1.0)  # a run may write its input
        return x

    x = torch.zeros(2)
    walls = _capture.time_runs(run, x, reps=3, warmup=2)
    assert len(walls) == 3 and min(walls) > 0
    assert len(seen) == 5 and len({t.data_ptr() for t in seen}) >= 2
    assert all(t is not x for t in seen) and torch.equal(x, torch.zeros(2))


# ------------------------------------------------ the eager loop's results


def _pair(pattern, kind="compute_bound", iters=2, width=24, steps=9):
    spec = dict(kind=kind, iterations=iters, scratch=30)
    kw = dict(radius=2, seed=3)
    g = TaskGraph(steps=steps, width=width, pattern=pattern, payload=5,
                  kernel=KernelSpec(**spec), **kw)
    r = RefGraph(steps=steps, width=width, pattern=pattern, payload=5,
                 kernel=RefSpec(**spec), **kw)
    return g, r, np.asarray(ref_initial_state(width, 5, r.seed))


SCHEDULES = [
    ("fused", {}, "fused", {}),
    ("fused", {"use_kernels": True}, "fused", {}),
    ("pallas_step", {}, "pallas_step", {}),
    ("pallas_step", {"combine": "gather"}, "pallas_step", {"combine": "gather"}),
    ("pallas_step", {"combine": "onehot"}, "pallas_step", {"combine": "onehot"}),
    ("pallas_step", {"steps_per_launch": 3}, "pallas_step", {"steps_per_launch": 3}),
    ("pallas_step", {"steps_per_launch": 3, "pipeline": False},
     "pallas_step", {"steps_per_launch": 3, "pipeline": False}),
]


@pytest.mark.parametrize("pattern", HALO)
@pytest.mark.parametrize("name,opts,ref_name,ref_opts", SCHEDULES,
                         ids=[f"{s[0]}{s[1]}" for s in SCHEDULES])
def test_build_on_the_cpu_matches_the_reference(pattern, name, opts, ref_name, ref_opts):
    g, r, init = _pair(pattern)
    want = np.asarray(ref_runtime(ref_name, **ref_opts).execute(r, init))
    got = get_runtime(name, device="cpu", **opts).build(g)(torch.from_numpy(init.copy()))
    np.testing.assert_allclose(got.numpy(), want, **COMPUTE_TOL)


@pytest.mark.parametrize("kind,iters", [("memory_bound", 3), ("empty", 0)])
@pytest.mark.parametrize("name,opts,ref_name,ref_opts", SCHEDULES,
                         ids=[f"{s[0]}{s[1]}" for s in SCHEDULES])
def test_build_on_the_cpu_matches_the_reference_per_body(kind, iters, name, opts,
                                                          ref_name, ref_opts):
    g, r, init = _pair("nearest", kind=kind, iters=iters)
    want = np.asarray(ref_runtime(ref_name, **ref_opts).execute(r, init))
    got = get_runtime(name, device="cpu", **opts).build(g)(torch.from_numpy(init.copy()))
    np.testing.assert_allclose(got.numpy(), want,
                               **(MEMORY_TOL if kind == "memory_bound" else COMPUTE_TOL))


def test_measure_reports_no_graph_on_the_cpu():
    g = TaskGraph(steps=3, width=8, pattern="stencil_1d", payload=4,
                  kernel=KernelSpec("compute_bound", 1))
    _, st = get_runtime("pallas_step", device="cpu").measure(g, reps=2)
    assert st.capture_s is None and st.graph_nodes is None


# ---------------------------------------------------------------- presets


@pytest.mark.parametrize("name", sorted(ref_taskbench.PRESETS))
def test_presets_equal_the_reference_field_by_field(name):
    got, want = taskbench.PRESETS[name], ref_taskbench.PRESETS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_the_preset_names_are_the_reference_ones():
    assert set(taskbench.PRESETS) == set(ref_taskbench.PRESETS)
    assert [f.name for f in dataclasses.fields(taskbench.TaskBenchConfig)] == \
        [f.name for f in dataclasses.fields(ref_taskbench.TaskBenchConfig)]


# ------------------------------------------------------------------ serve

#: (arch, batch, prompt length, generated tokens)
SERVED = {
    "internlm2": ("internlm2-1.8b", 2, 12, 6),
    "mamba2": ("mamba2-130m", 2, 12, 6),
    "hymba": ("hymba-1.5b", 2, 5, 7),
}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_serve_with_static_buffers_gives_the_reference_tokens(monkeypatch, name):
    """``serve`` with the reference's weights and prompts: its greedy tokens
    equal the reference's; ``lengths`` is one buffer, advanced in place."""
    arch, B, prompt, gen = SERVED[name]
    cfg, pcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    params = jax.tree.map(np.asarray, RefModel(cfg).init(jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (B, prompt), np.int32)

    ref = RefModel(cfg)
    logits, caches = jax.jit(lambda p, t: ref.prefill(p, {"tokens": t}))(params, prompts)
    caches = ref_grow(ref, caches, B, prompt + gen)
    decode = jax.jit(lambda p, t, n, c: ref.decode_step(p, {"tokens": t}, n, c))
    lengths = jnp.full((B,), prompt, jnp.int32)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    want = [np.asarray(tok)]
    for _ in range(gen - 1):
        lg, caches = decode(params, tok, lengths, caches)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
        lengths = lengths + 1

    seen = []

    class RefWeighted(Model):
        def __init__(self, cfg, *, device, seed):
            super().__init__(cfg, device=device, seed=seed)
            self.load_state_dict(params_from_reference(cfg, params))

        def decode_step(self, tokens, lengths, caches):
            seen.append((lengths.data_ptr(), lengths.clone()))
            return super().decode_step(tokens, lengths, caches)

    monkeypatch.setattr(serve_mod, "Model", RefWeighted)
    monkeypatch.setattr(serve_mod, "make_prompts",
                        lambda *a, **k: torch.from_numpy(prompts).long())
    res = serve_mod.serve(pcfg, batch=B, prompt_len=prompt, gen=gen, verbose=False,
                          device="cpu", keep_logits=True)
    np.testing.assert_array_equal(res.tokens, np.concatenate(want, axis=1))
    assert res.logits.shape == (gen - 1, B, pcfg.vocab)
    assert res.capture_s is None and res.graph_nodes is None and res.healthy
    assert len({ptr for ptr, _ in seen}) == 1
    for i, (_, n) in enumerate(seen):
        assert torch.equal(n, torch.full((B,), prompt + i, dtype=torch.int32))


def test_serve_sampled_on_the_cpu_is_seeded():
    cfg = get_config("internlm2-1.8b").reduced()
    a, b = (serve_mod.serve(cfg, batch=2, prompt_len=6, gen=5, greedy=False,
                            verbose=False, device="cpu") for _ in range(2))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: the sleep queued after it
    lasts what `_sleep` was given (2e6 cycles a ms); start to end 1 ms."""

    slept_ms = 0.0

    def __init__(self, enable_timing=False):
        self.kind = None

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return _FakeEvent.slept_ms if self.kind == "sleep" else 1.0


def test_gpu_ms_retakes_a_measurement_its_sleep_did_not_cover(monkeypatch):
    """An enqueue that outlasts the device sleep is not kept: the
    measurement is taken again behind a sleep twice as long; after the
    last attempt it raises."""
    import time

    from repro_torch.launch import attention_times

    sleeps = []

    def sleep(cycles):
        sleeps.append(cycles)
        _FakeEvent.slept_ms = cycles / 2e6

    events = []

    def event(enable_timing=False):
        e = _FakeEvent()
        events.append(e)
        if len(events) % 3 == 1:
            e.kind = "sleep"
        return e

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "_sleep", sleep)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls = []

    def slow_first_attempt():
        calls.append(1)
        if 5 <= len(calls) <= 6:  # the first timed attempt's two calls
            time.sleep(0.06)

    assert attention_times.gpu_ms(slow_first_attempt, 2) == 0.5
    assert len(sleeps) == 2 and sleeps[1] == 2 * sleeps[0] == 400_000_000
    calls.clear()
    sleeps.clear()

    def slow_after_warmup():  # 2 x 0.21 s outlasts 0.1, 0.2 and 0.4 s of sleep
        calls.append(1)
        if len(calls) > 4:
            time.sleep(0.21)

    with pytest.raises(RuntimeError, match="3 times"):
        attention_times.gpu_ms(slow_after_warmup, 2)
    assert attention_times.COVER_ATTEMPTS == 3
    assert sleeps == [200_000_000, 400_000_000, 800_000_000]
