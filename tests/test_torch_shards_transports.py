"""The port's transports between row shards, on the CPU: ``_halo``'s ring,
stride and gather transports against the reference's under ``shard_map``
on forced host devices, bit for bit.

The reference's side runs in one subprocess per device count, with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` (never set in the
pytest process), and writes its outputs to ``.npz``; the port's side runs
here over ``devices=["cpu"] * N``: one controller, each shard its own
tensor. Every transport moves exact row copies, so every comparison is
bit for bit. Also here: the registries' refusals, the separate shard
tensors, a counting transport registered through
``register_transport_impl`` seeing every exchange of a sharded run, and
``overlap``'s order of issue (the transfer started before the interior
body, joined after it).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.runtimes import _halo as ref_halo
from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import _halo
from repro_torch.core.runtimes import bsp as bsp_module

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALO_DEPTHS = (2, 6, 7, 13, 29)  # below, at and past a block of 6, past the ring
EDGE_DEPTHS = (1, 3, 6)
STRIDES = ((1,), (2,), (3,), (1, 2, 3))


def run_reference(code: str, devices: int, out_dir) -> dict:
    """``code`` in a subprocess on ``devices`` forced host devices; it
    writes ``{out}`` (an .npz); returns the arrays."""
    out = os.path.join(str(out_dir), f"ref_transports_{devices}.npz")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", textwrap.dedent(code), out],
                          capture_output=True, text=True, timeout=300, env=env)
    assert done.returncode == 0, done.stderr
    with np.load(out) as z:
        return dict(z)


REF_D4 = """
import sys
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.core.runtimes import _halo

D, B, Pay = 4, 6, 5
W = D * B
mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
x = np.arange(W * Pay, dtype=np.float32).reshape(W, Pay)
out = {}

def run(fn, n_out):
    f = jax.jit(shard_map(fn, mesh=mesh, check_vma=False, in_specs=P("shard"),
                          out_specs=(P("shard"),) * n_out))
    return [np.asarray(o) for o in f(jax.device_put(x, NamedSharding(mesh, P("shard"))))]

for r in (2, 6, 7, 13, 29):
    out[f"halo{r}/l"], out[f"halo{r}/r"] = run(
        lambda l, r=r: _halo.exchange_halos(l, r, D, "shard"), 2)
for r in (1, 3, 6):
    for impl in ("xla", "ppermute"):
        out[f"edges{r}{impl}/l"], out[f"edges{r}{impl}/r"] = run(
            lambda l, r=r, impl=impl: _halo.exchange_halos_join(_halo.exchange_edges_start(
                l[:r], l[B - r:], D, "shard", impl=impl)), 2)
for ss in [(1,), (2,), (3,), (1, 2, 3)]:
    for impl in ("xla", "ppermute"):
        got = run(lambda l, ss=ss, impl=impl: _halo.exchange_stride(
            l, ss, D, "shard", impl=impl), len(ss))
        for j, bs in enumerate(ss):
            out[f"stride{ss}{impl}/{bs}"] = got[j]
for impl in ("xla", "ppermute"):
    out[f"gather{impl}"], = run(lambda l, impl=impl: (_halo.gather_global(
        l, D, "shard", impl=impl),), 1)
out["mean"], = run(lambda l: (_halo.global_mean(l, W, D, "shard")[None],), 1)
np.savez(sys.argv[1], **out)
"""

REF_D16 = """
import sys
import numpy as np, jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core.runtimes import _halo

D, W, Pay = 16, 64, 3
mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
x = np.arange(W * Pay, dtype=np.float32).reshape(W, Pay)
out = {}
for impl in ("xla", "ppermute", "chunked"):
    fn = jax.jit(shard_map(lambda l, impl=impl: _halo.gather_global(l, D, "shard", impl=impl),
                           mesh=mesh, in_specs=P("shard"), out_specs=P(None), check_vma=False))
    out[impl] = np.asarray(fn(x))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    return run_reference(REF_D4, 4, tmp_path_factory.mktemp("ref4"))


@pytest.fixture(scope="module")
def ref16(tmp_path_factory):
    return run_reference(REF_D16, 16, tmp_path_factory.mktemp("ref16"))


def _shards(D, B, Pay):
    x = torch.arange(D * B * Pay, dtype=torch.float32).reshape(D * B, Pay)
    return x, [x[d * B:(d + 1) * B].clone() for d in range(D)], _halo.ShardMesh(["cpu"] * D)


def _stacked(parts):
    return torch.cat(list(parts)).numpy()


@pytest.mark.parametrize("r", HALO_DEPTHS)
def test_halo_exchange_equals_the_reference(ref4, r):
    """The synchronous exchange (the "ppermute" transport; the chain of
    block shifts past a block) and its start/join on both transports
    equal the reference's shard_map exchange at D = 4, B = 6."""
    _, sh, mesh = _shards(4, 6, 5)
    left, right = _halo.exchange_halos(sh, r, mesh)
    np.testing.assert_array_equal(_stacked(left), ref4[f"halo{r}/l"])
    np.testing.assert_array_equal(_stacked(right), ref4[f"halo{r}/r"])
    for impl in _halo.HALO_ASYNC_IMPLS:
        l2, r2 = _halo.exchange_halos_join(_halo.exchange_halos_start(mesh, sh, r, impl=impl))
        assert all(torch.equal(a, b) for a, b in zip(left + right, l2 + r2)), impl


@pytest.mark.parametrize("impl", ["xla", "ppermute"])
@pytest.mark.parametrize("r", EDGE_DEPTHS)
def test_edge_transports_equal_the_reference(ref4, r, impl):
    _, sh, mesh = _shards(4, 6, 5)
    left, right = _halo.exchange_halos_join(_halo.exchange_edges_start(
        mesh, [x[:r] for x in sh], [x[6 - r:] for x in sh], impl=impl))
    np.testing.assert_array_equal(_stacked(left), ref4[f"edges{r}{impl}/l"])
    np.testing.assert_array_equal(_stacked(right), ref4[f"edges{r}{impl}/r"])


@pytest.mark.parametrize("impl", ["xla", "ppermute"])
@pytest.mark.parametrize("strides", STRIDES, ids=str)
def test_stride_transports_equal_the_reference(ref4, strides, impl):
    """Partner blocks ``d XOR bs``, one per requested stride (one ring for
    every stride on "xla"), and start/join equal to the sync spelling."""
    _, sh, mesh = _shards(4, 6, 5)
    got = _halo.exchange_stride(mesh, sh, strides, impl=impl)
    again = _halo.exchange_stride_join(_halo.exchange_stride_start(mesh, sh, strides, impl=impl))
    for j, bs in enumerate(strides):
        np.testing.assert_array_equal(_stacked(got[j]), ref4[f"stride{strides}{impl}/{bs}"])
        assert all(torch.equal(a, b) for a, b in zip(got[j], again[j]))


def test_gathers_and_mean_equal_the_reference(ref4):
    x, sh, mesh = _shards(4, 6, 5)
    for impl in ("xla", "ppermute", "chunked"):
        full = _halo.gather_global(sh, mesh, impl=impl)
        assert len(full) == 4
        np.testing.assert_array_equal(_stacked(full), ref4[f"gather{'xla' if impl == 'chunked' else impl}"])
    means = _halo.global_mean(sh, 24, mesh)
    np.testing.assert_allclose(torch.stack(means).numpy(), ref4["mean"], rtol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "ppermute", "chunked"])
def test_gathers_at_16_shards_equal_the_reference(ref16, impl):
    """At D = 16 the chunked gather is a real two-stage split (G = 4); every
    gather equals the reference's and the global-order oracle bit for bit."""
    x, sh, mesh = _shards(16, 4, 3)
    assert _halo.gather_chunk_group(16) == ref_halo.gather_chunk_group(16) == 4
    full = _halo.gather_global(sh, mesh, impl=impl)
    for f in full:
        np.testing.assert_array_equal(f.numpy(), ref16[impl])
        np.testing.assert_array_equal(f.numpy(), x.numpy())
    for g in (1, 2, 8, 16):
        assert all(torch.equal(a, x) for a in _halo.gather_global(
            sh, mesh, impl="chunked", chunk_group=g))


def test_chunk_group_is_the_reference_rule():
    for D in range(1, 33):
        assert _halo.gather_chunk_group(D) == ref_halo.gather_chunk_group(D), D


def test_transports_refuse_what_the_reference_refuses():
    _, sh, mesh = _shards(4, 6, 5)
    with pytest.raises(ValueError, match="power-of-two"):
        _halo.exchange_stride_start(6, [], (4,))
    for bad in (0, 4):
        with pytest.raises(ValueError, match="outside"):
            _halo.exchange_stride_start(mesh, sh, (bad,))
    with pytest.raises(ValueError, match="unknown halo async impl"):
        _halo.exchange_edges_start(mesh, sh, sh, impl="mosaic")
    with pytest.raises(ValueError, match="unknown stride async impl"):
        _halo.exchange_stride_start(mesh, sh, (1,), impl="mosaic")
    with pytest.raises(ValueError, match="unknown gather impl"):
        _halo.gather_global(sh, mesh, impl="mosaic")
    with pytest.raises(ValueError, match="does not divide"):
        _halo.gather_global(sh, mesh, impl="chunked", chunk_group=3)
    with pytest.raises(ValueError, match="already registered"):
        _halo.register_transport_impl("halo", "xla", _halo._gather_edges_start)
    with pytest.raises(ValueError, match="unknown transport registry"):
        _halo.register_transport_impl("ring", "x", _halo._gather_edges_start)
    assert _halo.TRANSPORT_REGISTRIES == {"halo": _halo.HALO_ASYNC_IMPLS,
                                          "stride": _halo.STRIDE_ASYNC_IMPLS,
                                          "gather": _halo.GATHER_IMPLS}
    # the production transports; a test may have installed either package's
    # "chaos+<base>" wrappers (resilience.install_chaos_impls) in this process
    def production(registry):
        return sorted(n for n in registry if not n.startswith("chaos+"))

    assert production(_halo.HALO_ASYNC_IMPLS) == production(ref_halo.HALO_ASYNC_IMPLS)
    assert production(_halo.STRIDE_ASYNC_IMPLS) == production(ref_halo.STRIDE_ASYNC_IMPLS)
    assert production(_halo.GATHER_IMPLS) == production(ref_halo.GATHER_IMPLS)
    assert production(_halo.GATHER_IMPLS) == ["chunked", "ppermute", "xla"]
    assert production(_halo.HALO_ASYNC_IMPLS) == production(_halo.STRIDE_ASYNC_IMPLS) == [
        "ppermute", "xla"]


def test_received_rows_are_copies_in_their_own_buffers():
    """A transport copies: no receive buffer shares storage with a sending
    shard's state."""
    _, sh, mesh = _shards(4, 6, 5)
    ptrs = {x.untyped_storage().data_ptr() for x in sh}
    for impl in _halo.HALO_ASYNC_IMPLS:
        left, right = _halo.exchange_halos_join(_halo.exchange_halos_start(mesh, sh, 2, impl=impl))
        assert not ptrs & {t.untyped_storage().data_ptr() for t in left + right}, impl
    for impl in _halo.GATHER_IMPLS:
        full = _halo.gather_global(sh, mesh, impl=impl)
        assert not ptrs & {t.untyped_storage().data_ptr() for t in full}, impl


def _graph(pattern="stencil_1d", **kw):
    kw = dict(dict(steps=6, width=32, payload=8, radius=2, seed=3,
                   kernel=KernelSpec("compute_bound", 1)), **kw)
    return TaskGraph(pattern=pattern, **kw)


@pytest.mark.parametrize("backend,options", [
    ("bsp", {}), ("bsp_scan", {}), ("overlap", {}), ("overlap", {"overlap": False}),
    ("pallas_step", {}), ("pallas_step", {"steps_per_launch": 2, "pipeline": False})])
def test_shards_are_separate_tensors(backend, options):
    """The split gives D tensors of their own (no shard a view of another's
    storage or of the global state), and so does every run's output."""
    rt = get_runtime(backend, devices=["cpu"] * 4, **options)
    g = _graph(steps=5)
    x = rt._init(g, None)
    shards = rt._split(x)
    out = rt._build_eager(g)(shards)
    for group in (shards, out):
        ptrs = [t.untyped_storage().data_ptr() for t in group]
        assert len(set(ptrs)) == 4 and x.untyped_storage().data_ptr() not in ptrs
        assert all(t.shape == (8, 8) for t in group)


@pytest.fixture
def counting():
    """Every halo transport wrapped (``register_transport_impl(...,
    replace=True)``) to count its starts by name; restored after."""
    saved = dict(_halo.HALO_ASYNC_IMPLS)
    seen = {name: 0 for name in saved}

    def wrap(name, start):
        def counted(*args, **kw):
            seen[name] += 1
            return start(*args, **kw)
        return counted

    for name, start in saved.items():
        _halo.register_transport_impl("halo", name, wrap(name, start), replace=True)
    yield seen
    for name, start in saved.items():
        _halo.register_transport_impl("halo", name, start, replace=True)


@pytest.mark.parametrize("backend,options,want", [
    ("bsp", {}, {"ppermute": 5}), ("bsp_scan", {}, {"ppermute": 5}),
    ("overlap", {}, {"ppermute": 5}), ("overlap", {"overlap": False}, {"ppermute": 5}),
    ("pallas_step", {}, {"ppermute": 5}),
    ("pallas_step", {"steps_per_launch": 2, "pipeline": False}, {"ppermute": 3}),
    ("pallas_step", {"steps_per_launch": 2}, {"xla": 4}),
    ("pallas_step", {"steps_per_launch": 2, "halo_impl": "ppermute"}, {"ppermute": 4}),
])
def test_every_exchange_goes_through_the_registry(counting, backend, options, want):
    """A counting transport sees every exchange of a sharded run: one a
    superstep (T - 1 = 5), one a serial blocked launch (3 at S = 2), and
    on the pipelined schedule the prologue's and one a launch (1 + 3), on
    the transport ``halo_impl`` names; the result is unchanged."""
    g = _graph(width=64)
    rt = get_runtime(backend, devices=["cpu"] * 4, **options)
    out = rt.execute(g)
    got = {k: v for k, v in counting.items() if v}
    assert got == want
    ref = get_runtime("fused", device="cpu").execute(g)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_overlap_starts_the_transfer_before_the_interior(monkeypatch):
    """overlap=True at D = 4: per step the exchange is started first, then
    every shard's interior body (B - 2r rows), then the join, then the
    boundary bodies (r rows); overlap=False joins before any body. The
    order of the issued operations, logged."""
    log = []
    start = _halo.HALO_ASYNC_IMPLS["ppermute"]

    def logged_start(*args, **kw):
        handle = start(*args, **kw)
        log.append("start")
        join = handle.join

        def logged_join():
            log.append("join")
            return join()

        handle.join = logged_join
        return handle

    apply = bsp_module.apply_kernel

    def logged_apply(x, spec, **kw):
        log.append(f"body{x.shape[0]}")
        return apply(x, spec, **kw)

    monkeypatch.setitem(_halo.HALO_ASYNC_IMPLS, "ppermute", logged_start)
    monkeypatch.setattr(bsp_module, "apply_kernel", logged_apply)
    g = _graph("nearest", width=64, steps=3)  # B = 16, r = 2: interior 12 rows
    for overlap, step in ((True, ["start"] + ["body12"] * 4 + ["join"] + ["body2"] * 8),
                          (False, ["start", "join"] + ["body2"] * 8 + ["body12"] * 4)):
        log.clear()
        get_runtime("overlap", devices=["cpu"] * 4, overlap=overlap).execute(g)
        assert log == ["body16"] * 4 + step * 2, overlap


def test_runtimes_refuse_shards_they_cannot_run():
    with pytest.raises(ValueError, match="runs on one device"):
        get_runtime("fused", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="runs on one device"):
        get_runtime("serialized", devices=["cpu"] * 2)
    rt = get_runtime("pallas_step", devices=["cpu"] * 4)
    for pattern in ("fft", "spread"):  # the stride and all-gather plans run sharded
        g = _graph(pattern, width=32)
        assert rt.supports(g)[0]
        np.testing.assert_array_equal(
            rt.execute(g), get_runtime("pallas_step", device="cpu").execute(g))
    # a tuple ensemble, a launch plan and the row x member mesh run sharded
    # too, each bit for bit its one-device (or replicated) twin
    one = get_runtime("pallas_step", device="cpu")
    ens = GraphEnsemble([_graph(width=32), _graph("fft", width=32)])
    for a, b in zip(rt.execute_ensemble(ens), one.execute_ensemble(ens)):
        np.testing.assert_array_equal(a, b)
    stacked = GraphEnsemble([_graph(width=32)] * 2)
    lp = rt.build_ensemble_launches(stacked)
    carry = lp.init_fn(rt._ensemble_inits(stacked))
    for l in range(lp.num_launches):
        carry = lp.launch_fn(carry, lp.acts[l], lp.launch_t0(l))
    for a, b in zip(lp.finalize(carry), one.execute_ensemble(stacked)):
        np.testing.assert_array_equal(a.numpy(), b)
    dk2 = get_runtime("pallas_step", devices=["cpu"] * 4, member_shards=2)
    for a, b in zip(dk2.execute_ensemble(stacked), rt.execute_ensemble(stacked)):
        np.testing.assert_array_equal(a, b)


def test_the_probe_prices_a_real_exchange():
    """At D > 1 the halo probe times each transport between shards (on
    the CPU: host walls, > 0), and the model's X is that exchange over the
    row step; at D = 1 it stays the free self-wrap, X = 1."""
    from repro_torch.kernels import probes

    walls = probes.probe_halo_exchange_us(4, 8, reps=1, device="cpu", nodes=2)
    assert sorted(walls) == sorted(_halo.HALO_ASYNC_IMPLS) and min(walls.values()) > 0
    assert probes.probe_halo_exchange_us(1) == {probes.SELF_EXCHANGE: 0.0}
    m = probes.run_probes(devices=4, payload=8, device="cpu", smoke=True)
    assert m.devices == 4 and "|d4|" in m.cache_key()
    assert m.exchange_row_steps == max(1.0, m.halo_exchange_us["xla"] / m.row_step_us)
    assert json.loads(json.dumps(m.to_dict()))["devices"] == 4


@pytest.mark.parametrize("kind,impl,want", [
    ("halo", "ppermute", lambda d: {(d - 1) % 8, d, (d + 1) % 8}),
    ("halo", "xla", lambda d: {0}),
    ("stride", "ppermute", lambda d: {d, d ^ 2}),
    ("stride", "xla", lambda d: {0}),
    ("gather", "ppermute", lambda d: set(range(8))),
    ("gather", "xla", lambda d: {0}),
])
def test_a_join_waits_only_on_the_transfers_a_shard_touches(kind, impl, want):
    """At D = 8 a shard's join waits on the transfer streams that deliver
    rows to it or read rows of it, and no other: under "ppermute" its own
    and its two ring neighbours' (its partner's for a stride), not the
    whole ring's; a buffer gathered once per device (one device here, made
    on shard 0's stream) is every shard's. A copy into shard d waits on the
    shards it reads from and on shard d itself."""
    _, sh, mesh = _shards(8, 4, 3)
    if kind == "halo":
        handle = _halo.exchange_halos_start(mesh, sh, 2, impl=impl)
    elif kind == "stride":
        handle = _halo.exchange_stride_start(mesh, sh, (2,), impl=impl)
    else:
        handle = _halo.gather_global_start(mesh, sh, impl=impl)
    assert {d: set(s) for d, s in handle.arrival.waits.items()} == {
        d: want(d) for d in range(8)}
    if impl == "ppermute":  # a copy into shard d waits on its senders and on d
        senders = {"halo": lambda d: {(d - 1) % 8, d, (d + 1) % 8},
                   "stride": lambda d: {d, d ^ 2}, "gather": lambda d: set(range(8))}[kind]
        assert handle.arrival.senders == {d: senders(d) for d in range(8)}


@pytest.mark.parametrize("impl", ["xla", "ppermute"])
@pytest.mark.parametrize("r", (2, 6, 13))
def test_halos_land_in_the_buffers_out_names(impl, r):
    """``out=(heads, tails)``: below, at and past a block (the chain), on
    both transports, the received rows land in the given buffers of each
    shard, the handle hands those buffers back, and the rows are the
    ones the exchange gives without ``out``."""
    _, sh, mesh = _shards(4, 6, 5)
    left, right = _halo.exchange_halos_join(_halo.exchange_halos_start(mesh, sh, r, impl=impl))
    heads = [torch.full((r, 5), float("nan")) for _ in sh]
    tails = [torch.full((r, 5), float("nan")) for _ in sh]
    l2, r2 = _halo.exchange_halos_join(
        _halo.exchange_halos_start(mesh, sh, r, impl=impl, out=(heads, tails)))
    assert [t.data_ptr() for t in l2 + r2] == [t.data_ptr() for t in heads + tails]
    assert all(torch.equal(a, b) for a, b in zip(left + right, heads + tails))


def test_every_transport_start_opens_a_span(monkeypatch):
    """Each start of a halo, stride or gather transport goes through
    ``transport_span`` once, by kind and transport name."""
    import contextlib

    seen = []

    def span(tracer, kind, *, impl, **attrs):
        seen.append((tracer, kind, impl))
        return contextlib.nullcontext()

    monkeypatch.setattr(_halo, "transport_span", span)
    _, sh, mesh = _shards(4, 6, 5)
    _halo.exchange_halos(sh, 2, mesh)
    _halo.exchange_halos(sh, 13, mesh)
    _halo.exchange_edges_start(mesh, sh, sh, impl="xla")
    _halo.exchange_stride(mesh, sh, (1, 2), impl="ppermute")
    _halo.gather_global(sh, mesh, impl="chunked")
    assert seen == [(None, "halo_exchange", "ppermute"), (None, "halo_exchange", "ppermute"),
                    (None, "halo_exchange", "xla"), (None, "stride_exchange", "ppermute"),
                    (None, "gather_global", "chunked")]
