"""``pallas_step``'s stride and all-gather plans over D = 2, 4 and 8 row
shards on the CPU, against the reference's on as many forced host devices
(the runner of ``test_torch_shards_rungs``; the reference's
``test_pallas_step_butterfly_global_multi_device`` at more shapes).

fft and tree run the stride plan at S = 1 (strides inside the block and,
from s = B on, the XOR block exchange) and re-route to the blocked
all-gather plan at S = 8; spread (fanout 3) and all_to_all run the
all-gather plan at S = 1 and 4, all_to_all with ``psum_mean`` on and off.
W = 16 and 32, so that strides fall both inside and outside the block;
T = 10, and T = 5 (butterfly) and 3 (spread), before the pattern has
mixed every row into every other. At grain 1 and memory_bound, where the
dataflow shows (grain >= 8 reaches the FMA's fixed point within a few
steps). Each case: the verdict and
``dispatches_per_run`` the reference's (one shard's count), the result
within the reference tests' tolerances, and bit for bit the port's D = 1
run of the same plan, except all_to_all under ``psum_mean``, whose mean sums
the shards' partial sums (another order) and is held to the tolerance. The
stride transports equal each other bit for bit, and so do the gather
transports ("chunked" at D = 8 with G = 2 and 4 too).
"""
import numpy as np
import pytest
import torch

from test_torch_shards_rungs import (COMPUTE_TOL, MEMORY_TOL, _graph_spec, _port_graph,
                                     run_reference)
from repro_torch.core import get_runtime
from repro_torch.core.runtimes import _halo
from repro_torch.core.runtimes import pallas_step as ps
from repro_torch.kernels import schedule

GRAIN1 = ("compute_bound", 1)
MEMORY = ("memory_bound", 2)


def _case(pattern, D, S, width, kind=GRAIN1, steps=10, **options):
    tag = "".join(f"-{k}{v}" for k, v in options.items())
    key = f"{pattern}-D{D}-S{S}-W{width}-T{steps}-{kind[0][:3]}{tag}"
    return dict(key=key, runtime="pallas_step", D=D,
                options=dict(steps_per_launch=S, **options),
                graph=_graph_spec(pattern, *kind, width=width, steps=steps, fanout=3, seed=7))


CASES = (
    [_case(p, D, S, W) for p in ("fft", "tree") for D in (2, 4, 8) for S in (1, 8)
     for W in (16, 32)]
    + [_case("fft", D, S, 32, MEMORY) for D in (2, 4, 8) for S in (1, 8)]
    + [_case("tree", 4, S, 32, MEMORY) for S in (1, 8)]
    + [_case("spread", D, S, 32) for D in (2, 4, 8) for S in (1, 4)]
    + [_case("spread", 4, S, 16) for S in (1, 4)]
    + [_case("spread", 4, S, 32, MEMORY) for S in (1, 4)]
    + [_case("all_to_all", D, S, 32, psum_mean=m) for D in (2, 4, 8) for S in (1, 4)
       for m in (True, False)]
    + [_case("all_to_all", 4, S, 32, MEMORY, psum_mean=m) for S in (1, 4)
       for m in (True, False)]
    # before the pattern has mixed every row into every other (a butterfly
    # after log2 W steps, spread after ~log3 W), where rows still differ: a
    # wrong partner or a shard's wrong rows shows here at any tolerance
    + [_case(p, D, S, 32, steps=5) for p in ("fft", "tree") for D in (4, 8) for S in (1, 8)]
    + [_case("spread", D, S, 32, steps=3) for D in (4, 8) for S in (1, 4)])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(CASES, 8, tmp_path_factory.mktemp("ref_plans"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psum(case) -> bool:
    """all_to_all under psum_mean on its per-step plan: the row mean, whose
    sum order depends on D."""
    g = case["graph"]
    return (g["pattern"] == "all_to_all" and case["options"].get("psum_mean", True)
            and case["options"]["steps_per_launch"] == 1)


def _run(case, init, D=None, **extra):
    g = _port_graph(case["graph"])
    devices = ["cpu"] * (D or case["D"])
    return get_runtime("pallas_step", devices=devices,
                       **dict(case["options"], **extra)).execute(g, init)


@pytest.mark.parametrize("case", CASES, ids=[c["key"] for c in CASES])
def test_plans_on_shards_match_the_reference(case, ref):
    arrays, meta = ref
    key = case["key"]
    g = _port_graph(case["graph"])
    rt = get_runtime("pallas_step", devices=["cpu"] * case["D"], **case["options"])
    assert rt.supports(g) == (meta[key]["ok"], meta[key]["why"]) == (True, "")
    assert rt.dispatches_per_run(g) == meta[key]["dispatches"]
    plan = rt._schedule_for_graph(g)
    if g.pattern in ("fft", "tree"):
        assert plan.kind == ("stride" if case["options"]["steps_per_launch"] == 1
                             else "allgather")
    init = arrays[f"{key}/init"]
    got = rt.execute(g, init)
    tol = MEMORY_TOL if g.kernel.kind == "memory_bound" else COMPUTE_TOL
    np.testing.assert_allclose(got, arrays[f"{key}/out"], err_msg=key, **tol)
    one = _run(case, init, D=1)
    if _psum(case):
        np.testing.assert_allclose(got, one, err_msg=key, **tol)
    else:
        assert np.array_equal(got, one), (key, np.abs(got - one).max())


STRIDE_CASES = [c for c in CASES if c["graph"]["pattern"] in ("fft", "tree")
                and c["options"]["steps_per_launch"] == 1]
GATHER_CASES = [c for c in CASES if not _psum(c) and (
    c["graph"]["pattern"] in ("spread", "all_to_all") or c["options"]["steps_per_launch"] > 1)]


@pytest.mark.parametrize("case", STRIDE_CASES, ids=[c["key"] for c in STRIDE_CASES])
def test_stride_transports_give_the_same_bits(case, ref):
    """``halo_impl`` "xla" (every block gathered once, the partner a view)
    and "ppermute" (one copy of the partner block) on the stride plan, and
    the gather / onehot ablations of its combine against ``pair``."""
    init = ref[0][f"{case['key']}/init"]
    got = _run(case, init)
    assert np.array_equal(got, _run(case, init, halo_impl="ppermute"))
    for combine in ("gather", "onehot"):
        assert np.array_equal(got, _run(case, init, combine=combine)), combine


@pytest.mark.parametrize("case", GATHER_CASES, ids=[c["key"] for c in GATHER_CASES])
def test_gather_transports_give_the_same_bits(case, ref, monkeypatch):
    """``gather_impl`` "xla", "ppermute" and "chunked" on the all-gather
    plan, per step and blocked; at D = 8 "chunked" at G = 2 and 4 too (the
    env tier of `choose_gather_chunk_group`), and "auto", which follows a
    ``halo_impl`` of "ppermute"."""
    init = ref[0][f"{case['key']}/init"]
    got = _run(case, init, gather_impl="xla")
    for impl in ("ppermute", "chunked", "auto"):
        assert np.array_equal(got, _run(case, init, gather_impl=impl)), impl
    assert np.array_equal(got, _run(case, init, halo_impl="ppermute"))
    if case["D"] == 8:
        for G in ("2", "4"):
            monkeypatch.setenv(schedule._GATHER_CHUNK_GROUP_ENV, G)
            assert np.array_equal(got, _run(case, init, gather_impl="chunked")), G


def test_gather_impl_option():
    """An explicit transport wins; "auto" follows a non-default
    ``halo_impl`` that names a gather transport, else asks
    `choose_gather_impl` (at D = 4 under the analytic model: "xla"); an
    unknown name is refused at construction."""
    rt = get_runtime("pallas_step", devices=["cpu"] * 4)
    assert rt._gather_impl(32) == "xla"
    assert get_runtime("pallas_step", devices=["cpu"] * 4,
                       gather_impl="chunked")._gather_impl(32) == "chunked"
    assert get_runtime("pallas_step", devices=["cpu"] * 4,
                       halo_impl="ppermute")._gather_impl(32) == "ppermute"
    with pytest.raises(ValueError, match="unknown gather impl"):
        get_runtime("pallas_step", devices=["cpu"] * 4, gather_impl="ring")


def test_chunked_gather_takes_the_chooser_group(monkeypatch):
    """`_halo._gather_chunked` with no group asks
    `schedule.choose_gather_chunk_group` at (D, B * D): an env G that does
    not divide D is refused there."""
    seen = []
    real = schedule.choose_gather_chunk_group

    def spy(**kw):
        seen.append(kw)
        return real(**kw)

    monkeypatch.setattr(schedule, "choose_gather_chunk_group", spy)
    mesh = _halo.ShardMesh(["cpu"] * 8)
    xs = [torch.full((1, 3, 2), float(d)) for d in range(8)]
    full = _halo.gather_global(xs, mesh, row_axis=1, impl="chunked")
    assert seen == [dict(devices=8, width=24)]
    assert all(torch.equal(f, torch.cat(xs, dim=1)) for f in full)
    monkeypatch.setenv(schedule._GATHER_CHUNK_GROUP_ENV, "3")
    with pytest.raises(ValueError, match="does not divide D=8"):
        _halo.gather_global(xs, mesh, row_axis=1, impl="chunked")


@pytest.mark.parametrize("S", [1, 4])
def test_chunked_gather_group_comes_from_the_runtime_model(monkeypatch, S):
    """``gather_impl="chunked"`` in ``pallas_step``: G is resolved once a
    build, under the runtime's ``cost_model`` (its measured "chunked:gG"
    walls at this D and W), and every gather of the run takes it."""
    from repro_torch.kernels.probes import CostModel

    model = CostModel(source="measured", exchange_row_steps=1.0, devices=8, gather_impl_us={
        "chunked:g2": {8: {32: 9.0}}, "chunked:g4": {8: {32: 3.0}}})
    asked, groups = [], []
    real_choose, real_gather = schedule.choose_gather_chunk_group, _halo.gather_global

    def choose(**kw):
        asked.append(kw)
        return real_choose(**kw)

    def gather(*args, **kw):
        groups.append(kw.get("chunk_group"))
        return real_gather(*args, **kw)

    monkeypatch.setattr(schedule, "choose_gather_chunk_group", choose)
    monkeypatch.setattr(_halo, "gather_global", gather)
    g = _port_graph(_graph_spec("spread", *GRAIN1, width=32, steps=6, fanout=3))
    rt = get_runtime("pallas_step", devices=["cpu"] * 8, steps_per_launch=S,
                     gather_impl="chunked", cost_model=model)
    got = rt.execute(g, None)
    assert [kw["model"] for kw in asked] == [model]
    assert asked[0]["devices"] == 8 and asked[0]["width"] == 32
    assert groups and set(groups) == {4}
    assert np.array_equal(got, get_runtime("pallas_step", devices=["cpu"] * 8,
                                           steps_per_launch=S,
                                           gather_impl="xla").execute(g, None))


@pytest.mark.parametrize("pattern,S", [("fft", 1), ("fft", 8), ("tree", 1), ("spread", 1),
                                       ("spread", 4), ("all_to_all", 1)])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_a_run_launches_d_times_one_shards_count(monkeypatch, pattern, S, D):
    """``dispatches_per_run`` is one shard's K3 and K4 launches: a run over
    D shards calls the step kernel's wrapper D times as often."""
    calls = [0]
    real = ps._kops.taskbench_step

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    monkeypatch.setattr(ps._kops, "taskbench_step", counted)
    g = _port_graph(_graph_spec(pattern, *GRAIN1, width=32, steps=10, fanout=3))
    rt = get_runtime("pallas_step", devices=["cpu"] * D, steps_per_launch=S)
    run = rt.build(g)
    run.stage(rt._init(g, None))
    calls[0] = 0
    run.inner(run._held)
    assert calls[0] == D * rt.dispatches_per_run(g)


def test_every_shard_keeps_its_own_tensor():
    """A sharded run of each plan takes and gives D separate (B, P) shard
    tensors; the blocked all-gather plan's output is each shard's own rows
    of its K4 launch, not a view of another shard's."""
    for pattern, S in (("fft", 1), ("fft", 8), ("spread", 1), ("all_to_all", 1)):
        g = _port_graph(_graph_spec(pattern, *GRAIN1, width=32, steps=6, fanout=3))
        rt = get_runtime("pallas_step", devices=["cpu"] * 4, steps_per_launch=S)
        out = rt._build_eager(g)(rt._split(rt._init(g, None)))
        assert isinstance(out, tuple) and len(out) == 4
        assert all(t.shape == (8, 8) for t in out)
        assert len({t.untyped_storage().data_ptr() for t in out}) == 4
