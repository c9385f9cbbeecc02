"""``pallas_step``'s halo plan over 4 row shards of W = 16 (B = 4), 2 shards
of W = 16 and 64, and 8 shards of W = 32, on the CPU, against the
reference's on as many forced host devices (the runner of
``test_torch_shards_rungs``).

B = 4 keeps no interior at any depth, so the pipeline gates itself off and
every blocked launch is serial; S = 4 and 8 at r = 1, and every S > 1 at
r = 2, reach past the block: the multi-hop exchange. The 8-shard cases
cross two blocks (the reference's ``test_pallas_step_deep_halo_multihop_8
_devices``). Grain 1 (where the dataflow shows) on the six halo patterns
and a memory_bound case per depth; the verdicts, ``dispatches_per_run``
(the reference's per-shard count) and the results within the reference
tests' tolerances; the pipelined request bit for bit the serial one, and
``halo_impl`` "xla" bit for bit "ppermute"; the stacked ensemble of mixed
horizons.
"""
import numpy as np
import pytest
import torch

from test_torch_shards_rungs import (COMPUTE_TOL, MEMORY_TOL, _graph_spec, _port_graph,
                                     run_reference)
from repro_torch.core import GraphEnsemble, get_runtime

HALO = (("stencil_1d", 1), ("stencil_1d_periodic", 1), ("dom", 1), ("nearest", 2),
        ("random_nearest", 2), ("no_comm", 1))
DEPTHS = (1, 3, 4, 8)


def _spec(pattern, radius, width, kind="compute_bound", iters=1, steps=10):
    return _graph_spec(pattern, kind, iters, width=width, steps=steps, radius=radius, seed=7)


def cases_at(width):
    out = []
    for pattern, r in HALO:
        for S in DEPTHS:
            for pipe in (True, False):
                out.append(dict(key=f"{pattern}-W{width}-S{S}-pipe{pipe}", runtime="pallas_step",
                                D=4, options=dict(steps_per_launch=S, pipeline=pipe),
                                graph=_spec(pattern, r, width)))
    for S in (1, 4):
        out.append(dict(key=f"memory-W{width}-S{S}", runtime="pallas_step", D=4,
                        options=dict(steps_per_launch=S),
                        graph=_spec("nearest", 2, width, "memory_bound", 2)))
    members = [_spec("stencil_1d", 1, width, steps=t) for t in (3, 10, 6)]
    for k, m in enumerate(members):
        m["seed"] = k
    for S in (1, 4):
        for pipe in (True, False):
            out.append(dict(key=f"ens-W{width}-S{S}-pipe{pipe}", runtime="pallas_step", D=4,
                            options=dict(steps_per_launch=S, pipeline=pipe), members=members))
    return out


CASES = cases_at(16) + [
    dict(key=f"multihop-{p}-S{S}", runtime="pallas_step", D=8,
         options=dict(steps_per_launch=S), graph=_spec(p, r, 32, iters=1, steps=16))
    for p, r, S in (("stencil_1d", 1, 8), ("nearest", 2, 4), ("random_nearest", 2, 8))] + [
    # two shards: B = 8 (multi-hop at S = 8) and B = 32 (pipelined at S = 3)
    dict(key=f"D2-{p}-W{w}-S{S}-pipe{pipe}", runtime="pallas_step", D=2,
         options=dict(steps_per_launch=S, pipeline=pipe), graph=_spec(p, r, w))
    for p, r in HALO for w, S, pipe in ((16, 1, True), (16, 8, True), (64, 3, True),
                                       (64, 3, False))]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(CASES, 8, tmp_path_factory.mktemp("ref_pallas16"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_graph_case(case, ref):
    """The verdict, the launch count and the result against the reference's;
    the run with ``halo_impl="ppermute"`` equal bit for bit; returns the
    output."""
    arrays, meta = ref
    key = case["key"]
    g = _port_graph(case["graph"])
    rt = get_runtime("pallas_step", devices=["cpu"] * case["D"], **case["options"])
    assert rt.supports(g) == (meta[key]["ok"], meta[key]["why"])
    assert rt.dispatches_per_run(g) == meta[key]["dispatches"]
    got = rt.execute(g, arrays[f"{key}/init"])
    tol = MEMORY_TOL if g.kernel.kind == "memory_bound" else COMPUTE_TOL
    np.testing.assert_allclose(got, arrays[f"{key}/out"], err_msg=key, **tol)
    other = get_runtime("pallas_step", devices=["cpu"] * case["D"], halo_impl="ppermute",
                        **case["options"]).execute(g, arrays[f"{key}/init"])
    assert np.array_equal(got, other), key
    return got


SINGLE = [c for c in CASES if "graph" in c]
ENSEMBLES = [c for c in CASES if "members" in c]


@pytest.mark.parametrize("case", SINGLE, ids=[c["key"] for c in SINGLE])
def test_halo_plan_on_shards_matches_the_reference(case, ref):
    got = check_graph_case(case, ref)
    twin = case["key"].replace("pipeTrue", "pipeFalse")
    if twin != case["key"]:  # the pipelined request, bit for bit the serial one
        want = get_runtime("pallas_step", devices=["cpu"] * case["D"],
                           **dict(case["options"], pipeline=False)).execute(
            _port_graph(case["graph"]), ref[0][f"{case['key']}/init"])
        assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ENSEMBLES, ids=[c["key"] for c in ENSEMBLES])
def test_stacked_ensemble_on_shards_matches_the_reference(case, ref):
    """K = 3 stencil_1d members of horizons 3, 10, 6 in one stacked launch
    a step (or a blocked launch, members frozen mid-launch by their act
    rows), each member against the reference's same ensemble run; the
    launch count the reference's."""
    arrays, meta = ref
    key = case["key"]
    ens = GraphEnsemble([_port_graph(m) for m in case["members"]])
    rt = get_runtime("pallas_step", devices=["cpu"] * 4, **case["options"])
    assert rt.supports_ensemble(ens) == (meta[key]["ok"], meta[key]["why"])
    assert rt.stacking_verdict(ens)[0]
    assert rt.ensemble_dispatches_per_run(ens) == meta[key]["dispatches"]
    inits = [arrays[f"{key}/init{k}"] for k in range(3)]
    outs = rt.execute_ensemble(ens, inits)
    for k, got in enumerate(outs):
        np.testing.assert_allclose(got, arrays[f"{key}/out{k}"], err_msg=f"{key} {k}",
                                   **COMPUTE_TOL)
    serial = get_runtime("pallas_step", devices=["cpu"] * 4,
                         **dict(case["options"], pipeline=False)).execute_ensemble(ens, inits)
    assert all(np.array_equal(a, b) for a, b in zip(outs, serial))


@pytest.mark.parametrize("D,width,pattern", [(4, 32, "nearest"), (4, 32, "no_comm"),
                                             (16, 16, "nearest")])
def test_s1_steps_between_two_extended_buffers_a_shard(D, width, pattern):
    """At S = 1 each shard's state lives in the owned rows of a persistent
    (H + B + H)-row buffer, which the exchange fills at both ends (at D =
    16, B = 1 < H = 2: the chain) and K3 reads whole; the result equals
    the one-device run within the tolerance at grain 1."""
    from repro_torch.core import KernelSpec, TaskGraph

    g = TaskGraph(steps=9, width=width, pattern=pattern, payload=8, radius=2,
                  kernel=KernelSpec("compute_bound", 1), seed=5)
    rt = get_runtime("pallas_step", devices=["cpu"] * D)
    x = rt._init(g, None)
    out = rt._build_eager(g)(rt._split(x))
    B, H = width // D, 0 if pattern == "no_comm" else 2
    assert all(t.shape == (B, 8) for t in out)
    assert all(t.untyped_storage().nbytes() == (B + 2 * H) * 8 * 4 for t in out)
    want = get_runtime("fused", device="cpu").execute(g, x.numpy())
    np.testing.assert_allclose(torch.cat(out).numpy(), want, **COMPUTE_TOL)


def test_k3_writes_into_out():
    """K3's ``out=``: the step written into the given contiguous buffer (on
    the CPU, the plain version copied there), equal to the step without
    it; a buffer of another shape, or not contiguous, is refused."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    x = torch.rand((1, 12, 8), generator=gen)
    idx = torch.zeros((1, 1, 1), dtype=torch.int32)
    wgt = torch.rand((1, 8, 5), generator=gen)
    kw = dict(kind="compute_bound", iterations=1, scratch=0, combine="window")
    want = ops.taskbench_step(x, idx, wgt, **kw)
    buf = torch.full((1, 12, 8), float("nan"))
    got = ops.taskbench_step(x, idx, wgt, out=buf[:, 2:10], **kw)
    assert got.data_ptr() == buf[:, 2:10].data_ptr() and torch.equal(got, want)
    assert torch.isnan(buf[:, :2]).all() and torch.isnan(buf[:, 10:]).all()
    with pytest.raises(ValueError, match="contiguous"):
        ops.taskbench_step(x, idx, wgt, out=torch.empty((2, 12, 8))[:, 2:10], **kw)
