"""``pallas_step``'s halo plan over 4 row shards of W = 128 (B = 32) on the
CPU, against the reference's on 4 forced host devices (the runner of
``test_torch_shards_rungs``), and ``steps_per_launch="auto"`` there under
an explicit cost model whose halo exchange costs something.

B = 32 keeps an interior at S = 3 (r = 1, 2) and S = 4, 8 (r = 1), so the
pipelined schedule runs there: the boundary launch, the next launch's edge
exchange started on its outputs, the interior launch under it. The
pipelined run equals the serial one bit for bit, and ``halo_impl`` "xla"
equals "ppermute" bit for bit; each equals the reference's within the
tolerances, with the reference's verdicts and per-shard launch counts
(1 + 2 (L - 1) pipelined). "auto" resolves each model to the reference's
(plan, S, pipelined) and launch count, its reason naming the depth and the
schedule, and its run equals its explicit twin's bit for bit.
"""
import numpy as np
import pytest
import torch

from test_torch_shards_pallas import _spec, cases_at, check_graph_case
from test_torch_shards_rungs import COMPUTE_TOL, _port_graph, run_reference
from repro_torch.core import GraphEnsemble, get_runtime
from repro_torch.core.patterns import halo_radius
from repro_torch.kernels.probes import CostModel

#: measured models at D = 4 whose exchange costs X row-steps: 1 (free: the
#: serial schedule), 40 and 400 (the interior must cover it)
MODELS = {X: CostModel(source="measured", exchange_row_steps=float(X), launch_us=2.0,
                       row_step_us=0.01, halo_exchange_us={"xla": 0.01 * X,
                                                           "ppermute": 0.012 * X},
                       platform="cpu", devices=4, payload=8).to_dict()
          for X in (1, 40, 400)}
AUTO = [dict(key=f"auto-X{X}-{p}-T{T}", runtime="pallas_step", D=4, reason=True,
             options=dict(steps_per_launch="auto", cost_model=MODELS[X]),
             graph=_spec(p, r, 128, steps=T))
        for X in MODELS for p, r in (("stencil_1d", 1), ("nearest", 2), ("dom", 1))
        for T in (10, 40)]
CASES = cases_at(128) + AUTO
SINGLE = [c for c in CASES if "graph" in c and "reason" not in c]
ENSEMBLES = [c for c in CASES if "members" in c]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(CASES, 4, tmp_path_factory.mktemp("ref_pallas128"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", SINGLE, ids=[c["key"] for c in SINGLE])
def test_halo_plan_on_shards_matches_the_reference(case, ref):
    got = check_graph_case(case, ref)
    opts = case["options"]
    if opts.get("pipeline") and opts["steps_per_launch"] > 1:
        g = _port_graph(case["graph"])
        rt = get_runtime("pallas_step", devices=["cpu"] * 4, **opts)
        B, H = 32, halo_radius(g)
        assert rt._pipeline_active(B, opts["steps_per_launch"], H, g.payload) == \
            (H > 0 and B > 2 * opts["steps_per_launch"] * H)
        serial = get_runtime("pallas_step", devices=["cpu"] * 4,
                             **dict(opts, pipeline=False)).execute(g, ref[0][f"{case['key']}/init"])
        assert np.array_equal(got, serial)


@pytest.mark.parametrize("case", ENSEMBLES, ids=[c["key"] for c in ENSEMBLES])
def test_stacked_ensemble_pipelined_on_shards(case, ref):
    """The stacked K = 3 ensemble at B = 32: pipelined at S = 4 (one boundary
    launch for both edges of all members, one interior launch), the
    reference's results and launch counts, bit for bit the serial run."""
    arrays, meta = ref
    key = case["key"]
    ens = GraphEnsemble([_port_graph(m) for m in case["members"]])
    rt = get_runtime("pallas_step", devices=["cpu"] * 4, **case["options"])
    assert rt.ensemble_dispatches_per_run(ens) == meta[key]["dispatches"]
    inits = [arrays[f"{key}/init{k}"] for k in range(3)]
    outs = rt.execute_ensemble(ens, inits)
    for k, got in enumerate(outs):
        np.testing.assert_allclose(got, arrays[f"{key}/out{k}"], **COMPUTE_TOL)
    serial = get_runtime("pallas_step", devices=["cpu"] * 4,
                         **dict(case["options"], pipeline=False)).execute_ensemble(ens, inits)
    assert all(np.array_equal(a, b) for a, b in zip(outs, serial))


@pytest.mark.parametrize("case", AUTO, ids=[c["key"] for c in AUTO])
def test_auto_on_shards_resolves_as_the_reference(case, ref):
    arrays, meta = ref
    key = case["key"]
    g = _port_graph(case["graph"])
    rt = get_runtime("pallas_step", devices=["cpu"] * 4, **case["options"])
    got = rt._schedule_for_graph(g)
    kind, S, _ = meta[key]["plan"]
    assert (got.kind, got.steps_per_launch) == (kind, S)
    assert got.reason.startswith(f"auto -> S={S}"), got.reason
    assert rt.dispatches_per_run(g) == meta[key]["dispatches"]
    H = halo_radius(g)
    piped = rt._pipeline_active(32, S, H, g.payload)
    assert (", pipelined:" in got.reason) == piped, got.reason
    launches = -(-(g.steps - 1) // S)  # blocked launches after the t = 0 one
    assert meta[key]["dispatches"] == 1 + (2 if piped else 1) * launches
    out = rt.execute(g, arrays[f"{key}/init"])
    np.testing.assert_allclose(out, arrays[f"{key}/out"], **COMPUTE_TOL)
    opts = dict(case["options"], steps_per_launch=S, pipeline=piped)
    twin = get_runtime("pallas_step", devices=["cpu"] * 4, **opts).execute(
        g, arrays[f"{key}/init"])
    assert np.array_equal(out, twin)
