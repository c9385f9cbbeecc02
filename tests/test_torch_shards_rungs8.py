"""``bsp``, ``bsp_scan`` and ``overlap`` over 8 row shards, ``overlap``'s
options and the rungs' ensembles over 4, on the CPU, against the
reference's same backend on as many forced host devices (the runner and
the comparison of ``test_torch_shards_rungs``: grain 1 and memory_bound,
verdicts and reasons, the reference tests' tolerances, host calls).

The ensembles hold mixed patterns and horizons (a member frozen from the
start), stacked and ragged: ``bsp`` calls each member's superstep in turn
(round robin), ``bsp_scan`` and ``overlap`` step every member in one
program and mask the frozen ones.
"""
import numpy as np
import pytest
import torch

from test_torch_shards_rungs import (BACKENDS, COMPUTE_TOL, KINDS, MEMORY_TOL, PATTERNS,
                                     _graph_spec, _port_graph, check_case, run_reference)
from repro_torch.core import GraphEnsemble, get_runtime

OVERLAP_OPTIONS = ({"overlap": False}, {"halo_via": "allgather"},
                   {"overlap": False, "halo_via": "allgather"})
HALO = ("no_comm", "stencil_1d", "stencil_1d_periodic", "dom", "nearest", "random_nearest")


def _ensembles():
    """(name, member specs): mixed patterns and horizons over W = 32, and a
    ragged mix of widths and payloads, at grain 1 and one memory member."""
    mixed = [_graph_spec(p, "compute_bound", 1, steps=t, seed=k)
             for k, (p, t) in enumerate((("stencil_1d", 6), ("nearest", 4), ("dom", 1),
                                         ("random_nearest", 3)))]
    ragged = [dict(_graph_spec("stencil_1d", "compute_bound", 1, steps=5), width=16),
              dict(_graph_spec("nearest", "memory_bound", 2, steps=3), width=64, payload=4),
              _graph_spec("stencil_1d_periodic", "compute_bound", 1, steps=6)]
    glob = [_graph_spec(p, "compute_bound", 1, steps=t, seed=k)
            for k, (p, t) in enumerate((("fft", 5), ("spread", 4), ("all_to_all", 6),
                                        ("trivial", 2)))]
    return {"mixed": mixed, "ragged": ragged, "global": glob}


CASES = (
    [dict(key=f"{b}-{p}-{k}-D8", runtime=b, D=8, options={}, graph=_graph_spec(p, *KINDS[k]))
     for b in BACKENDS for p in PATTERNS for k in KINDS]
    + [dict(key=f"overlap{sorted(o.items())}-{p}-{k}-D4", runtime="overlap", D=4, options=o,
            graph=_graph_spec(p, *KINDS[k]))
       for o in OVERLAP_OPTIONS for p in HALO for k in KINDS]
    + [dict(key=f"{b}-ens-{name}-D4", runtime=b, D=4, options={}, members=members)
       for b in BACKENDS for name, members in _ensembles().items()]
)
SINGLE = [c for c in CASES if "graph" in c]
ENSEMBLES = [c for c in CASES if "members" in c]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(CASES, 8, tmp_path_factory.mktemp("ref8"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", SINGLE, ids=[c["key"] for c in SINGLE])
def test_rung_on_shards_matches_the_reference(case, ref):
    check_case(case, ref)


@pytest.mark.parametrize("case", ENSEMBLES, ids=[c["key"] for c in ENSEMBLES])
def test_ensemble_on_shards_matches_the_reference(case, ref):
    """Each member of an ensemble over 4 shards against the reference's run
    of the same ensemble on 4 devices; the verdict, and the host calls
    against the reference's ensemble dispatch count."""
    arrays, meta = ref
    key = case["key"]
    ens = GraphEnsemble([_port_graph(m) for m in case["members"]])
    rt = get_runtime(case["runtime"], devices=["cpu"] * 4)
    assert rt.supports_ensemble(ens) == (meta[key]["ok"], meta[key]["why"])
    if not meta[key]["ok"]:
        return
    inits = [arrays[f"{key}/init{k}"] for k in range(len(ens.members))]
    for uk in (False, True):
        outs = get_runtime(case["runtime"], devices=["cpu"] * 4,
                           use_kernels=uk).execute_ensemble(ens, inits)
        for k, (g, got) in enumerate(zip(ens.members, outs)):
            tol = MEMORY_TOL if g.kernel.kind == "memory_bound" else COMPUTE_TOL
            np.testing.assert_allclose(got, arrays[f"{key}/out{k}"], err_msg=f"{key} {k}",
                                       **tol)
    assert rt.host_calls_per_run(ens) == meta[key]["dispatches"]
