"""``pallas_step``'s ensembles over row shards on the CPU, against the
reference's on as many forced host devices (the runner of
``test_torch_shards_rungs``): tuple ensembles at D = 2, 4 and 8 (mixed
plans, widths and horizons, grain 1 and memory_bound, S = 1 and 4), stacked
ensembles on the (row, member) mesh at (D, Dk) = (4, 2), (4, 4), (8, 2) and
(8, 4), ``member_shards="auto"``, and both launch plans at D = 4 with an
eviction and an admission.

Tolerances: compute ``rtol=1e-5, atol=1e-6`` of the reference, memory_bound
``atol=1e-5``; within the port, bit for bit: a member-sharded run equals
the replicated run on Dr = D / Dk devices (and on D), a tuple equals its
one-device run, and a launch plan stepped without edits equals
``build_ensemble``. The port counts the launches it makes: at Dk > 1 the
pipeline gate reads the member slice's block W / Dr, where the
reference's ``ensemble_dispatches_per_run`` reads W / D
(`test_the_port_counts_the_launches_it_makes_at_dk_2` pins the case).
"""
import numpy as np
import pytest
import torch

from test_torch_shards_rungs import (COMPUTE_TOL, MEMORY_TOL, _graph_spec, _port_graph,
                                     run_reference)
from repro_torch.core import GraphEnsemble, get_runtime
from repro_torch.kernels import ops


def _m(pattern, width, steps, seed, kind="compute_bound", iters=1):
    return _graph_spec(pattern, kind, iters, width=width, steps=steps, radius=2, seed=seed)


#: halo, stride and all-gather members of four widths and five horizons
TUPLE_MIXED = [_m("stencil_1d", 32, 7, 0), _m("fft", 64, 5, 1), _m("spread", 16, 6, 2),
               _m("nearest", 48, 4, 3), _m("no_comm", 32, 3, 4, "memory_bound", 2)]
#: every member on the halo plan (the blocked cadence), mixed widths and kernels
TUPLE_HALO = [_m("stencil_1d", 32, 9, 0), _m("nearest", 64, 7, 1),
              _m("dom", 16, 5, 2, "memory_bound", 2), _m("random_nearest", 32, 8, 3)]
#: K = 4 stacked members of radii 1 and 2 (read through the radius-2 window)
STACKED = [_m(p, 32, t, k) for k, (p, t) in enumerate(
    (("stencil_1d", 9), ("nearest", 7), ("stencil_1d_periodic", 4), ("random_nearest", 1)))]
STACKED_MEMORY = [_m("nearest", 32, t, k, "memory_bound", 2) for k, t in enumerate((6, 5, 6, 2))]
#: the measured D = 4 model "auto" prices the split under
MODEL_D4 = dict(source="measured", exchange_row_steps=512.0, launch_us=50.0, row_step_us=0.1,
                halo_exchange_us={"xla": 51.2}, platform="cpu", devices=4, payload=8)


def _case(key, D, members, **options):
    return dict(key=key, runtime="pallas_step", D=D, options=options, members=members)


TUPLES = [_case(f"tuple-{name}-D{D}-S{S}", D, members, steps_per_launch=S)
          for name, members in (("mixed", TUPLE_MIXED), ("halo", TUPLE_HALO))
          for D in (2, 4, 8) for S in (1, 4)]
STACKS = [_case(f"stacked-D{D}-dk{dk}-S{S}", D, STACKED, steps_per_launch=S, member_shards=dk)
          for D, dk in ((4, 2), (4, 4), (8, 2), (8, 4)) for S in (1, 3)] + [
    _case("stacked-memory-D4-dk2", 4, STACKED_MEMORY, member_shards=2),
    _case("stacked-D4-dk2-S3-serial", 4, STACKED, steps_per_launch=3, member_shards=2,
          pipeline=False)]
AUTOS = [_case(f"auto-{name}", 4, STACKED, member_shards="auto", cost_model=model)
         for name, model in (("measured", MODEL_D4), ("analytic", {"source": "analytic",
                                                                    "exchange_row_steps": 512.0}))]
#: K = 4 stencil_1d at W = 16, D = 4, Dk = 2, S = 2, T = 9: W/Dr = 8 > 2*S*r
W16 = _case("w16-count", 4, [_graph_spec("stencil_1d", "compute_bound", 1, width=16, steps=9,
                                         radius=1, seed=k) for k in range(4)],
            steps_per_launch=2, member_shards=2)
PLAN_STACKED = [_m("nearest", 32, t, k) for k, t in enumerate((9, 9, 8, 1))]
#: the launch plans' edits: evict member 1 from launch l, admit a fresh
#: member (its init from seed 99) into the finished slot at the last launch.
#: The reference's stacked plan cannot admit at Dk > 1 (its ``admit_fn``
#: places the one-member init with the K-sharded spec; ROADMAP.md Queue 3),
#: so there it only evicts, and the port's admission is held to the t = 0
#: launch of the fresh init.
PLANS = [dict(_case(f"plan-stacked-dk{dk}-S{S}", 4, PLAN_STACKED, steps_per_launch=S,
                    member_shards=dk),
              plan=dict(evict=[1, 1], **({"admit": [L - 1, 3, 99]} if dk == 1 else {})),
              admit=[L - 1, 3, 99])
         for dk in (1, 2) for S, L in ((1, 8), (3, 3))] + [
    dict(_case("plan-stepwise", 4, TUPLE_MIXED), plan=dict(evict=[2, 1], admit=[5, 4, 99]),
         admit=[5, 4, 99])]
CASES = TUPLES + STACKS + AUTOS + [W16] + PLANS


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(CASES, 8, tmp_path_factory.mktemp("ref_ensembles"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def launches(monkeypatch):
    """The K3 and K4 launches the port issues, counted at its wrappers
    (on the CPU the plain versions run under them)."""
    seen = [0]

    def counting(fn):
        def wrapped(*args, **kw):
            seen[0] += 1
            return fn(*args, **kw)
        return wrapped

    for name in ("taskbench_step", "taskbench_boundary", "taskbench_interior"):
        monkeypatch.setattr(ops, name, counting(getattr(ops, name)))
    return seen


def _ensemble(case):
    return GraphEnsemble([_port_graph(m) for m in case["members"]])


def _inits(case, arrays):
    return [arrays[f"{case['key']}/init{k}"] for k in range(len(case["members"]))]


def _rt(D, **options):
    return get_runtime("pallas_step", devices=["cpu"] * D, **options)


def _held_to_reference(case, outs, arrays):
    for k, (g, got) in enumerate(zip(_ensemble(case).members, outs)):
        tol = MEMORY_TOL if g.kernel.kind == "memory_bound" else COMPUTE_TOL
        np.testing.assert_allclose(np.asarray(got), arrays[f"{case['key']}/out{k}"],
                                   err_msg=f"{case['key']} member {k}", **tol)


def _bitwise(a, b, what):
    for k, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), f"{what}: member {k}"


@pytest.mark.parametrize("case", TUPLES, ids=[c["key"] for c in TUPLES])
def test_tuple_ensembles_on_shards(case, ref, launches):
    """Each member on its own plan over the D shards (B_k = W_k / D): the
    verdicts and the per-shard launch count the reference's, every member
    within tolerance of the reference's run, bit for bit the one-device
    run, and D times the per-shard count launched."""
    arrays, meta = ref
    ens, D = _ensemble(case), case["D"]
    rt = _rt(D, **case["options"])
    assert rt.supports_ensemble(ens) == (meta[case["key"]]["ok"], meta[case["key"]]["why"])
    assert not rt._is_stacked(ens)
    assert rt.ensemble_dispatches_per_run(ens) == meta[case["key"]]["dispatches"]
    launches[0] = 0
    outs = rt.execute_ensemble(ens, _inits(case, arrays))
    assert launches[0] == D * rt.ensemble_dispatches_per_run(ens)
    _held_to_reference(case, outs, arrays)
    one = get_runtime("pallas_step", device="cpu", **case["options"])
    _bitwise(outs, one.execute_ensemble(ens, _inits(case, arrays)), "against D = 1")


@pytest.mark.parametrize("case", STACKS, ids=[c["key"] for c in STACKS])
def test_stacked_ensembles_on_the_row_member_mesh(case, ref, launches):
    """Member slice j (K/Dk members) on ring j of Dr = D / Dk shards: the
    resolved Dk and depth the reference's, every member within tolerance of
    the reference's run and bit for bit the replicated runs on Dr and on D
    devices; D times the per-shard count launched, which is the
    reference's wherever its gate (W / D) and the slice's (W / Dr) agree."""
    arrays, meta = ref
    key, D = case["key"], case["D"]
    ens = _ensemble(case)
    rt = _rt(D, **case["options"])
    dk = case["options"]["member_shards"]
    assert rt._is_stacked(ens) and rt._member_shards(ens) == meta[key]["member_shards"] == dk
    S = rt._ensemble_steps_per_launch(ens)
    assert S == meta[key]["steps_per_launch"]
    assert [len(c) for c in rt._member_devices(ens)] == [D // dk] * len(ens.members)
    launches[0] = 0
    outs = rt.execute_ensemble(ens, _inits(case, arrays))
    count = rt.ensemble_dispatches_per_run(ens)
    assert launches[0] == D * count
    H, W = 2, ens.members[0].width
    gate = lambda B: S > 1 and rt._pipeline_requested() and B > 2 * S * H  # noqa: E731
    if gate(W // D) == gate(W // (D // dk)):
        assert count == meta[key]["dispatches"]
    _held_to_reference(case, outs, arrays)
    options = dict(case["options"], member_shards=1)
    _bitwise(outs, _rt(D // dk, **options).execute_ensemble(ens, _inits(case, arrays)),
             f"{key} against the replicated run on Dr = {D // dk}")
    _bitwise(outs, _rt(D, **options).execute_ensemble(ens, _inits(case, arrays)),
             f"{key} against the replicated run on D = {D}")


@pytest.mark.parametrize("case", AUTOS, ids=[c["key"] for c in AUTOS])
def test_auto_member_shards_takes_the_references_split(case, ref):
    """``member_shards="auto"``: the measured D = 4 model splits K = 4 two
    ways (both candidates take one hop, so the moved rows decide), the
    analytic one keeps Dk = 1, as the reference's; the run is bit for bit
    its explicit twin and within tolerance of the reference's."""
    arrays, meta = ref
    ens = _ensemble(case)
    rt = _rt(4, **case["options"])
    dk, why = rt._auto_member_shards(ens)
    assert dk == rt._member_shards(ens) == meta[case["key"]]["member_shards"]
    assert dk == (2 if case["key"] == "auto-measured" else 1), why
    outs = rt.execute_ensemble(ens, _inits(case, arrays))
    _held_to_reference(case, outs, arrays)
    twin = _rt(4, member_shards=dk).execute_ensemble(ens, _inits(case, arrays))
    _bitwise(outs, twin, "against its explicit twin")


def test_the_port_counts_the_launches_it_makes_at_dk_2(ref, launches):
    """K = 4 stencil_1d at W = 16 over D = 4, Dk = 2, S = 2, T = 9: each
    slice's block W / Dr = 8 keeps an interior past 2*S*r = 4, so the run
    pipelines: 1 + 2 * 4 = 9 launches a shard, as counted. The reference's
    ``ensemble_dispatches_per_run`` gates on W / D = 4 and counts 5, while
    its run pipelines too (ROADMAP.md Queue 3)."""
    arrays, meta = ref
    ens = _ensemble(W16)
    rt = _rt(4, **W16["options"])
    assert meta["w16-count"]["dispatches"] == 5
    assert rt.ensemble_dispatches_per_run(ens) == 9
    launches[0] = 0
    outs = rt.execute_ensemble(ens, _inits(W16, arrays))
    assert launches[0] == 4 * 9
    _held_to_reference(W16, outs, arrays)
    serial = _rt(4, **dict(W16["options"], pipeline=False))
    assert serial.ensemble_dispatches_per_run(ens) == 5
    _bitwise(outs, serial.execute_ensemble(ens, _inits(W16, arrays)), "pipelined vs serial")


def _step_plan(lp, inits, acts, admit=None):
    carry = lp.init_fn(inits)
    for l in range(lp.num_launches):
        if admit is not None and l == admit[0]:
            carry = lp.admit_fn(carry, admit[1], admit[2])
        carry = lp.launch_fn(carry, acts[l], lp.launch_t0(l))
    return lp.finalize(carry)


@pytest.mark.parametrize("case", PLANS, ids=[c["key"] for c in PLANS])
def test_launch_plans_on_shards(case, ref):
    """The launch plans at D = 4 (stacked at Dk = 1 and 2, S = 1 and 3;
    stepwise on the mixed tuple): kind, depth, launches and act rows the
    reference's; stepped without edits bit for bit ``build_ensemble``;
    with member 1 evicted and a fresh member admitted into a finished slot,
    within tolerance of the reference's plan under the same edits, the
    evicted member bit for bit its own run at its cut horizon; editing and
    admitting capture nothing."""
    arrays, meta = ref
    key = case["key"]
    ens = _ensemble(case)
    rt = _rt(4, **case["options"])
    lp = rt.build_ensemble_launches(ens)
    want = meta[key]["plan"]
    assert (lp.kind, lp.steps_per_launch, lp.num_launches) == (
        want["kind"], want["S"], want["launches"])
    xs = [torch.from_numpy(x) for x in _inits(case, arrays)]
    _bitwise(_step_plan(lp, xs, lp.acts), rt.build_ensemble(ens)(tuple(xs)),
             f"{key} against build_ensemble")
    if lp.kind == "stacked":
        _bitwise(_step_plan(lp, xs, torch.from_numpy(lp.acts)),
                 rt.build_ensemble(ens)(tuple(xs)), f"{key}, act rows as tensors")
    before = lp.compile_counter()
    l_evict, evicted = case["plan"]["evict"]
    acts = lp.acts.copy()
    acts[l_evict:, evicted, :] = 0
    np.testing.assert_array_equal(acts, np.asarray(want["acts"], np.float32))
    admit = case["admit"]
    g = ens.members[admit[1]]
    fresh = (torch.from_numpy(arrays[f"{key}/fresh"]) if "admit" in case["plan"] else
             torch.from_numpy(np.random.default_rng(admit[2]).uniform(
                 0.1, 1.0, (g.width, g.payload)).astype(np.float32)))
    outs = _step_plan(lp, xs, acts, admit=(admit[0], admit[1], fresh))
    assert lp.compile_counter() == before
    if "admit" in case["plan"]:
        _held_to_reference(case, outs, arrays)
    else:
        _held_to_reference(case, outs[:admit[1]], arrays)
        t0, _ = get_runtime("pallas_step", device="cpu")._halo_step_fns(g)
        np.testing.assert_array_equal(outs[admit[1]].numpy(), t0(fresh[None])[0].numpy())
    cut = dict(case["members"][evicted], steps=1 + l_evict * lp.steps_per_launch)
    alone = get_runtime("pallas_step", device="cpu",
                        steps_per_launch=lp.steps_per_launch).execute(
        _port_graph(cut), xs[evicted].numpy())
    np.testing.assert_array_equal(outs[evicted].numpy(), alone)


def test_member_shards_refuses_a_split_that_does_not_divide():
    """Dk = 3: over K = 4 members, and over D = 4 devices at K = 3, refused
    with the reference's words, naming member_shards=1 as the fallback;
    every other int below 1 refused too."""
    from repro.core import GraphEnsemble as RefEnsemble
    from repro.core import get_runtime as ref_runtime
    from repro.launch.mesh import make_row_member_mesh as ref_mesh

    from repro_torch.launch.mesh import make_row_member_mesh

    four = _ensemble(dict(members=STACKED))
    three = GraphEnsemble(four.members[:3])
    rt = _rt(4, member_shards=3)
    with pytest.raises(ValueError) as ours:
        rt.execute_ensemble(four)
    ref_four = RefEnsemble([_ref_graph(m) for m in STACKED])
    with pytest.raises(ValueError) as theirs:
        ref_runtime("pallas_step", member_shards=3)._member_shards(ref_four)
    assert str(ours.value) == str(theirs.value) and "member_shards=1" in str(ours.value)
    with pytest.raises(ValueError) as ours:
        rt.execute_ensemble(three)
    with pytest.raises(ValueError) as theirs:
        ref_mesh([object()] * 4, 3)
    assert str(ours.value) == str(theirs.value) and "member_shards=1" in str(ours.value)
    with pytest.raises(ValueError) as direct:
        make_row_member_mesh(["cpu"] * 4, 3)
    assert str(direct.value) == str(theirs.value)
    with pytest.raises(ValueError, match="member_shards must be >= 1"):
        _rt(4, member_shards=-1).execute_ensemble(four)


def _ref_graph(spec):
    from repro.core import KernelSpec as RefSpec
    from repro.core import TaskGraph as RefGraph

    spec = dict(spec)
    return RefGraph(kernel=RefSpec(**spec.pop("kernel")), **spec)


def test_the_rings_own_their_streams_and_span_every_shard():
    """The (row, member) mesh of D = 8 names at Dk = 2 two rings of four
    devices, ``devices[j::Dk]``; each ring is its own mesh (its own
    streams on a card, joins indexed inside the ring), and a runtime makes
    one mesh per Dk."""
    from repro_torch.launch.mesh import make_row_member_mesh

    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = make_row_member_mesh(devs, 2)
    assert [r.devices for r in mesh.rings] == [tuple(devs[0::2]), tuple(devs[1::2])]
    assert mesh.rings[0] is not mesh.rings[1]
    rt = _rt(8, member_shards=2)
    assert rt._row_member_mesh(2) is rt._row_member_mesh(2)
    assert rt._row_member_mesh(1).rings == [rt.mesh]
