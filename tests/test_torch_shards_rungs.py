"""``bsp``, ``bsp_scan`` and ``overlap`` over D = 2 and 4 row shards on the
CPU, against the reference's same backend on as many forced host devices.

The reference's side runs in one subprocess (``XLA_FLAGS=
--xla_force_host_platform_device_count=8``, never set in the pytest
process) that writes every case's initial state and result to ``.npz``;
the port's side runs here over ``devices=["cpu"] * D``, fed the
reference's initial states. Every pattern, at grain 1 and memory_bound,
where the dataflow shows in the result (at grain 8 the body's fixed point
hides a wrong exchange): the same ``supports`` verdicts and reasons, the
results within the reference tests' tolerances (compute ``rtol=1e-5,
atol=1e-6``; memory_bound ``atol=1e-5``), ``host_calls_per_run`` equal to
the reference's ``dispatches_per_run``, and ``dispatches_per_run`` (one
shard's device operations) equal to the operations counted, the
transports' apart.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import _halo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATTERNS = ["trivial", "no_comm", "stencil_1d", "stencil_1d_periodic", "dom",
            "tree", "fft", "all_to_all", "nearest", "spread", "random_nearest"]
KINDS = {"grain1": ("compute_bound", 1), "memory": ("memory_bound", 2)}
BACKENDS = ("bsp", "bsp_scan", "overlap")
COMPUTE_TOL = dict(rtol=1e-5, atol=1e-6)
MEMORY_TOL = dict(rtol=0, atol=1e-5)

#: the reference's case runner: one JSON list of cases in, every case's
#: verdict, counts, initial state(s) and result(s) out
REF_RUNNER = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
from repro.core.task_kernels import initial_state

def graph(spec):
    spec = dict(spec)
    return TaskGraph(kernel=KernelSpec(**spec.pop("kernel")), **spec)

cases = json.load(open(sys.argv[1]))
arrays, meta = {}, {}
for c in cases:
    rt = get_runtime(c["runtime"], devices=jax.devices()[:c["D"]], **c["options"])
    key = c["key"]
    if "members" in c:
        ens = GraphEnsemble([graph(m) for m in c["members"]])
        ok, why = rt.supports_ensemble(ens)
        meta[key] = {"ok": ok, "why": why}
        if ok:
            inits = [np.asarray(initial_state(g.width, g.payload, g.seed)) for g in ens.members]
            if "plan" in c:  # the launch plan stepped on the host, with its edits
                lp = rt.build_ensemble_launches(ens)
                acts = np.array(lp.acts)
                evict, admit = c["plan"].get("evict"), c["plan"].get("admit")
                if evict:
                    acts[evict[0]:, evict[1], :] = 0
                if admit:
                    g = ens.members[admit[1]]
                    arrays[f"{key}/fresh"] = np.asarray(initial_state(g.width, g.payload, admit[2]))
                carry = lp.init_fn(tuple(jnp.asarray(x) for x in inits))
                for l in range(lp.num_launches):
                    if admit and l == admit[0]:
                        carry = lp.admit_fn(carry, admit[1], jnp.asarray(arrays[f"{key}/fresh"]))
                    carry = lp.launch_fn(carry, jnp.asarray(acts[l]),
                                         jnp.asarray(lp.launch_t0(l), jnp.int32))
                outs = lp.finalize(carry)
                meta[key]["plan"] = {"kind": lp.kind, "S": lp.steps_per_launch,
                                     "launches": lp.num_launches, "acts": acts.tolist()}
            else:
                outs = rt.execute_ensemble(ens, [jnp.asarray(x) for x in inits])
            for k, (x, o) in enumerate(zip(inits, outs)):
                arrays[f"{key}/init{k}"], arrays[f"{key}/out{k}"] = x, np.asarray(o)
            meta[key]["dispatches"] = rt.ensemble_dispatches_per_run(ens)
            if c["runtime"] == "pallas_step" and rt._is_stacked(ens):
                meta[key]["member_shards"] = rt._member_shards(ens)
                meta[key]["steps_per_launch"] = rt._ensemble_steps_per_launch(ens)
        continue
    g = graph(c["graph"])
    ok, why = rt.supports(g)
    meta[key] = {"ok": ok, "why": why}
    if ok:
        x = np.asarray(initial_state(g.width, g.payload, g.seed))
        arrays[f"{key}/init"], arrays[f"{key}/out"] = x, np.asarray(rt.execute(g, jnp.asarray(x)))
        meta[key]["dispatches"] = rt.dispatches_per_run(g)
        if c.get("reason"):
            meta[key]["plan"] = list(rt._schedule_for_graph(g))
np.savez(sys.argv[2], **arrays)
json.dump(meta, open(sys.argv[3], "w"))
"""


def run_reference(cases, devices: int, out_dir):
    """The reference's results of ``cases`` on ``devices`` forced host
    devices: (arrays, meta by case key)."""
    src, npz, meta = (os.path.join(str(out_dir), n) for n in ("cases.json", "ref.npz", "meta.json"))
    with open(src, "w") as f:
        json.dump(cases, f)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", REF_RUNNER, src, npz, meta],
                          capture_output=True, text=True, timeout=600, env=env)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(npz) as z:
        arrays = dict(z)
    with open(meta) as f:
        return arrays, json.load(f)


def _graph_spec(pattern, kind, iters, width=32, steps=5, **kw):
    return dict(dict(steps=steps, width=width, pattern=pattern, payload=8, radius=2, seed=3,
                     kernel=dict(kind=kind, iterations=iters, scratch=30)), **kw)


def _port_graph(spec):
    spec = dict(spec)
    return TaskGraph(kernel=KernelSpec(**spec.pop("kernel")), **spec)


CASES = [dict(key=f"{b}-{p}-{k}-D{D}", runtime=b, D=D, options={},
              graph=_graph_spec(p, *KINDS[k]))
         for D in (2, 4) for b in BACKENDS for p in PATTERNS for k in KINDS]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(CASES, 4, tmp_path_factory.mktemp("ref"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_case(case, ref, **port_options):
    """The port's run of ``case`` over D CPU shards against the reference's:
    the verdict and reason, and where supported the result (with and
    without the kernels' wrappers) and the host calls."""
    arrays, meta = ref
    key = case["key"]
    g = _port_graph(case["graph"])
    rt = get_runtime(case["runtime"], devices=["cpu"] * case["D"], **case["options"],
                     **port_options)
    assert rt.supports(g) == (meta[key]["ok"], meta[key]["why"])
    if not meta[key]["ok"]:
        return None
    tol = MEMORY_TOL if g.kernel.kind == "memory_bound" else COMPUTE_TOL
    want = arrays[f"{key}/out"]
    for uk in (False, True):
        got = get_runtime(case["runtime"], devices=["cpu"] * case["D"], use_kernels=uk,
                          **case["options"]).execute(g, arrays[f"{key}/init"])
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, err_msg=f"{key} uk={uk}", **tol)
    assert rt.host_calls_per_run(g) == meta[key]["dispatches"]
    return rt, g


@pytest.mark.parametrize("case", CASES, ids=[c["key"] for c in CASES])
def test_rung_on_shards_matches_the_reference(case, ref):
    check_case(case, ref)


class _OpCounter(TorchDispatchMode):
    """Device operations issued (views are not), with a pause for the
    transports' own copies."""

    def __init__(self):
        super().__init__()
        self.n, self.paused = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view and not self.paused
        return func(*args, **(kwargs or {}))


@pytest.fixture
def paused_transports():
    """Each registered transport wrapped so that the op counter in
    ``holder`` pauses while it runs (and, for the joins, while its
    receiving side assembles); restored after."""
    holder = {}
    saved = {kind: dict(reg) for kind, reg in _halo.TRANSPORT_REGISTRIES.items()}

    def paused(start):
        def run(*args, **kw):
            c = holder.get("counter")
            if c:
                c.paused += 1
            try:
                handle = start(*args, **kw)
            finally:
                if c:
                    c.paused -= 1
            join = handle.join

            def joined():
                if c:
                    c.paused += 1
                try:
                    return join()
                finally:
                    if c:
                        c.paused -= 1

            handle.join = joined
            return handle
        return run

    for kind, reg in saved.items():
        for name, start in reg.items():
            _halo.register_transport_impl(kind, name, paused(start), replace=True)
    yield holder
    for kind, reg in saved.items():
        for name, start in reg.items():
            _halo.register_transport_impl(kind, name, start, replace=True)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("backend,options", [("bsp", {}), ("bsp", {"donate": False}),
                                             ("bsp_scan", {}), ("overlap", {}),
                                             ("overlap", {"halo_via": "allgather"})])
def test_dispatches_count_one_shards_operations(paused_transports, backend, options, D):
    """``dispatches_per_run`` is one shard's device operations: a run over
    D shards issues D times as many, besides the transports' copies
    (paused here) and, for all_to_all, the one concatenation of the
    partial sums a step on the shards' device."""
    for pattern in PATTERNS:
        g = TaskGraph(steps=5, width=16, payload=4, radius=2, pattern=pattern,
                      kernel=KernelSpec("compute_bound", 3))
        rt = get_runtime(backend, devices=["cpu"] * D, **options)
        if not rt.supports(g)[0]:
            continue
        run = rt.build(g)
        run.stage(rt._init(g, None))
        with _OpCounter() as c:
            paused_transports["counter"] = c
            inner = run.inner
            if hasattr(inner, "run"):
                inner.run()
            else:
                inner(run._held)
        extra = (g.steps - 1) if pattern == "all_to_all" else 0
        assert c.n == D * rt.dispatches_per_run(g) + extra, (pattern, D)
