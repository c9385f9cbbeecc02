"""The port's checkpoint/restart (``repro_torch.checkpoint``) against the JAX
package's, on the CPU.

The reference's ``tests/test_checkpoint.py`` cases run here against the
port, all but those that need the trainer or the data pipeline (in
``tests/test_torch_trainer.py``) or a device mesh (ROADMAP Queue 1 item 12,
slice 23): the round trip, ``keep``, ``async_save``,
a shape mismatch, no ``.tmp`` left behind, the restart drill bit for bit an
uninterrupted run, the restart budget, the content checksum, corrupt and
truncated files, a manifest from before checksums, and the fallback past a
corrupt checkpoint. The on-disk format is the reference's: a checkpoint
written by either package restores in the other, bit for bit, with the same
manifest keys. ``run_with_restarts`` over a stacked launch plan's launches
(S = 1 and 4) equals the uninterrupted plan bit for bit, the corrupt-newest
fallback included; and again at grain 1 and T <= 7, where the states lie far
from the FMA's fixed point 0.2 and a wrong restore shows in the bits.
"""
import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.elastic import FailureInjector, SimulatedFailure, run_with_restarts
from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime

Pair = collections.namedtuple("Pair", "lo hi")


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=g),
        "b": {"c": torch.arange(6, dtype=torch.int32), "d": torch.tensor(3.5)},
    }


def _equal(x, y):
    for a, b in zip(jax.tree.leaves(x, is_leaf=torch.is_tensor),
                    jax.tree.leaves(y, is_leaf=torch.is_tensor)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _corrupt(path, at=30, data=b"\xde\xad\xbe\xef"):
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.seek(at)
        f.write(data)


# ------------------------------------------------------ the reference's cases


def test_save_restore_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    t = tree()
    ckpt.save(5, t, {"note": "x"})
    restored, extra = ckpt.restore(t)
    assert extra["note"] == "x"
    assert restored["b"]["c"].dtype == torch.int32 and restored["b"]["d"].shape == ()
    _equal(t, restored)


def test_keep_gc(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, tree())
    assert ckpt.all_steps() == [3, 4]


def test_async_save_copies_on_the_callers_thread(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    t = tree(1)
    want = t["a"].clone()
    ckpt.async_save(7, t)
    t["a"].add_(1.0)  # the caller writes its state on; the save holds the copy
    ckpt.wait()
    restored, _ = ckpt.restore(t)
    np.testing.assert_array_equal(restored["a"].numpy(), want.numpy())


def test_restore_shape_mismatch_raises(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, tree())
    bad = {"a": torch.zeros((3, 3)), "b": {"c": torch.zeros(6, dtype=torch.int32),
                                           "d": torch.tensor(0.0)}}
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(bad)


def test_atomicity_no_tmp_dirs_left(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, tree())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def _init():
    return {"x": torch.zeros(4), "step_sum": torch.tensor(0.0)}


def _step(state, step):
    return {"x": state["x"] + step, "step_sum": state["step_sum"] + step * 0.5}


def test_run_with_restarts_identical_to_uninterrupted(tmp_path):
    final_a, restarts_a = run_with_restarts(
        total_steps=17, ckpt=Checkpointer(str(tmp_path / "a")), ckpt_every=5,
        init_state=_init, step_fn=_step, injector=FailureInjector((7, 13)))
    assert restarts_a == 2
    final_b, restarts_b = run_with_restarts(
        total_steps=17, ckpt=Checkpointer(str(tmp_path / "b")), ckpt_every=5,
        init_state=_init, step_fn=_step)
    assert restarts_b == 0
    _equal(final_a, final_b)


def test_injector_exhausts_restarts(tmp_path):
    def step_fn(state, step):
        raise SimulatedFailure("always")

    with pytest.raises(SimulatedFailure):
        run_with_restarts(total_steps=3, ckpt=Checkpointer(str(tmp_path)), ckpt_every=1,
                          init_state=lambda: {"x": torch.zeros(())}, step_fn=step_fn,
                          max_restarts=2)


def test_manifest_records_content_checksum(tmp_path):
    path = Checkpointer(str(tmp_path)).save(1, tree())
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["checksum"]["algo"] == "sha256"
    assert len(manifest["checksum"]["digest"]) == 64


def test_restore_rejects_corrupt_checkpoint_loudly(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    t = tree()
    _corrupt(ckpt.save(1, t))
    with pytest.raises(ValueError) as exc:
        ckpt.restore(t, step=1)
    msg = str(exc.value)
    assert "arrays.npz" in msg and "sha256" in msg and "!=" in msg


@pytest.mark.parametrize("with_checksum", [True, False])
def test_restore_rejects_truncated_checkpoint(tmp_path, with_checksum):
    """Refused by the digest, and without one (a manifest from before
    checksums) by the unreadable npz."""
    ckpt = Checkpointer(str(tmp_path))
    t = tree()
    path = ckpt.save(1, t)
    if not with_checksum:
        mpath = os.path.join(path, "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        del manifest["checksum"]
        with open(mpath, "w") as f:
            json.dump(manifest, f)
    npz = os.path.join(path, "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        ckpt.restore(t, step=1)


def test_restore_accepts_pre_checksum_manifest(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    t = tree()
    path = ckpt.save(1, t)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["checksum"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    restored, _ = ckpt.restore(t, step=1)
    np.testing.assert_array_equal(restored["a"].numpy(), t["a"].numpy())


def test_run_with_restarts_falls_back_past_corrupt_checkpoint(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "a"), keep=0)

    class CorruptingInjector(FailureInjector):
        def maybe_fail(self, step):
            if step == 13 and 13 not in self.fired:  # chew the newest before dying
                _corrupt(os.path.join(ckpt.dir, f"step_{ckpt.latest_step():08d}"), 40,
                         b"\x00\x00\x00\x00")
            super().maybe_fail(step)

    final_a, restarts = run_with_restarts(
        total_steps=17, ckpt=ckpt, ckpt_every=5, init_state=_init, step_fn=_step,
        injector=CorruptingInjector((13,)))
    assert restarts == 1
    final_b, _ = run_with_restarts(
        total_steps=17, ckpt=Checkpointer(str(tmp_path / "b")), ckpt_every=5,
        init_state=_init, step_fn=_step)
    _equal(final_a, final_b)


def test_simulated_failure_is_an_injected_fault():
    from repro_torch.resilience import InjectedFault

    assert issubclass(SimulatedFailure, InjectedFault)


# ----------------------------------------------------------- across packages


def _mixed_tree(seed=0):
    """Dicts (keys out of order), a list, a tuple, a namedtuple, a 0-d
    leaf, int and float dtypes, and a None (an empty subtree)."""
    g = torch.Generator().manual_seed(seed)
    return {"z": [torch.randn((3, 2), generator=g), (torch.arange(4), torch.tensor(2.5))],
            "a": Pair(torch.rand(5, generator=g), torch.ones((2, 2), dtype=torch.int32)),
            "m": {"k": torch.randn((2, 3, 4), generator=g)}, "n": None}


def _as_jax(t):
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()) if torch.is_tensor(x) else x, t,
                        is_leaf=torch.is_tensor)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    t = _mixed_tree()
    path = Checkpointer(str(tmp_path)).save(3, t, {"who": "port"})
    got, extra = RefCheckpointer(str(tmp_path)).restore(_as_jax(_mixed_tree(1)))
    assert extra == {"who": "port"}
    _equal(got, _as_jax(t))
    with open(os.path.join(path, "manifest.json")) as f:
        keys = json.load(f)["keys"]
    assert keys == ["a/.lo", "a/.hi", "m/k", "z/0", "z/1/0", "z/1/1"]
    assert keys == sorted(np.load(os.path.join(path, "arrays.npz")).files, key=keys.index)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    t = _mixed_tree()
    RefCheckpointer(str(tmp_path), keep=2).save(4, _as_jax(t), {"who": "ref"})
    ckpt = Checkpointer(str(tmp_path))
    got, extra = ckpt.restore(_mixed_tree(1))
    assert extra == {"who": "ref"} and ckpt.latest_step() == 4
    assert isinstance(got["a"], Pair) and got["n"] is None
    assert got["a"].hi.dtype == torch.int32 and got["z"][1][1].shape == ()
    _equal(got, t)
    # a meta-tensor target (shapes and dtypes only) lands on ``device``
    meta = jax.tree.map(lambda x: x.to("meta"), _mixed_tree(), is_leaf=torch.is_tensor)
    got, _ = ckpt.restore(meta, device="cpu")
    assert all(x.device.type == "cpu" for x in jax.tree.leaves(got, is_leaf=torch.is_tensor))
    _equal(got, t)


# ---------------------------------------------- restarts over a launch plan


@pytest.mark.parametrize("S", [1, 4])
def test_run_with_restarts_over_a_launch_plan(tmp_path, S):
    """The step function is one launch of a stacked plan; two failures and
    a corrupted newest checkpoint (keep=2: the restore falls back to the
    one before) end bit for bit the uninterrupted plan."""
    members = tuple(TaskGraph(steps=t, width=16, pattern="nearest", radius=2, payload=8,
                              kernel=KernelSpec("compute_bound", 1), seed=k)
                    for k, t in enumerate((21, 17, 9)))
    ens = GraphEnsemble(members)
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=S)
    lp = rt.build_ensemble_launches(ens)
    xs = rt._ensemble_inits(ens)
    acts = torch.from_numpy(lp.acts)
    L = lp.num_launches

    def init_state():
        return lp.init_fn(xs)

    def step_fn(carry, l):
        return lp.launch_fn(carry, acts[l], lp.launch_t0(l))

    ckpt = Checkpointer(str(tmp_path / "a"), keep=2)
    every = 2 if S > 1 else 4
    fail_at = (L // 2, L - 1)

    class CorruptingInjector(FailureInjector):
        def maybe_fail(self, step):
            if step == fail_at[1] and step not in self.fired:
                _corrupt(os.path.join(ckpt.dir, f"step_{ckpt.latest_step():08d}"))
            super().maybe_fail(step)

    final, restarts = run_with_restarts(total_steps=L, ckpt=ckpt, ckpt_every=every,
                                        init_state=init_state, step_fn=step_fn,
                                        injector=CorruptingInjector(fail_at))
    assert restarts == 2 and ckpt.all_steps()[-1] == L
    carry = init_state()
    for l in range(L):
        carry = step_fn(carry, l)
    for a, b, c in zip(lp.finalize(final), lp.finalize(carry), rt.build_ensemble(ens)(xs)):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_run_with_restarts_inside_the_contraction_horizon(tmp_path):
    """The same drill at grain 1 and T <= 7, where every state still lies
    far from the FMA's fixed point 0.2: a restore from the wrong checkpoint
    or a launch run twice would show in the bits."""
    members = tuple(TaskGraph(steps=t, width=16, pattern="nearest", radius=2, payload=8,
                              kernel=KernelSpec("compute_bound", 1), seed=k)
                    for k, t in enumerate((7, 6, 5)))
    ens = GraphEnsemble(members)
    rt = get_runtime("pallas_step", device="cpu", steps_per_launch=1)
    lp = rt.build_ensemble_launches(ens)
    xs = rt._ensemble_inits(ens)
    rows = lp.act_rows()
    L = lp.num_launches
    calls = []

    def init_state():
        return lp.init_fn(xs)

    def step_fn(carry, l):
        calls.append(l)
        return lp.launch_fn(carry, rows[l], lp.launch_t0(l))

    ckpt = Checkpointer(str(tmp_path / "a"), keep=2)
    fail_at = (3, 5)

    class CorruptingInjector(FailureInjector):
        def maybe_fail(self, step):
            if step == fail_at[1] and step not in self.fired:
                _corrupt(os.path.join(ckpt.dir, f"step_{ckpt.latest_step():08d}"))
            super().maybe_fail(step)

    final, restarts = run_with_restarts(total_steps=L, ckpt=ckpt, ckpt_every=2,
                                        init_state=init_state, step_fn=step_fn,
                                        injector=CorruptingInjector(fail_at))
    assert (L, restarts) == (6, 2) and len(calls) > L
    want = rt.build_ensemble(ens)(xs)
    dist = min(float((w - 0.2).abs().max()) for w in want)
    assert dist >= 1e-3, f"the uninterrupted run is {dist:.3g} from 0.2: no dataflow shows"
    for a, b in zip(lp.finalize(final), want):
        assert torch.equal(a, b)
