"""Atomic, async-capable tensor-tree checkpointing.

The port of ``repro.checkpoint.checkpointer``, in its on-disk format, so a
checkpoint written by either package restores in the other:
``<dir>/step_<n:08d>/arrays.npz`` + ``manifest.json`` (``step``, the leaf
``keys`` in order, ``extra``, and the sha256 ``checksum`` of arrays.npz),
written to a ``.tmp`` directory and renamed into place, so a half-written
checkpoint can never be restored. The npz keys are the reference's key-path
strings: dict keys (sorted, as JAX flattens a dict), list and tuple indices
and ``.field`` for a namedtuple, joined by "/". ``keep`` bounds disk usage;
``async_save`` copies every leaf to the host on the caller's thread and
writes on a worker thread.

Restore takes a tree of tensors (or numpy arrays) as the structure donor
and places each leaf on its target leaf's device, or on ``device`` where the
target leaf is a meta tensor (a shape and dtype with no storage).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: manifest checksum algorithm (content digest of arrays.npz)
CHECKSUM_ALGO = "sha256"


def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container node in flattening order, None for
    a leaf: dicts by sorted key, namedtuples by ``.field``, lists and
    tuples by index."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """The tree's leaves as (key path, leaf) in the reference's order; None
    is an empty subtree."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in kids:
        out.extend(_flatten(child, prefix + (key,)))
    return out


def _map_leaves(fn: Callable[[str, Any], Any], tree: Any, prefix: Tuple[str, ...] = ()):
    """The tree rebuilt with ``fn(key path, leaf)`` at each leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _map_leaves(fn, v, prefix + (str(k),))) for k, v in tree.items())
    kids = _children(tree)
    if kids is None:
        return fn("/".join(prefix), tree)
    vals = [_map_leaves(fn, v, prefix + (k,)) for k, v in kids]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array of its own (never a view of a tensor the
    caller may write next)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        host = [(k, _to_host(v)) for k, v in _flatten(tree)]  # device -> host
        return self._write(step, host, extra or {})

    def async_save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()  # one in flight at a time
        host = [(k, _to_host(v)) for k, v in _flatten(tree)]  # transfer on caller
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: List[Tuple[str, np.ndarray]], extra: Dict) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        arrays_path = os.path.join(tmp, "arrays.npz")
        np.savez(arrays_path, **{k: v for k, v in flat})
        manifest = {
            "step": step,
            "keys": [k for k, _ in flat],
            "extra": extra,
            # content digest: restore refuses a checkpoint whose bytes
            # don't match what save() published (bit rot, torn copy)
            "checksum": {"algo": CHECKSUM_ALGO, "digest": _file_digest(arrays_path)},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict]:
        """``target``: a tree of tensors or numpy arrays (structure donor).
        Each leaf comes back as its target leaf's type and dtype, a tensor
        on its target's device (``device``, default the CPU, for a meta
        tensor). Refuses a corrupt or truncated file and a shape mismatch
        with ValueError."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        arrays_path = os.path.join(path, "arrays.npz")
        # verify the content digest BEFORE deserializing (manifests written
        # before checksums existed, with no "checksum" key, restore as before)
        recorded = manifest.get("checksum")
        if recorded is not None:
            actual = _file_digest(arrays_path)
            if actual != recorded["digest"]:
                raise ValueError(
                    f"corrupt checkpoint {arrays_path}: {recorded['algo']} digest "
                    f"{actual} != recorded {recorded['digest']}")
        try:
            data = np.load(arrays_path)
        except Exception as e:
            raise ValueError(
                f"corrupt checkpoint {arrays_path}: unreadable npz ({e})") from e

        def place(key: str, tgt):
            try:
                arr = data[key]
            except Exception as e:
                raise ValueError(
                    f"corrupt checkpoint {arrays_path}: leaf {key!r} unreadable ({e})") from e
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape} != {tgt.shape}")
            if not torch.is_tensor(tgt):
                return arr.astype(np.asarray(tgt).dtype)
            dev = device if tgt.is_meta else tgt.device
            return torch.from_numpy(np.array(arr)).to(
                device=dev if dev is not None else "cpu", dtype=tgt.dtype)

        tree = _map_leaves(place, target)
        return tree, manifest["extra"]
