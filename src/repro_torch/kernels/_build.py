"""Build the port's CUDA kernels with nvcc and call them through ctypes.

Each source ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/repro_torch/<digest>/lib<name>.so`` at the root of the
checkout. The digest covers every file under ``csrc/`` and the nvcc flags,
so a changed source rebuilds and an unchanged one is loaded as built. The
libraries build at first use, all sources at once (one nvcc process each,
started together); nothing is built or imported when this module is
imported, so the CPU tests import it freely.

Every C entry takes pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; `launch` raises on a non-zero code
and only then counts the launch (and records the CTAs a wrapper says it
launched, `LAST_CTAS`).

Launch accounting under CUDA-graph replay. A replayed graph calls no
wrapper, so a run's launches are counted in two steps. While a graph is
built (`building`: the warm-up run before capture, and the capture itself)
`launch` counts into `BUILD_LAUNCHES` and into the build's own record, not
into `LAUNCHES`; each replay then adds the capture's record to `LAUNCHES`
(`replayed`). So a run's delta of `LAUNCHES` is the same whether its loop
was issued eagerly or replayed from a graph. `CAPTURES` counts the graphs
captured (the counterpart of the reference's ``compile_counter``).
`HOST_CALLS` counts the host calls that issue a run's device work: graph
replays (one each in `replayed`) and the per-task backend's eager task
calls (`task_called`), so a run's delta equals its runtime's
``host_calls_per_run``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from functools import cache
from pathlib import Path
from typing import Dict, Iterator, List, Optional

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: C entry -> (library, argument types). The entry is named after the
#: Python wrapper that calls it.
ENTRIES = {
    "taskbench_compute": ("taskbench_compute", (_P, _P, _L) + (_I,) * 4 + (_P,)),
    "memory_bound": ("memory_bound", (_P, _P, _I, _I, _I, _I, _P)),
    "taskbench_step": ("taskbench_step",
                       (_P, _P, _P, _P) + (_I,) * 12 + (_P,)),
    # K4's three forms, counted apart: cooperative (any table, the memory
    # body), tiled (fixed tables of a known reach) and resident (any table,
    # one cluster a column slice)
    "taskbench_blocked": ("taskbench_blocked", (_P,) * 6 + (_I,) * 10 + (_P,)),
    "taskbench_blocked_tiled": ("taskbench_blocked", (_P,) * 5 + (_I,) * 10 + (_P,)),
    "taskbench_blocked_resident": ("taskbench_blocked", (_P,) * 5 + (_I,) * 13 + (_P,)),
    # K5's two forms, counted apart: bf16 on the tensor cores, f32 FMAs
    "flash_attention": ("flash_attention", (_P,) * 4 + (_I,) * 8 + (_F, _P)),
    "flash_attention_f32": ("flash_attention_f32", (_P,) * 4 + (_I,) * 8 + (_F, _P)),
    "decode_attention": ("decode_attention",
                         (_P,) * 7 + (_I,) * 6 + (_F, _I, _I, _I, _P)),
    "ssd_chunk": ("ssd_chunk", (_P,) * 7 + (_I,) * 7 + (_P,)),
    "rmsnorm": ("rmsnorm", (_P,) * 3 + (_I, _I, _F, _I, _I, _I, _P)),
}
#: C entries that launch nothing and answer a question about a launch
#: (`query`): K7's head blocks per (chunk, group) at a shape; the clusters
#: of a size K4's resident form holds at once on the current device.
QUERIES = {
    "ssd_chunk_plan": ("ssd_chunk", (_I,) * 7),
    "taskbench_blocked_resident_clusters": ("taskbench_blocked", (_I,)),
}
#: C entries that launch a probe (`probe`): a kernel of no work, the launch
#: floor the yardsticks time, and the FMA's dependent latency in cycles. Not
#: kernels of the port; their launches are not counted.
PROBES = {
    "launch_floor": ("launch_floor", (_I, _I, _P)),
    "fma_latency": ("launch_floor", (_P, _P, _I, _P)),
}

#: Kernel launches per C entry, the wrappers' launch counters: each
#: successful launch outside a graph build, and each replay's captured ones.
#: `reset_launches` sets them to 0; nothing else writes them but `launch`
#: and `replayed`.
LAUNCHES: Counter = Counter()
#: Launches made while building a graph (its warm-up run and its capture),
#: per C entry; kept out of `LAUNCHES`.
BUILD_LAUNCHES: Counter = Counter()
#: Graphs captured, under the key "graphs".
CAPTURES: Counter = Counter()
#: Host calls that issued device work: graph replays and the per-task
#: backend's eager task calls.
HOST_CALLS = 0
#: The CTAs of each C entry's last launch, where its wrapper passes them
#: (K1, K3: the launch plan it handed the entry).
LAST_CTAS: Dict[str, int] = {}
#: The records of the builds under way, innermost last.
_BUILDS: List[Counter] = []


def reset_launches() -> None:
    global HOST_CALLS
    LAUNCHES.clear()
    BUILD_LAUNCHES.clear()
    CAPTURES.clear()
    HOST_CALLS = 0


@contextlib.contextmanager
def building() -> Iterator[Counter]:
    """Count the launches made inside into `BUILD_LAUNCHES` and into the
    yielded record (per C entry), not into `LAUNCHES`."""
    rec: Counter = Counter()
    _BUILDS.append(rec)
    try:
        yield rec
    finally:
        _BUILDS.pop()


def captured() -> None:
    """Count one captured graph."""
    CAPTURES["graphs"] += 1


def replayed(record: Counter) -> None:
    """Add one replay of a graph whose capture launched ``record``."""
    global HOST_CALLS
    LAUNCHES.update(record)
    HOST_CALLS += 1


def task_called() -> None:
    """Count one eager task call of the per-task backend (``serialized``)."""
    global HOST_CALLS
    HOST_CALLS += 1


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def library_path(name: str) -> Path:
    return BUILD_ROOT / _digest() / f"lib{name}.so"


def build_all() -> Dict[str, str]:
    """Build every library that is not built yet, in parallel.

    Returns {library: nvcc output} for the libraries built by this call
    (``-Xptxas -v`` prints each kernel's registers and shared memory
    there); an already built library is absent from the result. Raises
    with nvcc's output if any build fails.
    """
    names = sorted({lib for lib, _ in (*ENTRIES.values(), *PROBES.values())})
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    out_dir = library_path(todo[0]).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        # build under a temporary name, then rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        logs[n] = log
        if p.returncode != 0:
            failed.append(n)
            os.unlink(tmp)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed))
    return logs


@cache
def _library(name: str) -> ctypes.CDLL:
    build_all()
    lib = ctypes.CDLL(str(library_path(name)))
    for entry, (owner, argtypes) in {**ENTRIES, **QUERIES, **PROBES}.items():
        if owner == name:
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    lib.tb_error_string.argtypes = [ctypes.c_int]
    lib.tb_error_string.restype = ctypes.c_char_p
    return lib


def launch(entry: str, *args, ctas: Optional[int] = None) -> None:
    """Call C entry ``entry``; raise if the launch was refused, else count it
    (and record ``ctas``, the grid the wrapper planned, in `LAST_CTAS`)."""
    lib = _library(ENTRIES[entry][0])
    err = getattr(lib, entry)(*args)
    if err != 0:
        msg = lib.tb_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: {msg} ({err})")
    if _BUILDS:
        _BUILDS[-1][entry] += 1
        BUILD_LAUNCHES[entry] += 1
    else:
        LAUNCHES[entry] += 1
    if ctas is not None:
        LAST_CTAS[entry] = ctas


def probe(entry: str, *args) -> None:
    """Call C entry ``entry`` of PROBES; raise if the launch was refused
    (counts no launch)."""
    lib = _library(PROBES[entry][0])
    err = getattr(lib, entry)(*args)
    if err != 0:
        msg = lib.tb_error_string(err).decode()
        raise RuntimeError(f"CUDA probe {entry} failed to launch: {msg} ({err})")


def query(entry: str, *args) -> int:
    """Call C entry ``entry`` of QUERIES and return its answer (counts no
    launch)."""
    return getattr(_library(QUERIES[entry][0]), entry)(*args)
