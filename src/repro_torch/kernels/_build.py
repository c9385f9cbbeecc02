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
and only then counts the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from functools import cache
from pathlib import Path
from typing import Dict

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
    "taskbench_compute": ("taskbench_compute", (_P, _P, _L, _I, _P)),
    "memory_bound": ("memory_bound", (_P, _P, _I, _I, _I, _I, _P)),
    "taskbench_step": ("taskbench_step",
                       (_P, _P, _P, _P) + (_I,) * 9 + (_P,)),
    "taskbench_blocked": ("taskbench_blocked", (_P,) * 6 + (_I,) * 10 + (_P,)),
    # K5's two forms, counted apart: bf16 on the tensor cores, f32 FMAs
    "flash_attention": ("flash_attention", (_P,) * 4 + (_I,) * 8 + (_F, _P)),
    "flash_attention_f32": ("flash_attention_f32", (_P,) * 4 + (_I,) * 8 + (_F, _P)),
    "decode_attention": ("decode_attention",
                         (_P,) * 7 + (_I,) * 6 + (_F, _I, _I, _I, _P)),
    "ssd_chunk": ("ssd_chunk", (_P,) * 7 + (_I,) * 7 + (_P,)),
    "rmsnorm": ("rmsnorm", (_P,) * 3 + (_I, _I, _F, _I, _I, _P)),
}

#: Successful kernel launches per C entry, the wrappers' launch counters.
#: `reset_launches` sets them to 0; nothing else writes them but `launch`.
LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


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
    names = sorted({lib for lib, _ in ENTRIES.values()})
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
    for entry, (owner, argtypes) in ENTRIES.items():
        if owner == name:
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    lib.tb_error_string.argtypes = [ctypes.c_int]
    lib.tb_error_string.restype = ctypes.c_char_p
    return lib


def launch(entry: str, *args) -> None:
    """Call C entry ``entry``; raise if the launch was refused, else count it."""
    lib = _library(ENTRIES[entry][0])
    err = getattr(lib, entry)(*args)
    if err != 0:
        msg = lib.tb_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: {msg} ({err})")
    LAUNCHES[entry] += 1
