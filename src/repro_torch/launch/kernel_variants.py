"""Diagnostic builds of K7 on the card: where its time goes.

    PYTHONPATH=src python -m repro_torch.launch.kernel_variants [--only base,noY]

Each variant is ``csrc/ssd_chunk.cu`` with one edit, built with nvcc (the
port's flags) into ``build/kernel_variants/<name>/`` beside the checkout's
other builds, and called through ctypes at the serving prefills' chunks
(``kernel_times.SSD_SHAPES``) in f32 and bf16. The variants are timed in
turns, in order and again in reverse, on the same inputs:

  base     the kernel as it is
  cvt      TF32 rounding by ``cvt.rna.tf32.f32`` instead of integer ops
  nolo     one TF32 rounding of each operand, no residual products (the
           control that chip_smoke.py's check must fail)
  noexp    the decay mask's exponential left out
  noY      Y's products left out
  nostate  the state's products left out
  nosplit  the per-head split of an f32 X into TF32 parts left out
  noheads  the per-head loop left out: loads, cumsum and C B^T only

The time a part takes is the base's less that of the variant without it
(the parts overlap, so the differences need not add up). Every variant
but the base and cvt computes wrong outputs by design; ``scaled_err_y``
and ``scaled_err_state`` report by how much (nan where a part is
skipped). Prints one line per (shape, dtype, variant) and turn.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import torch

from repro_torch.kernels import _build, ref
from repro_torch.launch.attention_times import gpu_ms
from repro_torch.launch.kernel_times import SSD_SHAPES, card, scaled_err, ssd_inputs

SOURCE = _build.CSRC / "ssd_chunk.cu"
OUT = _build.BUILD_ROOT.parent / "kernel_variants"
TF32_INT = """__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}"""
TF32_CVT = """__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}"""
#: variant -> [(text of the source, its replacement)]
VARIANTS = {
    "base": [],
    "cvt": [(TF32_INT, TF32_CVT)],
    "nolo": [("constexpr bool kLoTerms = true;", "constexpr bool kLoTerms = false;")],
    "noexp": [("__expf(j0", "(j0"), ("-INFINITY", "0.f")],
    "noY": [("    {\n      float acc[8][4] = {};", "    if (false) {\n      float acc[8][4] = {};")],
    "nostate": [("for (int it = warp; it < mchunks * nchunks; it += WARPS) {",
                 "for (int it = warp; it < 0; it += WARPS) {")],
    "nosplit": [("      const int c4 = PP / 4;", "      const int c4 = 0;")],
    "noheads": [("  for (int hl = 0; hl < nh; ++hl) {", "  for (int hl = 0; hl < 0; ++hl) {")],
}


def build(names) -> dict:
    """Build each variant (nvcc processes started together); returns
    {name: ctypes library}. Raises if an edit does not apply or nvcc fails."""
    src = SOURCE.read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in {SOURCE.name}")
            text = text.replace(old, new)
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / SOURCE.name).write_text(text)
        shutil.copy(_build.CSRC / "error.cuh", d)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SOURCE.name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.ssd_chunk.argtypes = list(_build.ENTRIES["ssd_chunk"][1])
        lib.ssd_chunk.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device is available")
    names = args.only.split(",")
    libs = build(names)
    smi = card()
    for arch, shape in SSD_SHAPES.items():
        BC, H, G, T, N, P = shape
        for dtype in (torch.float32, torch.bfloat16):
            x, b, c, dta, dt = ssd_inputs(*shape, dtype)
            want = ref.ssd_chunk_plain(x, b, c, dta, dt)
            y = torch.empty_like(x)
            st = torch.empty((BC, H, N, P), device="cuda")
            for turn, name in enumerate(names + names[::-1]):
                lib = libs[name]

                def call():
                    err = lib.ssd_chunk(
                        x.data_ptr(), b.data_ptr(), c.data_ptr(), dta.data_ptr(),
                        dt.data_ptr(), y.data_ptr(), st.data_ptr(), BC, H, G, T, N, P,
                        0 if dtype == torch.float32 else 1,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name}: launch failed ({err})")

                y.fill_(float("nan"))  # a part a variant skips reads as nan
                st.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                rec = {"arch": arch, "shape_BC_H_G_T_N_P": list(shape),
                       "dtype": str(dtype).split(".")[-1], "variant": name, "turn": turn,
                       "ms": gpu_ms(call, 30),
                       "scaled_err_y": scaled_err(y, want[0]),
                       "scaled_err_state": scaled_err(st, want[1]),
                       "card": smi}
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
