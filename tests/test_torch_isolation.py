"""The PyTorch port stands alone: importing every module of ``repro_torch``
loads no JAX and no module of the JAX package ``repro``, and the chip smoke
script imports neither.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (this file's own process may hold both; the child may not)
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert {"repro_torch.core.runtimes.pallas_step", "repro_torch.kernels._build",
            "repro_torch.kernels.ops", "repro_torch.core.metg",
            "repro_torch.launch.serve", "repro_torch.models.model",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention", "repro_torch.kernels.ssd_scan",
            "repro_torch.kernels.rmsnorm", "repro_torch.models.ssm",
            "repro_torch.launch.attention_times"} <= set(got["modules"])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_port_sources_and_chip_smoke_name_no_jax_or_reference_module():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, f


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory (or with no card) it exits non-zero and prints
    no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(lone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
