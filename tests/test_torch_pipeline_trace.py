"""``benchmarks/torch_pipeline_trace.py`` on the CPU: the one-device halo
plan at S = 8, pipelined and serial, through the row-shard schedule on a
ring of one shard (``_halo_shard_steps``, its exchange the self-wrap)
equals bit for bit the run ``pallas_step`` builds, at grains 1 and 16, at
W = 12 (the gate keeps S = 8 serial and the depth passes the block) and W
= 64; the script's smoke writes one record per case."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks.torch_pipeline_trace import ring_records

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("width", [12, 64])
def test_the_one_shard_ring_equals_the_built_run(width):
    recs = list(ring_records(torch.device("cpu"), width, steps=17, grains=(1, 16),
                             rounds=1, reps=1))
    assert [(r["pipeline"], r["pipelined"], r["grain"]) for r in recs] == [
        (True, width > 16, 1), (True, width > 16, 16), (False, False, 1), (False, False, 16)]
    for r in recs:
        assert r["equal"], r
        assert r["launches"]["built"] == r["launches"]["ring"], r


def test_the_smoke_writes_its_records(tmp_path):
    out = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    subprocess.run([sys.executable, "-m", "benchmarks.torch_pipeline_trace", "--smoke",
                    "--device", "cpu", "--out", str(out)], cwd=ROOT, env=env, check=True,
                   capture_output=True, timeout=300)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["ring"] * 4
    assert all(r["equal"] and r["card"] == "cpu" for r in recs)
