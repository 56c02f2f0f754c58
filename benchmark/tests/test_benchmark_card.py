"""Each cell on the card, run as the benchmark runs it: a short run of
``benchmark/run.py`` with and without the trace, ``correct`` true and the
cell's metrics in the result line.  Skips without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, bench

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_runs_on_the_card(card, cell, trace):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2 ** 31 + 77), "--seconds", "3", "--trace", str(trace)],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    group = bench()["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want
