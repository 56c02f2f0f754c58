"""Nothing a run imports has the top-level name of JAX or of the JAX package
(``ssp``, compared whole: the port's ``ssp_torch`` begins with it)."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT, tiny_tree

PROBE = """
import argparse, json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import torch
import run
out = run.run(argparse.Namespace(workload={cell!r}, seed=9, seconds=0.5, trace=0),
              torch.device("cpu"), __import__("pathlib").Path({bench!r}))
print(json.dumps({{"refused": isinstance(out, int), "banned": run.banned_modules(),
                  "ssp_torch": "ssp_torch" in sys.modules}}))
"""


def test_a_run_loads_no_jax_in_a_fresh_interpreter(tmp_path):
    bench_dir, cell = tiny_tree(tmp_path, "detect-b16")
    code = PROBE.format(bench=str(bench_dir), root=str(ROOT), cell=cell)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen == {"refused": False, "banned": [], "ssp_torch": True}


def test_banned_names_are_compared_whole(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "ssp_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "ssp.probe", object())
    assert run.banned_modules() == ["ssp"]


def test_reference_loads_nothing_of_the_program_in_a_fresh_interpreter():
    code = ("import sys; sys.path.insert(0, 'benchmark'); "
            "from reference import points, superpoint; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'ssp_torch', 'ssp', 'jax', 'jaxlib', 'flax'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"
