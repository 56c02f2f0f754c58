"""The benchmark's CPU tests: the harness's own directory and the repository
root on the import path, as ``benchmark/run.py`` puts them, and a small
tiny-cell helper shared by the tests."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a size a test run holds; the mixes' own parameters otherwise
TINY = {
    "detect-b16": {"batch": 2, "height": 120, "width": 160, "pool": 4, "templates": 2,
                   "top_k": 200, "warmup": 1, "check_requests": 8},
}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_tree(tmp: Path, mix_name: str, **sizes) -> tuple:
    """A copy of the benchmark in ``tmp`` with one more cell, ``<config>.tiny``
    on the mix ``tiny`` (``mix_name`` at the size of :data:`TINY`, updated by
    ``sizes``): new files plus new entries only.  Returns (the copy's benchmark
    directory, the new cell's name)."""
    shutil.copytree(BENCH_DIR, tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cell = next(w for w in b["workloads"] if w["traffic"] == mix_name)
    mix = json.loads((BENCH_DIR / "traffic" / f"{mix_name}.json").read_text())
    mix.update(TINY[mix_name], **sizes)
    (tmp / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(mix))
    name = f"{cell['config']}.tiny"
    b["workloads"].append(dict(cell, name=name, traffic="tiny"))
    for m in b["end_to_end"] + b["per_layer"]:
        if cell["name"] in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp / "benchmark", name
