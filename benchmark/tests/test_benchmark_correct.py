"""``correct`` comes out false for the control (the reference at the
precision below the configuration's, in the program's place) and for each
fault the cell can have, planted under its program; true for the program.
At a size a test run holds, with the cell's own limits."""

from __future__ import annotations

import argparse
import json

import pytest
import torch

import run as bench_run
from conftest import tiny_tree

CELLS = ["detect-b16"]


def _run(tmp_path, mix_name, seed, swap=None):
    bench_dir, name = tiny_tree(tmp_path, mix_name)
    b = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
    _, cfg, mix, runner = bench_run.cell_files(b, name, bench_dir)
    cell = runner.Cell(cfg, mix, bench_dir, torch.device("cpu"))
    if swap is not None:
        cell.program = swap(cell)
    args = argparse.Namespace(workload=name, seed=seed, seconds=1.0, trace=0)
    result, _ = bench_run.run(args, torch.device("cpu"), bench_dir, cell_object=cell)
    return result


@pytest.mark.parametrize("mix_name", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_program_is_correct(tmp_path, mix_name, seed):
    result = _run(tmp_path, mix_name, seed)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("mix_name", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_control_is_not_correct(tmp_path, mix_name, seed):
    result = _run(tmp_path, mix_name, seed, swap=lambda cell: cell.control())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("mix_name,fault", [(m, f) for m in CELLS for f in ("half_batch",
                                                                          "altered_descriptor")])
def test_fault_is_not_correct(tmp_path, mix_name, fault):
    result = _run(tmp_path, mix_name, 4, swap=lambda cell: cell.faults()[fault])
    assert not result["correct"], result["checks"]
