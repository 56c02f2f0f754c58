"""The harness finds every piece of a cell by name, keeps to the contract's
shape, and runs a cell added as new files and entries without an edit."""

from __future__ import annotations

import argparse
import json
import re

import pytest
import torch

import run as bench_run
from conftest import BENCH_DIR, ROOT, bench, tiny_tree

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_load_by_name(cell):
    b = bench()
    entry, cfg, mix, runner = bench_run.cell_files(b, cell)
    assert hasattr(runner, "Cell") and "limits" in mix and cfg["registry_name"]
    for trace in (False, True):
        for m in bench_run.cell_metrics(b, cell, trace):
            reader = bench_run.load_file(BENCH_DIR / "metrics" / f"{m['name']}.py", m["name"])
            assert callable(reader.read)


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    cells = {w["name"] for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    assert {w["config"] for w in b["workloads"]} == configs
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + sorted(cells | configs)
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        e2e = bench_run.cell_metrics(b, w["name"], False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        per_layer = bench_run.cell_metrics(b, w["name"], True)
        assert per_layer
        assert {m["moves"] for m in per_layer} <= {m["name"] for m in e2e}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_runs_from_new_files(tmp_path):
    # small frames: the window holds the 20 requests the 95th percentile needs
    bench_dir, cell = tiny_tree(tmp_path, "detect-b16", height=64, width=96, top_k=100)
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 11, seconds=2.0, trace=0)
    result, lines = bench_run.run(args, torch.device("cpu"), bench_dir)
    assert result["correct"], result["checks"]
    # a 95th percentile needs 20 requests; a loaded host may send fewer
    want = {"detect_images_per_s", "setup_s"}
    if result["attempted"] >= 20:
        want.add("detect_latency_ms_p95")
    assert result["attempted"] > 0 and set(result["metrics"]) == want
    assert list(result)[-1] == "checks" and len(lines) == len(result["checks"])
    json.dumps(result)


def test_a_mix_sets_the_hosts_threads(tmp_path):
    bench_dir, cell = tiny_tree(tmp_path, "detect-b16", height=64, width=96, top_k=100,
                                host_threads=1)
    assert torch.get_num_threads() == 2
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 13, seconds=0.5, trace=0)
    result, _ = bench_run.run(args, torch.device("cpu"), bench_dir)
    assert result["correct"] and torch.get_num_threads() == 1


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = bench()["workloads"][0]["name"]
    rc = bench_run.main(["--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_rate_and_percentile_arithmetic():
    from yardstick.records import Records, Request, latency_ms, rate

    rec = Records(window=(10.0, 12.0), items_done=64,
                  requests=[Request(i, i + 0.001, i + 0.001 * (i + 1)) for i in range(100)])
    assert rate(rec) == 32.0
    # submit-to-done ms are 1..100: the 95th percentile by statistics.quantiles
    assert latency_ms(rec, 95) == pytest.approx(95.95)
    assert latency_ms(Records(requests=rec.requests[:19]), 95) is None


def test_roofline_and_mfu_readers_count_from_the_cells_files():
    from yardstick import work
    from yardstick.records import Records
    from yardstick.trace import DeviceTrace

    b = bench()
    cell = next(w for w in b["workloads"] if w["traffic"] == "detect-b16")
    _, cfg, mix, _ = bench_run.cell_files(b, cell["name"])
    B, H, W = mix["batch"], mix["height"], mix["width"]
    # two requests traced: each one stem launch of 1 ms and two down1 launches of 0.5 ms
    ops = [("void (anonymous namespace)::stem_kernel<true>(float const*)", 0.0, 1e-3),
           ("void (anonymous namespace)::conv3x3_kernel<false>(bf16 const*)", 0.0, 5e-4),
           ("void (anonymous namespace)::conv3x3_kernel<true>(bf16 const*)", 0.0, 5e-4)] * 2
    rec = Records(cfg=cfg, mix=mix, trace=DeviceTrace(0.0, 0.01, ops), traced_items=2 * B)
    metrics = {m["name"]: m for m in b["per_layer"]}
    got = bench_run.read_metrics([metrics["stem_roofline.detect"],
                                  metrics["down1_roofline.detect"], metrics["mfu.detect"]], rec)
    stem = work.stem_least_s(B, H, W, cfg["widths"]["c1"])
    down1 = work.down1_least_s(B, H, W, cfg["widths"]["c1"])
    assert got["stem_roofline.detect"]["value"] == pytest.approx(100 * stem / 1e-3)
    assert got["down1_roofline.detect"]["value"] == pytest.approx(100 * down1 / 1e-3)
    assert got["mfu.detect"]["value"] == pytest.approx(
        100 * 2 * B * work.forward_flops(cfg["widths"], H, W) / 0.01 / work.PEAK_BF16)
    # no NMS launch in the trace: the reader returns nothing and the metric is left out
    assert bench_run.read_metrics([metrics["nms_roofline.detect"]], rec) == {}
