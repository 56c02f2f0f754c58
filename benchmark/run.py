"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json``, its configuration ``benchmark/configs/<config>.json``,
its traffic mix ``benchmark/traffic/<traffic>.json`` (whose ``runner`` names
the general runner ``benchmark/runners/<runner>.py`` that reads it), and each
metric's reader ``benchmark/metrics/<metric>.py``.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced
part of the window.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, in a traced
run ``breakdown``, and last ``checks``: each number compared with its limit,
also the last lines of standard error).

The run needs as many CUDA cards as the cell asks for and exits with code 3
and no result without them; it exits with code 4 and no result when the JAX
package or JAX itself is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BANNED = frozenset({"jax", "jaxlib", "flax", "ssp"})  # top-level module names, whole


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & BANNED)


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(bench: dict, workload: str, bench_dir: Path = BENCH_DIR):
    """(the cell's entry, its configuration, its mix, its runner module) by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = json.loads((bench_dir / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    runner = load_file(bench_dir / "runners" / f"{mix['runner']}.py",
                       f"benchmark_runner_{mix['runner']}")
    return cell, cfg, mix, runner


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports in a run of this kind."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metrics(metrics: list, rec, bench_dir: Path = BENCH_DIR) -> dict:
    out = {}
    for m in metrics:
        reader = load_file(bench_dir / "metrics" / f"{m['name']}.py",
                           "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(args, device, bench_dir: Path = BENCH_DIR, cell_object=None) -> tuple:
    """One run: (result dict, stderr lines of the checks) — or the exit code
    of a refused run as an int.  ``cell_object`` replaces what the cell's
    runner builds (tests break the program underneath with it)."""
    import torch

    from yardstick import compare
    from yardstick.records import Records

    bench = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
    entry, cfg, mix, runner = cell_files(bench, args.workload, bench_dir)
    if "host_threads" in mix:  # the host's intra-op threads as the mix's users run them
        torch.set_num_threads(mix["host_threads"])
    rec = Records(cfg=cfg, mix=mix)
    cell = cell_object or runner.Cell(cfg, mix, bench_dir, device)
    cell.setup(args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    rec.setup_s = time.perf_counter() - T_START
    failed = 0
    try:
        cell.window(args.seconds, rec, bool(args.trace))
    except RuntimeError as err:  # the program failed inside the window
        print(f"the window failed: {err!r}", file=sys.stderr)
        failed = 1
    found = banned_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return 4
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = read_metrics(cell_metrics(bench, args.workload, bool(args.trace)), rec, bench_dir)
    cell.release()
    ok, table = compare.verdict(cell.numbers() if not failed else {}, mix["limits"])
    result = {
        "correct": bool(ok and not failed),
        "attempted": rec.attempted + failed,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": entry["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if args.trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s()
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.top_device_ops(),
                               "idle_gaps": (rec.host_trace or rec.trace).idle_gaps()}
    result["checks"] = table
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in table.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = run(args, torch.device("cuda"))
    if isinstance(out, int):
        return out
    result, lines = out
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
