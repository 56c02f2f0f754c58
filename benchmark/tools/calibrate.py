"""Readings for a cell's limits, in one process: the program's numbers over
many seeds, then the control's (the reference at the precision below the
configuration's) and each planted fault's over a few, each after a short
window of the cell's own traffic at its own sizes.

    python3 benchmark/tools/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control-seeds ...] [--seconds 1.5] [--out readings.jsonl]

One JSON line per reading: ``variant`` (program, control or one of the
runner's ``faults()``), ``seed`` and the numbers of ``yardstick.compare``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import torch  # noqa: E402

import run as bench_run  # noqa: E402
from yardstick.records import Records  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    _, cfg, mix, runner = bench_run.cell_files(bench, args.workload)
    cell = runner.Cell(cfg, mix, BENCH_DIR, device)
    program = cell.program
    variants = [("program", program, args.seeds)]
    if args.control_seeds:
        variants.append(("control", cell.control(), args.control_seeds))
        variants += [(name, fn, args.control_seeds) for name, fn in cell.faults().items()]
    out = open(args.out, "a") if args.out else None
    try:
        for name, fn, seeds in variants:
            for seed in seeds:
                cell.program = fn
                cell.setup(seed)
                rec = Records()
                cell.window(args.seconds, rec, False)
                line = json.dumps({"workload": args.workload, "variant": name, "seed": seed,
                                   "requests": len(rec.requests), **cell.numbers()})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
