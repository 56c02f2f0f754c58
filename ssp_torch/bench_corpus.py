"""The corpus tools at their full defaults, then the host loader over the
tree they wrote.

    python -m ssp_torch.bench_corpus [--root datasets] [--batches 50]

1. ``python -m ssp_torch.cli.make_coco_tree`` at its defaults (1500 + 40
   per primitive: 10,350 + 276 JPEGs at 240×320), a process of its own with
   ``SSP_DATA_PATH`` at ``--root``, whose synthetic shards must not exist
   yet (the generation is part of the time); then ``make_gt_labels`` and
   ``make_coco_sem_labels`` over that tree, each a process.  Each tool's
   seconds by the host clock and its files per second.
2. The host loader of the flagship configuration
   (``configs/pipeline240_wsem_200k.yaml``: ``Coco_sem`` at 240×320, batch 16)
   over that tree with the oracle labels and the semantic PNGs:
   ``ImageDataset.batches(16, workers=W)`` for W = 4 (the trainer's
   ``workers_train``), 1 and 8, each timed by the host clock over
   ``--batches`` batches after 5 unrecorded ones, in ms per batch.

The tools and the loader run on the host alone; the card is only named, from
``nvidia-smi``, whose absence fails the run.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import yaml

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "configs" / "pipeline240_wsem_200k.yaml"
WORKERS = (4, 1, 8)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_tool(module: str, *args: str, env: dict) -> float:
    """Seconds of ``python -m ssp_torch.cli.<module> args`` by the host clock."""
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", f"ssp_torch.cli.{module}", *args], cwd=ROOT, env=env,
                   check=True, stdout=sys.stderr)
    return time.perf_counter() - t0


def loader_ms(dataset, batch: int, workers: int, n: int, warmup: int = 5) -> float:
    """ms per batch of ``dataset.batches(batch, workers=workers)``."""
    it = dataset.batches(batch, shuffle=True, seed=0, workers=workers)
    for _ in range(warmup):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    ms = (time.perf_counter() - t0) * 1e3 / n
    it.close()
    return ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="datasets", help="where the trees and the cache go")
    ap.add_argument("--batches", type=int, default=50)
    args = ap.parse_args(argv)
    smi = card()
    root = Path(args.root).resolve()
    coco, gt = root / "COCO240", root / "gt_labels"
    if (root / "synthetic_shapes_jointd240").exists():
        raise SystemExit(f"{root / 'synthetic_shapes_jointd240'} exists: the generation would "
                         "not be timed")
    env = {**os.environ, "SSP_DATA_PATH": str(root)}
    tools = {}
    tools["make_coco_tree"] = run_tool("make_coco_tree", "--root", str(coco), env=env)
    n_jpeg = {s: len(list((coco / s).glob("*.jpg"))) for s in ("train2017", "val2017")}
    tools["make_gt_labels"] = run_tool("make_gt_labels", "--out", str(gt), env=env)
    tools["make_coco_sem_labels"] = run_tool("make_coco_sem_labels", "--root", str(coco), env=env)
    n = sum(n_jpeg.values())

    from ssp_torch.cli.train import make_dataset

    config = yaml.safe_load(FLAGSHIP.read_text())
    config["data"].update(root=str(coco), labels=str(gt), sem_labels=str(coco / "annotations"))
    train_set = make_dataset(config, "train")
    batch = int(config["model"]["batch_size"])
    loader = {f"workers_{w}": loader_ms(train_set, batch, w, args.batches) for w in WORKERS}
    out = {"card": smi, "cpus": os.cpu_count(), "jpegs": n_jpeg,
           "seconds": tools, "images_per_s": {k: n / v for k, v in tools.items()},
           "loader": {"config": FLAGSHIP.name, "train_images": len(train_set), "batch": batch,
                      "batches": args.batches, "ms_per_batch": loader}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
