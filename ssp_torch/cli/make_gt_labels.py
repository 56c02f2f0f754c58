"""Materialize oracle detector labels for the COCO240 stand-in tree (port of
``scripts/make_gt_labels.py``).

Usage::

  python -m ssp_torch.cli.make_gt_labels [--out logs/pipeline240_export_gt/predictions]
      [--suffix jointd240] [--size 240 320]

The tree of :mod:`ssp_torch.cli.make_coco_tree` is rendered from synthetic
shapes, whose corner points are known exactly, so the stage-2 pseudo-label
tree (``<out>/{train2017,val2017}/<12-digit>.npz``, key ``pts`` = (x, y,
conf) float32, conf 1) can be written from the generator itself: a label
set for stage 3 without the HA export, and an oracle to audit HA labels
against.  The same corpus configuration and cache as ``make_coco_tree``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ssp_torch.cli.make_coco_tree import SPLITS, corpus_config, warm_cache
from ssp_torch.data.synthetic_dataset import SyntheticShapesDataset


def make_gt_labels(out="logs/pipeline240_export_gt/predictions", suffix: str = "jointd240",
                   size: Sequence[int] = (240, 320),
                   split_sizes: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Write the labels under ``out``; returns the files written per split
    (``split_sizes`` per primitive, the scripts' by default)."""
    cfg = corpus_config(suffix, size, split_sizes)
    warm_cache(cfg)
    counts = {}
    for split, out_dir in SPLITS:
        ds = SyntheticShapesDataset(task=split, **cfg)
        folder = Path(out) / out_dir
        folder.mkdir(parents=True, exist_ok=True)
        for i in range(len(ds)):
            s = ds[i]
            pts = np.asarray(s["points"], np.float32)[np.asarray(s["points_valid"], bool)]
            pts3 = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
            np.savez_compressed(folder / f"{i:012d}.npz", pts=pts3)
        counts[split] = len(ds)
        print(split, len(ds), "->", folder, flush=True)
    return counts


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="logs/pipeline240_export_gt/predictions")
    ap.add_argument("--suffix", default="jointd240")
    ap.add_argument("--size", nargs=2, type=int, default=[240, 320])
    args = ap.parse_args(argv)
    return make_gt_labels(args.out, args.suffix, args.size)


if __name__ == "__main__":
    main()
