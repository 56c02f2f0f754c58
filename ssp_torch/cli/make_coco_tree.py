"""Materialize the synthetic corpus as a COCO-style JPEG tree (port of
``scripts/make_coco_tree.py``).

Usage::

  python -m ssp_torch.cli.make_coco_tree [--root datasets/COCO240] [--suffix jointd240]
      [--size 240 320]

Writes ``<root>/{train2017,val2017}/<12-digit>.jpg`` from the
deterministic 240x320 synthetic-shapes corpus
(:class:`ssp_torch.data.synthetic_dataset.SyntheticShapesDataset`, cached
under ``$SSP_DATA_PATH/synthetic_shapes_<suffix>``), each image the file
``cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 96])`` writes
(:func:`ssp_torch.data.imageio.write_jpeg`).  At the default split sizes,
1500 and 40 per primitive, the truncation leaves 10,350 train and 276 val
images.  Missing cache shards are generated in worker processes, one shard
each (the same files as one process makes; a few thousand samples or fewer
in this process), so call :func:`make_coco_tree` from a script's guarded
``__main__``; the JPEGs are encoded on threads (the encoder releases the
GIL).
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ssp_torch.data.imageio import write_jpeg
from ssp_torch.data.synthetic_dataset import SyntheticShapesDataset

# the scripts' split sizes per primitive and truncation of three primitives
SPLIT_SIZES = {"training": 1500, "validation": 40, "test": 40}
TRUNCATE = {"draw_ellipses": 0.3, "draw_stripes": 0.5, "gaussian_noise": 0.1}
SPLITS = (("train", "train2017"), ("val", "val2017"))
QUALITY = 96
# fewer samples to generate than this are made in this process: a worker
# process takes seconds to start (it imports torch), a sample ~25 ms
PARALLEL_MIN = 2000


def corpus_config(suffix: str = "jointd240", size: Sequence[int] = (240, 320),
                  split_sizes: Optional[Dict[str, int]] = None) -> dict:
    """The dataset configuration of ``make_coco_tree`` and ``make_gt_labels``."""
    return dict(primitives="all", truncate=dict(TRUNCATE), suffix=suffix,
                generation={"split_sizes": dict(split_sizes or SPLIT_SIZES)},
                preprocessing={"blur_size": 21, "resize": [int(v) for v in size]})


def _shard(task: str, prim: str, cfg: dict) -> None:
    SyntheticShapesDataset(task=task, **{**cfg, "primitives": [prim]})


def warm_cache(cfg: dict) -> None:
    """Generate the missing train and val shards of ``cfg``: in worker
    processes, one shard each and one per core at a time, when they hold
    PARALLEL_MIN samples or more; else in this process."""
    missing = {task: SyntheticShapesDataset.missing_shards(task, **cfg) for task, _ in SPLITS}
    todo = [(task, prim) for task, shards in missing.items() for prim in shards]
    samples = sum(n for shards in missing.values() for n in shards.values())
    workers = min(os.cpu_count() or 1, len(todo))
    if samples < PARALLEL_MIN or workers <= 1:
        for task, prim in todo:
            _shard(task, prim, cfg)
        return
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for f in [pool.submit(_shard, task, prim, cfg) for task, prim in todo]:
            f.result()


def to_u8(image: np.ndarray) -> np.ndarray:
    """The script's conversion of a [0, 1] float image to uint8."""
    return np.clip(image * 255.0, 0, 255).astype(np.uint8)


def make_coco_tree(root="datasets/COCO240", suffix: str = "jointd240",
                   size: Sequence[int] = (240, 320),
                   split_sizes: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Write the tree under ``root``; returns the images written per split
    (``split_sizes`` per primitive, the scripts' by default)."""
    cfg = corpus_config(suffix, size, split_sizes)
    warm_cache(cfg)
    counts = {}
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for split, out_dir in SPLITS:
            ds = SyntheticShapesDataset(task=split, **cfg)
            out = Path(root) / out_dir
            out.mkdir(parents=True, exist_ok=True)
            list(pool.map(lambda i: write_jpeg(out / f"{i:012d}.jpg", to_u8(ds[i]["image"]),
                                               QUALITY), range(len(ds))))
            counts[split] = len(ds)
            print(split, len(ds), "->", out, flush=True)
    return counts


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="datasets/COCO240")
    ap.add_argument("--suffix", default="jointd240")
    ap.add_argument("--size", nargs=2, type=int, default=[240, 320])
    args = ap.parse_args(argv)
    return make_coco_tree(args.root, args.suffix, args.size)


if __name__ == "__main__":
    main()
