"""Materialize a KITTI-raw-layout tree from synthetic shapes (port of
``scripts/make_kitti_tree.py``).

Usage::

  python -m ssp_torch.cli.make_kitti_tree [--root datasets/KITTI_synth] [--drives 2]
      [--frames 10] [--size 384 1248] [--seed 0] [--motion]

Corner-rich synthetic frames at the KITTI export shape (384×1248) in the
layout ``Kitti_inh`` reads: ``<root>/<drive>/image_02/data/<frame>.png``
and the ``train.txt`` / ``val.txt`` split lists; ``--drives`` train drives
of ``--frames`` frames, then one val drive of half as many.  By default each
frame is an independent scene (a tracker's negative control); ``--motion``
makes each drive one composite scene moved along a smooth chain of
homographies (``warpPerspective`` of the float scene,
:func:`ssp_torch.data.raster.warp_perspective`), with the relative
homographies in ``<drive>/rel_H.json``.  PNGs are written by
:func:`ssp_torch.data.imageio.write_png` (``cv2.imwrite``'s pixels).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ssp_torch.data.imageio import write_png
from ssp_torch.data.raster import warp_perspective
from ssp_torch.data.synthetic_shapes import generate_sample

PRIMS = ("draw_checkerboard", "draw_multiple_polygons", "draw_cube",
         "draw_lines", "draw_star", "draw_stripes")


def motion_drive(h: int, w: int, seed: int, d: int, n: int):
    """(frames [n] of uint8 [h, w], relative homographies): drive ``d``'s
    polygon fields tiled along W, moved by small rigid motions about the
    centre, chained."""
    n_tiles = max(1, w // 320)
    tiles = []
    for t in range(n_tiles):
        tile, _ = generate_sample("draw_multiple_polygons", size=(h, w // n_tiles),
                                  seed=seed * 1_000_000 + d * 1_000 + 31 * t)
        tiles.append(tile)
    base = np.concatenate(tiles, axis=1)
    if base.shape != (h, w):
        base = np.pad(base, ((0, 0), (0, w - base.shape[1])))
    rng = np.random.default_rng(seed * 7919 + d)
    T = np.array([[1, 0, -(w - 1) / 2], [0, 1, -(h - 1) / 2], [0, 0, 1.0]])
    H_abs = [np.eye(3)]
    for _ in range(n - 1):
        th = np.radians(rng.uniform(-2.0, 2.0))
        s = rng.uniform(0.98, 1.02)
        tx, ty = rng.uniform(-4, 4, 2)
        M = np.array([
            [s * np.cos(th), -s * np.sin(th), tx],
            [s * np.sin(th), s * np.cos(th), ty],
            [0, 0, 1.0],
        ])
        H_abs.append(np.linalg.inv(T) @ M @ T @ H_abs[-1])
    frames = [(warp_perspective(base, H.astype(np.float64), (w, h)) * 255).astype("uint8")
              for H in H_abs]
    rel = [(H_abs[t + 1] @ np.linalg.inv(H_abs[t])).tolist() for t in range(n - 1)]
    return frames, rel


def make_kitti_tree(root="datasets/KITTI_synth", drives: int = 2, frames: int = 10,
                    size=(384, 1248), seed: int = 0, motion: bool = False) -> dict:
    """Write the tree under ``root``; returns the frames written per drive."""
    root = Path(root)
    h, w = size
    train, val, written = [], [], {}
    for d in range(drives + 1):  # the last drive is the val split
        drive = f"2026_08_19_drive_{d:04d}_sync_02"
        (val if d == drives else train).append(drive)
        frame_dir = root / drive / "image_02" / "data"
        frame_dir.mkdir(parents=True, exist_ok=True)
        n = max(1, frames // 2) if d == drives else frames
        if motion:
            imgs, rel = motion_drive(h, w, seed, d, n)
            (root / drive / "rel_H.json").write_text(json.dumps(rel))
        else:
            imgs = [(generate_sample(PRIMS[(d * frames + f) % len(PRIMS)], size=(h, w),
                                     seed=seed * 1_000_000 + d * 1_000 + f)[0] * 255
                     ).astype("uint8") for f in range(n)]
        for f, img in enumerate(imgs):
            write_png(frame_dir / f"{f:010d}.png", img)
        written[drive] = n
    (root / "train.txt").write_text("\n".join(train) + "\n")
    (root / "val.txt").write_text("\n".join(val) + "\n")
    print(f"wrote {drives}+1 drives x {frames} frames ({h}x{w}) to {root}")
    return written


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="datasets/KITTI_synth")
    ap.add_argument("--drives", type=int, default=2)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--size", type=int, nargs=2, default=(384, 1248))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--motion", action="store_true",
        help="coherent drives: each drive is ONE composite scene warped by a smooth "
        "homography chain (camera-like motion), with the ground-truth relative homographies "
        "saved as rel_H.json per drive (the default static tree renders an independent scene "
        "per frame: a tracker NEGATIVE control)")
    args = ap.parse_args(argv)
    return make_kitti_tree(args.root, args.drives, args.frames, args.size, args.seed,
                           args.motion)


if __name__ == "__main__":
    main()
