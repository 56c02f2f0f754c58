"""Materialize an HPatches-layout evaluation corpus from synthetic shapes
(port of ``scripts/make_synth_hpatches.py``).

Usage::

  python -m ssp_torch.cli.make_synth_hpatches datasets/HPatches_synth \\
      [--n-seq 40] [--pairs 2] [--size 240 320] [--strong] [--seed 0]

Corner-rich synthetic scenes, each warped by known mild homographies
(HPatches-like viewpoint changes: ≤8° rotation, ≤10% scale, small
perspective; ``--strong``: ±30°, 25%), in the layout ``PatchesDataset``
reads: ``<seq>/1.ppm``, ``<seq>/<i>.ppm``, ``<seq>/H_1_<i>``.  Each view is
``cv2.warpPerspective(img_u8, H, (w, h), flags=cv2.INTER_LINEAR)``
(:func:`ssp_torch.data.raster.warp_perspective` on uint8) written as the
binary PPM ``cv2.imwrite`` writes for its gray-to-BGR image; each H as
``np.savetxt`` writes it.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ssp_torch.data.base import write_pnm
from ssp_torch.data.raster import warp_perspective
from ssp_torch.data.synthetic_shapes import generate_sample

# corner-rich primitives only: scenes with ~8 corners cannot support 1 px
# homography estimation
PRIMS = ("draw_checkerboard", "draw_multiple_polygons", "draw_cube", "draw_stripes")


def mild_homography(rng: np.random.Generator, strong: bool = False) -> np.ndarray:
    """Pixel-coordinate homography for HPatches-like viewpoint change."""
    max_rot, max_scale, max_t, persp = (
        (30.0, 0.25, 30.0, 1e-4) if strong else (8.0, 0.10, 15.0, 5e-5)
    )
    th = np.radians(rng.uniform(-max_rot, max_rot))
    s = rng.uniform(1.0 - max_scale, 1.0 + max_scale)
    tx, ty = rng.uniform(-max_t, max_t, 2)
    return np.array([
        [s * np.cos(th), -s * np.sin(th), tx],
        [s * np.sin(th), s * np.cos(th), ty],
        [rng.uniform(-persp, persp), rng.uniform(-persp, persp), 1.0],
    ])


def center_conjugate(H: np.ndarray, h: int, w: int) -> np.ndarray:
    """Apply the warp about the image centre (keeps content in frame)."""
    T = np.array([[1, 0, -(w - 1) / 2], [0, 1, -(h - 1) / 2], [0, 0, 1.0]])
    return np.linalg.inv(T) @ H @ T


def gray_ppm(path: Path, img: np.ndarray) -> None:
    """``cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))`` for a
    ``.ppm`` path: a binary P6 of three equal channels."""
    write_pnm(path, np.repeat(img[..., None], 3, axis=2))


def make_synth_hpatches(out, n_seq: int = 40, pairs: int = 2, size=(240, 320),
                        strong: bool = False, seed: int = 0) -> int:
    """Write ``n_seq`` sequences of 1 + ``pairs`` views under ``out``;
    returns the sequence count."""
    out = Path(out)
    h, w = size
    rng = np.random.default_rng(seed)
    for s in range(n_seq):
        prim = PRIMS[s % len(PRIMS)]
        img, _ = generate_sample(prim, size=(h, w), seed=seed * 100_000 + s)
        img_u8 = (img * 255).astype(np.uint8)
        seq = out / f"v_{prim.removeprefix('draw_')}_{s:03d}"
        seq.mkdir(parents=True, exist_ok=True)
        gray_ppm(seq / "1.ppm", img_u8)
        for i in range(2, 2 + pairs):
            H = center_conjugate(mild_homography(rng, strong), h, w)
            gray_ppm(seq / f"{i}.ppm", warp_perspective(img_u8, H, (w, h)))
            np.savetxt(seq / f"H_1_{i}", H)
    print(f"wrote {n_seq} sequences x {pairs} pairs to {out}")
    return n_seq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--n-seq", type=int, default=40)
    ap.add_argument("--pairs", type=int, default=2, help="warped views per sequence")
    ap.add_argument("--size", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--strong", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return make_synth_hpatches(args.out, args.n_seq, args.pairs, args.size, args.strong,
                               args.seed)


if __name__ == "__main__":
    main()
