"""Materialize semantic PNGs for the COCO240 tree (port of
``scripts/make_coco_sem_labels.py``).

Usage::

  python -m ssp_torch.cli.make_coco_sem_labels [--root datasets/COCO240] [--sigma 4.0]
      [--coarse N] [--out-name annotations]

Real panoptic annotations are absent, so each pixel's class is a fixed
global function of its smoothed gray value, written as a raw panoptic
category id: the contract ``Coco_sem`` reads
(``<root>/<out-name>/semantic_<split>2017/<stem>.png``), whose built-in
133-class mapping remaps it.  Each image is read as ``cv2.imread(...,
IMREAD_GRAYSCALE)`` reads it (:func:`ssp_torch.data.imageio.decode_gray`),
smoothed as ``cv2.GaussianBlur(img, (0, 0), sigma)``
(:func:`ssp_torch.data.raster.gaussian_blur_sigma`), mapped through the
LUT and written as an 8-bit gray PNG (:func:`ssp_torch.data.imageio.
write_png`: ``cv2.imwrite``'s pixels, bytes of its own).

The default LUT splits the 256 gray values into 134 uniform bins: bin 0 is
raw id 0 (the ignore class 133) and bins 1..133 the 133 real ids in order.
``--coarse N``: N wide gray bands, the central 10/16 of each mapped onto a
real id spread over the table, the band edges to raw 0.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

import numpy as np

from ssp_torch.data.coco_labels import N_CLASSES, PANOPTIC_IDS
from ssp_torch.data.imageio import decode_gray, write_png
from ssp_torch.data.raster import gaussian_blur_sigma


def label_lut(coarse: int = 0) -> np.ndarray:
    """The gray value → raw panoptic id table (module docstring)."""
    ids = np.asarray(PANOPTIC_IDS, np.uint8)
    lut = np.zeros(256, np.uint8)
    if coarse:
        n = coarse
        band_w = 256 // n
        g = np.arange(256)
        band = np.minimum(g // band_w, n - 1)
        pos = g - band * band_w
        guard = max(band_w // 8, 1)
        central = (pos >= guard) & (pos < band_w - guard)
        spread = np.linspace(0, N_CLASSES - 1, n).astype(int)
        lut[central] = ids[spread[band[central]]]
    else:
        bin_of = (np.arange(256) * (N_CLASSES + 1)) // 256  # 0..133
        lut[bin_of > 0] = ids[bin_of[bin_of > 0] - 1]
    return lut


def make_coco_sem_labels(root="datasets/COCO240", sigma: float = 4.0, coarse: int = 0,
                         out_name: str = "annotations") -> Dict[str, int]:
    """Write the PNGs of every JPEG of ``root``'s two splits; returns the
    count per split."""
    lut = label_lut(coarse)
    root = Path(root)
    counts = {}
    for split in ("train2017", "val2017"):
        out_dir = root / out_name / f"semantic_{split}"
        out_dir.mkdir(parents=True, exist_ok=True)
        files = sorted((root / split).glob("*.jpg"))
        for f in files:
            write_png(out_dir / f"{f.stem}.png", lut[gaussian_blur_sigma(decode_gray(f), sigma)])
        counts[split] = len(files)
        print(split, len(files), "->", out_dir, flush=True)
    return counts


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="datasets/COCO240")
    ap.add_argument("--sigma", type=float, default=4.0, help="pre-LUT smoothing")
    ap.add_argument(
        "--coarse", type=int, default=0, metavar="N",
        help="coarse mode: N well-separated appearance classes mapped onto N real panoptic "
        "ids, quantization-boundary gray values -> ignore")
    ap.add_argument("--out-name", default="annotations",
                    help="annotations dir name under --root")
    args = ap.parse_args(argv)
    return make_coco_sem_labels(args.root, args.sigma, args.coarse, args.out_name)


if __name__ == "__main__":
    main()
