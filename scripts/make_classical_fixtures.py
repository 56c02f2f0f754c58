"""Write the classical baselines' fixtures: OpenCV's SIFT and ORB on four
seeded 240×320 images, for the port's C++ SIFT and ORB
(``ssp_torch/export/features.py``) to be held against where OpenCV is not
installed.

Usage:
  python scripts/make_classical_fixtures.py [tests/data/torch_classical]

Per image ``<name>.npz``: ``image`` (uint8 [240, 320]) and, for each of
``sift_plain`` (``cv2.setUseOptimized(False)``: OpenCV's portable SSE3
path), ``sift_default`` (OpenCV's default path: dispatched AVX2/AVX-512
code and IPP, on the machine that wrote the file) and ``orb`` (the same on
every path), ``<run>_kp`` float32 [N, 5] (x, y, size, angle, response),
``<run>_octave`` int32 [N] and ``<run>_desc`` uint8 [N, D] (SIFT's float
descriptors are integers in [0, 255]).  ``nfeatures`` is the classical
config's ``top_k``, 1000.  OpenCV runs on one thread: with several, its
SIFT orientations move by a few ulps from run to run.  ``manifest.json``
records OpenCV's version and its CPU features line (the dispatched levels
the CPU had are starred).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import cv2
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

NFEATURES = 1000
HW = (240, 320)


def fixture_images() -> dict:
    """The four seeded images: two synthetic-shapes scenes, blurred noise
    (fine texture, every SIFT octave) and upsampled noise (coarse blobs)."""
    from ssp_torch.data.synthetic_shapes import generate_sample

    out = {}
    for name, prim, seed in (("checkerboard", "draw_checkerboard", 3), ("cube", "draw_cube", 4)):
        img, _ = generate_sample(prim, size=HW, seed=seed)
        out[name] = (img * 255).astype(np.uint8)
    rng = np.random.default_rng(7)
    out["noise"] = cv2.GaussianBlur((rng.random(HW) * 255).astype(np.uint8), (5, 5), 1.0)
    coarse = (rng.random((HW[0] // 8, HW[1] // 8)) * 255).astype(np.float32)
    out["blobs"] = np.clip(cv2.resize(coarse, HW[::-1], interpolation=cv2.INTER_CUBIC), 0,
                           255).astype(np.uint8)
    return out


def keypoint_arrays(kps, desc, dim: int) -> tuple:
    kp = np.array([[k.pt[0], k.pt[1], k.size, k.angle, k.response] for k in kps],
                  np.float32).reshape(-1, 5)
    octave = np.array([k.octave for k in kps], np.int32)
    d = np.zeros((0, dim), np.uint8) if desc is None else desc
    return kp, octave, d.astype(np.uint8)


def opencv_runs(img: np.ndarray) -> dict:
    """``{run: (kp, octave, desc)}`` of OpenCV on ``img``, on one thread;
    the global OpenCV state is restored after."""
    threads, optimized = cv2.getNumThreads(), cv2.useOptimized()
    cv2.setNumThreads(1)
    try:
        out = {}
        for run, opt in (("sift_plain", False), ("sift_default", True)):
            cv2.setUseOptimized(opt)
            kps, desc = cv2.SIFT_create(nfeatures=NFEATURES).detectAndCompute(img, None)
            out[run] = keypoint_arrays(kps, desc, 128)
        cv2.setUseOptimized(True)
        kps, desc = cv2.ORB_create(nfeatures=NFEATURES).detectAndCompute(img, None)
        out["orb"] = keypoint_arrays(kps, desc, 32)
        return out
    finally:
        cv2.setUseOptimized(optimized)
        cv2.setNumThreads(threads)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="tests/data/torch_classical")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    counts = {}
    for name, img in fixture_images().items():
        arrays = {"image": img}
        for run, (kp, octave, desc) in opencv_runs(img).items():
            arrays.update({f"{run}_kp": kp, f"{run}_octave": octave, f"{run}_desc": desc})
            counts.setdefault(name, {})[run] = len(kp)
        np.savez_compressed(out / f"{name}.npz", **arrays)
    manifest = {"opencv": cv2.__version__, "nfeatures": NFEATURES, "threads": 1,
                "cpu_features": cv2.getCPUFeaturesLine(), "keypoints": counts}
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    print(f"wrote {len(counts)} fixtures to {out}: {counts}")


if __name__ == "__main__":
    main()
