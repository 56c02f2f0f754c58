"""Detector evaluation: repeatability + localization error (port of
``ssp/evaluations/detector.py``; host numpy in float64, the same
arithmetic line for line, ``_top_k``'s unstable ``np.argsort`` included,
so ties fall as they do there).

Protocol from the reference (``evaluations/detector_evaluation.py:
153-282``): filter keypoints whose warped positions leave the other
image, keep the top-``keep_k_points`` by confidence in each image, then
count symmetric nearest-neighbour pairs within ``distance_thresh``
pixels over N1 + N2; localization error is the mean NN distance of the
counted pairs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def warp_keypoints_np(pts_xy: np.ndarray, H: np.ndarray) -> np.ndarray:
    hom = np.concatenate([pts_xy, np.ones((len(pts_xy), 1))], axis=1)
    w = hom @ H.T
    return w[:, :2] / w[:, 2:]


def _filter_inside(pts: np.ndarray, H: np.ndarray, shape_hw) -> np.ndarray:
    """Keep points whose warp by H lands inside shape (H, W)."""
    if len(pts) == 0:
        return pts
    warped = warp_keypoints_np(pts[:, :2], H)
    ok = (
        (warped[:, 0] >= 0) & (warped[:, 0] < shape_hw[1])
        & (warped[:, 1] >= 0) & (warped[:, 1] < shape_hw[0])
    )
    return pts[ok]


def _top_k(pts: np.ndarray, k: int) -> np.ndarray:
    if len(pts) <= k:
        return pts
    idx = np.argsort(-pts[:, 2])[:k]
    return pts[idx]


def compute_repeatability(
    pts1: np.ndarray,
    pts2: np.ndarray,
    H: np.ndarray,
    shape_hw: Tuple[int, int],
    keep_k_points: int = 300,
    distance_thresh: float = 3.0,
    shape2_hw: Tuple[int, int] | None = None,
) -> Dict[str, float]:
    """pts1/pts2: [N, 3] (x, y, score) in image-1/image-2 coords;
    H: image1 → image2 homography; shape_hw: image-1 size;
    shape2_hw: image-2 size (defaults to shape_hw — un-resized HPatches
    pairs can differ, and each filter must test against the bounds of
    the image the warp lands in).

    Returns dict(repeatability, localization_err, count1, count2).
    """
    if shape2_hw is None:
        shape2_hw = shape_hw
    # points of image1 whose forward warp stays inside image2, and
    # points of image2 whose backward warp stays inside image1
    pts1_f = _top_k(_filter_inside(pts1, H, shape2_hw), keep_k_points)
    pts2_f = _top_k(_filter_inside(pts2, np.linalg.inv(H), shape_hw), keep_k_points)

    n1, n2 = len(pts1_f), len(pts2_f)
    if n1 == 0 or n2 == 0:
        return {"repeatability": 0.0, "localization_err": 0.0, "count1": n1, "count2": n2}

    warped1 = warp_keypoints_np(pts1_f[:, :2], H)  # image1 pts → image2 frame
    d = np.linalg.norm(warped1[:, None, :] - pts2_f[None, :, :2], axis=2)

    min1 = d.min(axis=1)  # for each warped image1 point
    min2 = d.min(axis=0)  # for each image2 point
    count1 = int((min1 <= distance_thresh).sum())
    count2 = int((min2 <= distance_thresh).sum())
    repeat = (count1 + count2) / (n1 + n2)

    le1 = min1[min1 <= distance_thresh]
    le2 = min2[min2 <= distance_thresh]
    loc_err = float(np.concatenate([le1, le2]).mean()) if (len(le1) + len(le2)) else 0.0
    return {
        "repeatability": float(repeat),
        "localization_err": loc_err,
        "count1": n1,
        "count2": n2,
    }
