"""Descriptor evaluation: homography estimation correctness (port of
``ssp/evaluations/descriptor.py``).

Protocol from the reference (``evaluations/descriptor_evaluation.py:
65-158``): brute-force cross-checked L2 matching of descriptors, a RANSAC
homography, correctness = mean reprojection distance of the four image
corners under (estimated vs true) H, thresholded at ε.  OpenCV's matcher
and RANSAC are the port's own here (:mod:`ssp_torch.evaluations.matching`,
:mod:`ssp_torch.evaluations.homography_fit`); the fit is called through its
module, so a test can put OpenCV's in its place.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ssp_torch.evaluations import homography_fit
from ssp_torch.evaluations.detector import warp_keypoints_np
from ssp_torch.evaluations.matching import bf_match_cross_check


def compute_homography(
    pts1: np.ndarray,
    desc1: np.ndarray,
    pts2: np.ndarray,
    desc2: np.ndarray,
    H_true: np.ndarray,
    shape_hw,
    correctness_thresh: Sequence[float] = (1, 3, 5, 10, 20, 50),
) -> Dict[str, object]:
    """pts*: [N, ≥2] (x, y, ...); desc*: [N, D]; H_true: image1→image2.

    Returns dict(correctness[list], inliers, matches, homography,
    mean_dist)."""
    Hh, Wh = int(shape_hw[0]), int(shape_hw[1])
    out: Dict[str, object] = {
        "correctness": [0.0] * len(correctness_thresh),
        "inliers": np.zeros((0,)),
        "matches": np.zeros((0, 4)),
        "homography": None,
        "mean_dist": np.inf,
    }
    if len(pts1) < 4 or len(pts2) < 4:
        return out

    query, train = bf_match_cross_check(desc1, desc2)
    if len(query) < 4:
        return out
    m_pts1 = np.asarray(pts1)[query, :2].astype(np.float32)
    m_pts2 = np.asarray(pts2)[train, :2].astype(np.float32)
    H_est, inliers = homography_fit.find_homography(m_pts1, m_pts2)
    if H_est is None:
        return out
    inliers = np.asarray(inliers).ravel().astype(bool)

    corners = np.array(
        [[0, 0], [Wh - 1, 0], [0, Hh - 1], [Wh - 1, Hh - 1]], np.float64
    )

    dist = np.linalg.norm(
        warp_keypoints_np(corners, H_est) - warp_keypoints_np(corners, H_true),
        axis=1,
    )
    mean_dist = float(dist.mean())
    out.update(
        {
            "correctness": [float(mean_dist <= e) for e in correctness_thresh],
            "inliers": inliers,
            "matches": np.concatenate([m_pts1, m_pts2], axis=1),
            "homography": H_est,
            "mean_dist": mean_dist,
        }
    )
    return out


def matching_score(
    matches_inliers: np.ndarray, n1: int, n2: int
) -> float:
    """2·#inliers / (N1 + N2) (reference ``evaluation.py:194-219``)."""
    denom = n1 + n2
    return float(2.0 * matches_inliers.sum() / denom) if denom else 0.0
