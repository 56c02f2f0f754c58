"""Classical detector/descriptor baselines (SIFT / ORB), the port of
``ssp/export/classical.py``.

Detection and description run on the host, as OpenCV runs them in the JAX
package, through the port's own OpenCV 5.0 SIFT and ORB
(:mod:`ssp_torch.export.features`, C++); the cross-checked brute-force
match runs on the card (:mod:`ssp_torch.kernels.bfmatch`) unless the caller
asks for the CPU.  Outputs and dtypes are the JAX package's: ``pts`` [N, 3]
float64 (x, y, response) ordered by ``np.argsort(-response)`` (numpy's
unstable sort, on the same input order as OpenCV's keypoints), ``desc``
float32 [N, 128] for SIFT and uint8 [N, 32] for ORB.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ssp_torch._device import resolve_device
from ssp_torch.export import features
from ssp_torch.kernels.bfmatch import bfmatch

DESC_DIM = {"sift": 128, "orb": 32}


def classical_detect_describe(
    img: np.ndarray, method: str = "sift", top_k: int = 1000
) -> Tuple[np.ndarray, np.ndarray]:
    """img: [H, W] float in [0, 1] → (pts [N, 3] (x, y, response),
    desc [N, D])."""
    if method not in DESC_DIM:
        raise ValueError(f"unknown classical method {method!r}")
    img_u8 = (img * 255).astype(np.uint8)
    detect = features.sift if method == "sift" else features.orb
    kps, desc = detect(img_u8, top_k)
    if not len(desc):
        return np.zeros((0, 3)), np.zeros((0, DESC_DIM[method]))
    pts = np.concatenate([kps.pt, kps.response[:, None]], axis=1).astype(np.float64)
    order = np.argsort(-pts[:, 2])[:top_k]
    return pts[order], desc[order]


def match_classical(
    desc1: np.ndarray, desc2: np.ndarray, method: str = "sift", *,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Cross-checked brute-force match, Hamming for ORB, L2 for SIFT
    (``descriptor_evaluation.py:88-98``) → [M, 3] float64 (query row, train
    row, distance) in query order."""
    if method not in DESC_DIM:
        raise ValueError(f"unknown classical method {method!r}")
    dev = resolve_device(device)
    dtype = np.uint8 if method == "orb" else np.float32
    d1 = torch.from_numpy(np.ascontiguousarray(desc1, dtype)).to(dev)
    d2 = torch.from_numpy(np.ascontiguousarray(desc2, dtype)).to(dev)
    return bfmatch(d1, d2).cpu().numpy().reshape(-1, 3)
