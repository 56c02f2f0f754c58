"""Grid non-maximum suppression: iterated local-max suppression.

Port of ``ssp/postprocess/nms.py``.  A point survives if it is the
maximum of its (2r+1)² window, or becomes one once the neighbours of
stronger survivors are zeroed (``iterations`` rounds).  Window maxes use
``max_pool2d``, whose implicit padding is −∞, as ``reduce_window``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _maxpool_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Window max over (2r+1)² with −∞ SAME padding; x is [..., H, W]."""
    H, W = x.shape[-2:]
    y = F.max_pool2d(x.reshape(-1, 1, H, W), 2 * radius + 1, stride=1, padding=radius)
    return y.reshape(x.shape)


def simple_nms(scores: torch.Tensor, radius: int, iterations: int = 3) -> torch.Tensor:
    """scores [..., H, W] non-negative heatmap → heatmap with non-maxima zeroed."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool_same(scores, radius)
    for _ in range(iterations - 1):
        supp_mask = _maxpool_same(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _maxpool_same(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def zero_border(scores: torch.Tensor, border: int) -> torch.Tensor:
    """Zero detections within ``border`` px of the [..., H, W] edges (the
    reference's ``border_remove``)."""
    H, W = scores.shape[-2:]
    ys = torch.arange(H, device=scores.device)
    xs = torch.arange(W, device=scores.device)
    ok = ((ys >= border) & (ys < H - border))[:, None] & ((xs >= border) & (xs < W - border))[None, :]
    return torch.where(ok, scores, torch.zeros_like(scores))


def batched_nms(scores: torch.Tensor, radius: int, iterations: int = 3,
                border: int = 0) -> torch.Tensor:
    """[B, H, W] NMS (+ border zeroing).  A CUDA tensor goes through the
    fused kernel (``ssp_torch.kernels.nms``) — never quietly through the
    plain chain — and a CPU tensor through :func:`simple_nms` /
    :func:`zero_border`."""
    from ssp_torch.kernels.nms import nms

    return nms(scores, radius, iterations, border)
