"""Subpixel residual loss (port of ``ssp/losses/subpixel.py``; reference
``subpixel_loss``/``subpixel_loss_no_argmax``, ``utils/losses.py:145-217``).

The soft-argmax offsets that the heatmap predicts at integer label
positions (``ssp_torch.postprocess.points.soft_argmax_refine``), against the
true fractional residuals the label pipeline keeps.
"""

from __future__ import annotations

import torch

from ssp_torch.postprocess.points import soft_argmax_refine


def subpixel_residual_loss(heatmap: torch.Tensor, points: torch.Tensor, residuals: torch.Tensor,
                           valid: torch.Tensor, patch_size: int = 5) -> torch.Tensor:
    """heatmap [*L, H, W]; points [*L, K, 2] (x, y) integer label positions;
    residuals [*L, K, 2] the true fractional offsets; valid [*L, K].  Returns
    the mean squared offset error over the valid points, [*L] (a 0-d tensor
    for one heatmap, as the JAX function)."""
    pts3 = torch.cat([points, torch.zeros_like(points[..., :1])], dim=-1)
    pred = soft_argmax_refine(heatmap, pts3, patch_size)[..., :2] - points
    err = ((pred - residuals) ** 2).sum(dim=-1)
    w = valid.float()
    return (err * w).sum(dim=-1) / (w.sum(dim=-1) + 1e-6)
