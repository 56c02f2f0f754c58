"""Detector loss: masked BCE over the 65-way softmax (port of
``ssp/losses/detector.py``; reference ``Train_model_heatmap_all.detector_loss``).

Elementwise binary cross-entropy between softmax(semi), clipped to
[1e-7, 1 − 1e-7], and the normalised 65-channel cell labels, summed over
channels, masked by the valid-cell mask and divided by the mask sum + 1e-5.
The upper bound lies two fp32 ulps below 1: where the network is sure of a
class, ``log(1 − p)`` takes one of a few values set by the last ulp of the
softmax, which the exponentials of two libraries round differently.
``l2`` is the plain MSE mean of the config's ``detector_loss.loss_type``.

``mask_total`` and ``batch_total`` are the global batch's Σ ``cell_mask`` and
batch size when the batch is split over ranks (``ssp_torch.train.step``):
each rank's loss is then its additive share of the global batch's.
"""

from __future__ import annotations

from typing import Optional

import torch


def detector_loss(semi: torch.Tensor, cell_labels: torch.Tensor, cell_mask: torch.Tensor,
                  loss_type: str = "softmax", *, mask_total: Optional[torch.Tensor] = None,
                  batch_total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """semi/cell_labels: [B, Hc, Wc, 65]; cell_mask: [B, Hc, Wc]; the
    normalisers ``mask_total`` (softmax) and ``batch_total`` (l2) default to
    this batch's."""
    if loss_type == "l2":
        if batch_total is None:
            return torch.mean((semi - cell_labels) ** 2)
        per_sample = semi.numel() // semi.shape[0]
        return ((semi - cell_labels) ** 2).sum() / (batch_total * per_sample)
    # ``jnp.clip``'s gradient: max then min, a tie at a bound passing half
    # (``torch.clamp`` would pass all of it); a softmax within an fp32 ulp or
    # two of 1 sits on the upper bound
    p = torch.softmax(semi, dim=-1)
    p = torch.minimum(torch.maximum(p, p.new_full((), 1e-7)), p.new_full((), 1.0 - 1e-7))
    bce = -(cell_labels * torch.log(p) + (1.0 - cell_labels) * torch.log(1.0 - p))
    per_cell = bce.sum(dim=-1) * cell_mask
    total = cell_mask.sum() if mask_total is None else mask_total
    return per_cell.sum() / (total + 1e-5)
