"""Dense descriptor hinge loss over all cell pairs (port of
``ssp/losses/descriptor_dense.py``; reference ``descriptor_loss``,
``utils/utils.py:779-893``).

Every cell centre of image 1 is warped into image 2; a pair (i, j) is a
correspondence when the warped centre i lies within ``descriptor_dist``
pixels of centre j.  The hinges act on all-pairs descriptor dot products:

  L = Σ valid · (λ_d · corr · max(0, 1 − d·d′) + (1−corr) · max(0, d·d′ − 0.2))
      / (B · (Σ valid + 1) · Hc · Wc)

with ``valid`` the warped image's cell validity (the j index).  The
arithmetic follows the JAX function step by step: centres divided by a
tensor of the image size (an IEEE division, as ``jnp`` divides; PyTorch
would multiply by the reciprocal of a Python number), the distance as the
square root of the summed squares, the threshold ``dist <= descriptor_dist``
in fp32 (in fp64 for fp64 descriptors, as JAX computes it with x64 on).
The all-pairs product is one ``torch.bmm``, as it is one einsum outside any
Pallas kernel in the JAX package.  ``valid_total`` and ``batch_total`` are
the global batch's Σ valid and B when the batch is split over ranks
(``ssp_torch.train.step``): each rank's loss is then its additive share.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ssp_torch._device import constant
from ssp_torch.core.homography import warp_points

CELL = 8


def descriptor_loss_dense(
    desc: torch.Tensor,
    desc_warped: torch.Tensor,
    H_pair: torch.Tensor,
    valid_mask: torch.Tensor,
    lambda_d: float = 250.0,
    descriptor_dist: float = 4.0,
    margin_pos: float = 1.0,
    margin_neg: float = 0.2,
    *,
    valid_total: Optional[torch.Tensor] = None,
    batch_total: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """desc/desc_warped [B, Hc, Wc, D]; H_pair [B, 3, 3] normalised
    ([-1, 1]²) homographies from image 1 to image 2; valid_mask [B, Hc, Wc]
    the warped image's cell validity.  Returns ``(loss, corr [B, N, N],
    pos_term, neg_term)``, the terms normalised as the loss is."""
    B, Hc, Wc, D = desc.shape
    dev, dt = desc.device, torch.promote_types(desc.dtype, torch.float32)
    size = constant(torch.tensor([Wc * CELL, Hc * CELL], dtype=dt), dev)
    with torch.no_grad():
        cy, cx = torch.meshgrid(torch.arange(Hc, device=dev), torch.arange(Wc, device=dev),
                                indexing="ij")
        centres = (torch.stack([cx, cy], dim=-1).reshape(-1, 2) * CELL + CELL // 2).to(dt)
        centres_n = centres / size * 2.0 - 1.0
        warped_pix = (warp_points(centres_n, H_pair.to(dt)) + 1.0) / 2.0 * size  # [B, N, 2]
        diff = warped_pix[:, :, None, :] - centres[None, None, :, :]
        dist = torch.sqrt((diff * diff).sum(dim=-1))
        corr = (dist <= descriptor_dist).to(dt)  # [B, N(i), N(j)]
        vm = valid_mask.reshape(B, 1, -1).to(dt)
        pos_weight = lambda_d * corr * vm  # λ_d or 0, exactly
        neg_weight = (1.0 - corr) * vm
    dot = torch.bmm(desc.reshape(B, -1, D).to(dt), desc_warped.reshape(B, -1, D).to(dt)
                    .transpose(1, 2))
    pos = torch.clamp(margin_pos - dot, min=0.0) * pos_weight
    neg = torch.clamp(dot - margin_neg, min=0.0) * neg_weight
    b = B if batch_total is None else batch_total
    v = valid_mask.sum() if valid_total is None else valid_total
    norm = b * (v + 1.0) * Hc * Wc
    loss = (pos + neg).sum() / norm
    return loss, corr, pos.sum() / norm, neg.sum() / norm
