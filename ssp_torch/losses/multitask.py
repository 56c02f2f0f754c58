"""Kendall multi-task uncertainty weighting (port of
``ssp/losses/multitask.py``; reference ``MultiTaskLoss``).

Learnable log-variances η = [η_det, η_desc, η_sem], initialised to
[1, 2, 1]:

  L = L_det·e^{-η₀} + η₀ + ½(L_pos + L_neg)·e^{-η₁} + ½η₁
      [+ L_sem·e^{-η₂} + η₂]

The ηs are trained by the same Adam as the network and are saved with every
checkpoint (``ssp_torch.train.checkpoint``).  With the batch split over W
ranks each rank's loss is its additive share of the global batch's: the
weighted terms are shares already, and ``eta_share`` = 1/W makes the ``+η``
terms count once over the ranks.
"""

from __future__ import annotations

from typing import Optional

import torch


def init_etas(device="cpu") -> torch.Tensor:
    return torch.tensor([1.0, 2.0, 1.0], dtype=torch.float32, device=device)


def multi_task_loss(etas: torch.Tensor, loss_det: torch.Tensor, loss_desc_pos: torch.Tensor,
                    loss_desc_neg: torch.Tensor, loss_sem: Optional[torch.Tensor] = None, *,
                    eta_share: Optional[float] = None) -> torch.Tensor:
    reg = etas if eta_share is None else etas * eta_share
    total = (loss_det * torch.exp(-etas[0]) + reg[0]
             + 0.5 * (loss_desc_pos + loss_desc_neg) * torch.exp(-etas[1]) + 0.5 * reg[1])
    if loss_sem is not None:
        total = total + loss_sem * torch.exp(-etas[2]) + reg[2]
    return total
