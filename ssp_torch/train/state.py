"""Train state: the module (parameters and BatchNorm statistics), the Kendall
ηs, one Adam over both, the LR schedule and the step count (port of
``ssp/train/state.py``).

``optax.adam(schedule)`` is ``torch.optim.Adam`` with β 0.9/0.999 and eps
1e-8 (the bias-corrected update m̂/(√v̂ + eps) either way), its lr set by
:class:`~ssp_torch.train.lr.PolynomialDecayLR` before each update.  The ηs
are one fp32 ``nn.Parameter [3]`` in the same optimizer, as the reference's
single optimizer over ``net.parameters() ∪ multi_task_loss.parameters()``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from ssp_torch.losses.multitask import init_etas
from ssp_torch.train.lr import PolynomialDecayLR


@dataclass
class TrainState:
    model: nn.Module
    etas: nn.Parameter
    optimizer: torch.optim.Optimizer
    scheduler: PolynomialDecayLR
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, *, learning_rate: float = 0.001,
               max_steps: int = 200_000) -> "TrainState":
        device = next(model.parameters()).device
        etas = nn.Parameter(init_etas(device))
        opt = torch.optim.Adam(list(model.parameters()) + [etas], lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        return cls(model, etas, opt, PolynomialDecayLR(opt, max_steps))
