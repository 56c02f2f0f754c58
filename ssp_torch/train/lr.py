"""Polynomial LR decay (port of ``ssp/train/lr.py``: ``optax.polynomial_schedule``;
reference ``PolynomialLRDecay(max_decay_steps, end_learning_rate=0.001,
power=2.0)``):

  lr(t) = (lr₀ − lr_end) · (1 − min(t, T)/T)^p + lr_end

evaluated, as optax evaluates it, at the count of updates made before the
one it scales: the first update takes lr(0).
"""

from __future__ import annotations

from typing import Callable

from torch.optim.lr_scheduler import LRScheduler


def polynomial_decay(init_lr: float, max_steps: int, end_lr: float = 0.001,
                     power: float = 2.0) -> Callable[[int], float]:
    def lr(count: int) -> float:
        if max_steps <= 0:
            return init_lr
        frac = 1.0 - min(max(count, 0), max_steps) / max_steps
        return (init_lr - end_lr) * frac ** power + end_lr

    return lr


class PolynomialDecayLR(LRScheduler):
    """:func:`polynomial_decay` of each group's initial lr.  ``step()`` after
    each optimizer step moves to the next count; ``last_epoch`` is the count
    of updates made."""

    def __init__(self, optimizer, max_steps: int, end_lr: float = 0.001, power: float = 2.0,
                 last_epoch: int = -1):
        self.max_steps, self.end_lr, self.power = int(max_steps), float(end_lr), float(power)
        super().__init__(optimizer, last_epoch)

    def get_lr(self):
        return [polynomial_decay(base, self.max_steps, self.end_lr, self.power)(self.last_epoch)
                for base in self.base_lrs]
