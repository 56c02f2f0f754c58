"""Train state: the module (parameters and BatchNorm statistics), the Kendall
ηs, one Adam over both, the LR schedule and the step count (port of
``ssp/train/state.py``).

``optax.adam(schedule)`` is ``torch.optim.Adam`` with β 0.9/0.999 and eps
1e-8 (the bias-corrected update m̂/(√v̂ + eps) either way), its lr set by
:class:`~ssp_torch.train.lr.PolynomialDecayLR` after each update.  The ηs
are one fp32 ``nn.Parameter [3]`` in the same optimizer, as the reference's
single optimizer over ``net.parameters() ∪ multi_task_loss.parameters()``.

A state that a CUDA graph of a whole step replays (the trainer's device
corpus loop, ``ssp_torch.train.trainer``) is made capturable with
:meth:`TrainState.set_capturable`: its step counts on the card, and its lr
is one 0-d device tensor that the schedule writes with ``fill_`` between
steps, so each replay takes the lr of the step it stands for.  Every other
state, and any state on the CPU, has PyTorch's default Adam with a float
lr, as ``optax`` and the CPU tests have it; a checkpoint of either kind
loads into either (:meth:`TrainState.restore`).
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
    capturable: bool = False

    @classmethod
    def create(cls, model: nn.Module, *, learning_rate: float = 0.001,
               max_steps: int = 200_000) -> "TrainState":
        device = next(model.parameters()).device
        etas = nn.Parameter(init_etas(device))
        opt = torch.optim.Adam(list(model.parameters()) + [etas], lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        return cls(model, etas, opt, PolynomialDecayLR(opt, max_steps))

    def finish_update(self) -> None:
        """After an optimizer step: the schedule and the count advance.
        Inside a CUDA graph's capture nothing happens here: the loop that
        replays the graph calls this after each replay."""
        if self.etas.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        self.scheduler.step()
        self.step += 1

    def restore(self, optimizer_state: dict, scheduler_state: dict, step: int) -> None:
        """Load the optimizer's and the schedule's state dicts and the count
        (a full resume), keeping this state's optimizer set-up, whichever
        set-up the saved one had."""
        self.optimizer.load_state_dict(optimizer_state)
        self.scheduler.load_state_dict(scheduler_state)
        self.step = int(step)
        self._bind_lr()

    def set_capturable(self, on: bool) -> None:
        """Make the optimizer capturable (``on``, a state on a card only) or
        PyTorch's default (module docstring)."""
        if on and self.etas.device.type != "cuda":
            raise ValueError(f"a capturable optimizer needs a CUDA device, not {self.etas.device}")
        if on != self.capturable:
            self.capturable = on
            self._bind_lr()

    def _bind_lr(self) -> None:
        """Every group's ``capturable`` flag, lr and step counts as this
        state has them: capturable, a 0-d device tensor holding the
        schedule's current value and counts on the card; else not
        capturable, a float and counts on the host (a state dict keeps the
        groups' keys as they were saved)."""
        lr = self.scheduler.lr_at(self.scheduler.last_epoch)[0]
        device = self.etas.device if self.capturable else torch.device("cpu")
        if self.capturable:
            lr = torch.full((), lr, device=device)
        for group in self.optimizer.param_groups:
            group["lr"], group["capturable"] = lr, self.capturable
        for st in self.optimizer.state.values():
            if "step" in st:
                st["step"] = st["step"].to(device=device, dtype=torch.float32)
