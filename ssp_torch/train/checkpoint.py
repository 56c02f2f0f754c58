"""Checkpoints of the port's training (port of ``ssp/train/checkpoint.py``).

``save_checkpoint`` writes two files per iteration under the experiment's
``checkpoints/``:

* ``superPointNet_<it>.pth.tar``: ``torch.save`` of the module's state dict
  (``model_state_dict``, reference names), the ηs, the optimizer's and the
  schedule's state dicts, the step count and ``n_iter``: everything a full
  resume needs (the JAX package keeps the same in an orbax directory);
* ``superPointNet_<it>.npz``: ``params`` + ``batch_stats`` in the flax
  layout of ``ssp.train.checkpoint.save_weights_npz`` (fp16 leaves), which
  the JAX package's ``load_weights_npz``, the port's ``load_weights`` and
  the checkpoint sweep read.

``load_checkpoint`` restores either file: ``mode="full"`` the ηs, the
optimizer, the schedule and the step count too (a ``.pth.tar`` of this
trainer), ``"weights"`` the module's state only (an npz is always that).
An orbax directory raises, as ``load_weights`` does: reading one needs the
JAX package.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

import torch

from ssp_torch.models.weights import (_not_orbax, _read_flax, flax_to_state_dict,
                                      load_reference_state_dict, save_weights_npz)
from ssp_torch.train.state import TrainState

_NAME = re.compile(r"superPointNet_(\d+)\.pth\.tar$")


def save_checkpoint(ckpt_dir: Path, state: TrainState, it: int) -> Path:
    """Write both files of iteration ``it`` (an existing pair is replaced: a
    resumed run passes its own save points again); returns the ``.pth.tar``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"superPointNet_{it}.pth.tar"
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    torch.save({
        "model_state_dict": sd,
        "etas": state.etas.detach().cpu(),
        "optimizer_state_dict": state.optimizer.state_dict(),
        "scheduler_state_dict": state.scheduler.state_dict(),
        "step": int(state.step),
        "n_iter": int(it),
    }, path)
    save_weights_npz(ckpt_dir / f"superPointNet_{it}.npz", sd)
    return path


def latest_checkpoint(ckpt_dir: Path) -> Optional[Path]:
    """The ``superPointNet_<it>.pth.tar`` of the largest ``it``, or None."""
    found = [(int(m.group(1)), p) for p in Path(ckpt_dir).glob("superPointNet_*.pth.tar")
             if (m := _NAME.match(p.name))]
    return max(found)[1] if found else None


def load_checkpoint(path: Path, state: TrainState, *, mode: str = "full",
                    reset_iter: bool = False) -> TrainState:
    """Restore ``path`` into ``state`` (in place; returned).  ``mode="weights"``
    restores the module's parameters and BatchNorm statistics only, the
    reference's pretrained load; ``"full"`` also the ηs, Adam's moments, the
    schedule and the step count.  A ``.npz`` is weights only.  ``reset_iter``
    sets the step count to 0."""
    path = Path(path)
    _not_orbax(path)
    model = state.model
    if path.suffix == ".npz":
        name = "SuperPointNet_gauss2_ssmall" if getattr(model, "semantic", False) \
            else "SuperPointNet_gauss2"
        load_reference_state_dict(model, flax_to_state_dict(_read_flax(path, name)))
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        sd = payload.get("model_state_dict", payload)
        model.load_state_dict(sd, strict=True)
        if mode == "full" and "optimizer_state_dict" in payload:
            with torch.no_grad():
                state.etas.copy_(payload["etas"])
            state.optimizer.load_state_dict(payload["optimizer_state_dict"])
            state.scheduler.load_state_dict(payload["scheduler_state_dict"])
            state.step = int(payload["step"])
    if reset_iter:
        state.step = 0
    return state
