"""Import a reference PyTorch checkpoint into the port's checkpoint format
(port of ``ssp/cli/import_torch.py``).

Usage::

  python -m ssp_torch.cli.import_torch <ckpt.pth[.tar]> <out_dir> \\
      [--model SuperPointNet_gauss2_ssmall] [--n-classes 133] \\
      [--height 240 --width 320]

Reads the reference's ``.pth.tar`` training checkpoints (``model_state_dict``
and ``n_iter``), the Sener split model's submodule state dicts and bare
MagicLeap ``.pth`` state dicts (``ssp_torch.models.weights.
load_torch_checkpoint``), checks every name and shape against the model
before anything is written, and writes the pair that the port's trainer
writes, ``superPointNet_<n_iter>.pth.tar`` and ``superPointNet_<n_iter>.npz``
(``ssp_torch.train.checkpoint.save_checkpoint``: the weights, fresh ηs and
Adam state, the step count ``n_iter``).  Either file loads through every
CLI's ``pretrained:`` and through ``load_checkpoint``.  The port's module
names are the reference's, so no tensor is renamed or transposed.
``--height``/``--width`` are kept for the JAX CLI's flags: the flax
initialisation needs a shape, the port's module does not.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Mapping, Tuple

import torch

from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import load_reference_state_dict, load_torch_checkpoint
from ssp_torch.train.checkpoint import save_checkpoint
from ssp_torch.train.state import TrainState

log = logging.getLogger(__name__)

# BatchNorm counters that state dicts written without them (the JAX
# package's export, old reference checkpoints) leave out; they load as 0
_OPTIONAL = "num_batches_tracked"


def check_state_dict(model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` naming every missing, extra and misshapen tensor
    of ``state_dict`` against ``model``'s."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    missing = sorted(k for k in want.keys() - got.keys() if not k.endswith(_OPTIONAL))
    extra = sorted(got.keys() - want.keys())
    shapes = sorted(f"{k}: {got[k]} for {want[k]}" for k in want.keys() & got.keys()
                    if got[k] != want[k])
    if missing or extra or shapes:
        raise ValueError(f"the checkpoint does not fit the model: missing={missing} "
                         f"extra={extra} shapes={shapes}")


def import_checkpoint(src: Path, out_dir: Path, model_name: str, n_classes: int,
                      hw: Tuple[int, int]) -> Path:
    """``src`` (a reference checkpoint file) → ``out_dir/superPointNet_<n_iter>
    .pth.tar`` and ``.npz``; returns the ``.pth.tar``."""
    sd, n_iter = load_torch_checkpoint(src)
    params = {"n_classes": n_classes} if "ssmall" in model_name else {}
    model = build_model(model_name, device="cpu", **params)
    check_state_dict(model, sd)
    load_reference_state_dict(model, sd)
    state = TrainState.create(model)
    state.step = n_iter
    path = save_checkpoint(Path(out_dir), state, n_iter)
    log.info("wrote %s (n_iter=%d)", path, n_iter)
    return path


def main(argv=None) -> Path:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="import a reference PyTorch checkpoint")
    ap.add_argument("src")
    ap.add_argument("out_dir")
    ap.add_argument("--model", default="SuperPointNet_gauss2_ssmall")
    ap.add_argument("--n-classes", type=int, default=133)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    args = ap.parse_args(argv)
    return import_checkpoint(Path(args.src), Path(args.out_dir), args.model, args.n_classes,
                             (args.height, args.width))


if __name__ == "__main__":
    main()
