"""Deployment export (port of ``ssp/cli/convert2script.py``).

The reference exports ``SuperPointNet_gauss2_ssmall`` as TorchScript with
its semantic head removed, for its SLAM front end (``convert2script.py``,
``SuperPointNet_gauss2_ssmall.removeSem``); the JAX package writes serialized
StableHLO (``jax.export``).  The port writes a ``torch.export`` program
(``torch.export.save``, a ``.pt2`` archive with the weights inside), which
replaces TorchScript: ``torch.jit.trace`` is deprecated in current PyTorch.
Load it with ``torch.export.load(path).module()``.

The artifact is the JAX artifact's function in the port module's layout: a
fixed-shape forward of NHWC images ``[batch, H, W, 1]`` float32 to ``(semi
[batch, H/8, W/8, 65], desc [batch, H/8, W/8, 256])``, or ``(semi, desc, sem
[batch, H, W, n_classes])`` with ``--keep-sem``.  It is the module's
evaluation forward on cuDNN (``model.apply`` in the JAX package), not the
folded kernel path of ``ssp_torch.models.fast_infer``, at the config's
``model.params.dtype`` (default bfloat16, the flax module's), with the weights
of ``pretrained`` (or ``model.pretrained``).

Usage::

  python -m ssp_torch.cli.convert2script <config> <output.pt2> \\
      [--height 240 --width 320 --batch 1] [--keep-sem] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import load_reference_state_dict, read_state_dict
from ssp_torch.utils.config import load_config

log = logging.getLogger(__name__)


class DeployForward(nn.Module):
    """``model``'s evaluation forward as a tuple: ``(semi, desc)``, and
    ``sem`` with ``keep_sem``."""

    def __init__(self, model: nn.Module, keep_sem: bool):
        super().__init__()
        self.model = model
        self.keep_sem = keep_sem and getattr(model, "semantic", False)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = self.model(images)
        if self.keep_sem:
            return out["semi"], out["desc"], out["sem"]
        return out["semi"], out["desc"]


def export_model(config: Dict[str, Any], out_path: Path, batch: int, height: int, width: int,
                 keep_sem: bool = False, device="cuda") -> Path:
    """Write the deployment program of ``config``'s model for ``[batch,
    height, width, 1]`` float32 images on ``device``; returns ``out_path``."""
    m = config["model"]
    params = dict(m.get("params") or {})
    params.setdefault("dtype", "bfloat16")
    model = build_model(m["name"], device=device, generator=torch.Generator().manual_seed(0),
                        **params)
    pretrained = config.get("pretrained") or m.get("pretrained")
    if pretrained:
        load_reference_state_dict(model, read_state_dict(pretrained, m["name"]))
    else:
        log.warning("no pretrained weights configured: exporting a seeded initialisation")
    example = torch.zeros(batch, height, width, 1, device=next(model.parameters()).device)
    program = torch.export.export(DeployForward(model.eval(), keep_sem).eval(), (example,))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, out_path)
    log.info("wrote %d bytes of torch.export program to %s", out_path.stat().st_size, out_path)
    return out_path


def main(argv=None) -> Path:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="export the deployment forward")
    ap.add_argument("config")
    ap.add_argument("output")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--keep-sem", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return export_model(load_config(args.config), Path(args.output), args.batch, args.height,
                        args.width, args.keep_sem, device=args.device)


if __name__ == "__main__":
    main()
