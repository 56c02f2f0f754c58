"""Subpixel-head training and inference agents (port of
``ssp/train/subpixel_agent.py``).

The reference ships ``Train_model_subpixel.py`` / ``Val_model_subpixel.py``
for its ``SubpixelNet`` as dead code; the JAX package's working equivalent
trains SubpixelNet's dense offset head against the fractional residual maps
of the label pipeline (``labels_res``) beside the detector BCE, and this is
its port.  The loss is the reference's ``subpixel_loss_no_argmax``
(``utils/losses.py:177-217``): the predicted offsets read at keypoint pixels
against the true residuals, a masked mean squared error.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from ssp_torch._device import resolve_device
from ssp_torch.core.grid import flatten_detection, labels_to_cells
from ssp_torch.losses import detector_loss
from ssp_torch.models.weights import load_reference_state_dict
from ssp_torch.parallel import mesh
from ssp_torch.registry import register
from ssp_torch.train.state import TrainState
from ssp_torch.train.step import cell_valid_mask, global_totals, reduce_step
from ssp_torch.train.trainer import TrainAgent


def subpixel_map_loss(pred: torch.Tensor, labels_res: torch.Tensor, labels_2d: torch.Tensor, *,
                      mask_total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked MSE of the dense offset map ``pred [B, H, W, 2]`` against the
    residual targets ``labels_res [B, H, W, 2]``; only keypoint pixels of
    ``labels_2d [B, H, W, 1]`` supervise (reference ``utils/losses.py:201-210``).
    ``mask_total`` is the global batch's keypoint count on several ranks."""
    mask = labels_2d[..., 0]
    err = ((pred.float() - labels_res) ** 2).sum(dim=-1) * mask
    total = mask.sum() if mask_total is None else mask_total
    return err.sum() / (total + 1e-6)


def subpixel_losses(model: nn.Module, batch: Dict[str, torch.Tensor], *,
                    det_loss_type: str = "softmax",
                    lambda_subpix: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) in the module's current mode: the detector BCE (65
    channels, the dustbin always on) + ``lambda_subpix`` × the offset MSE,
    normalised over the global batch on several ranks (as
    ``ssp_torch.train.step.compute_losses``)."""
    cmask = cell_valid_mask(batch["valid_mask"])
    tot = dict.fromkeys(("batch", "cells", "points"))
    if mesh.world() > 1:
        tot.update(global_totals(
            batch=torch.full((), cmask.shape[0], dtype=cmask.dtype, device=cmask.device),
            cells=cmask.sum(), points=batch["labels_2d"][..., 0].sum()))
    out = model(batch["image"])
    loss_det = detector_loss(out["semi"], labels_to_cells(batch["labels_2d"]), cmask,
                             det_loss_type, mask_total=tot["cells"], batch_total=tot["batch"])
    loss_sub = subpixel_map_loss(out["subpixel"], batch["labels_res"], batch["labels_2d"],
                                 mask_total=tot["points"])
    loss = loss_det + lambda_subpix * loss_sub
    return loss, {"loss": loss.detach(), "loss_det": loss_det.detach(),
                  "loss_desc": torch.zeros((), device=loss.device),
                  "loss_subpix": loss_sub.detach()}


def subpixel_train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                        **kwargs) -> Dict[str, torch.Tensor]:
    """One Adam update of the network on :func:`subpixel_losses`.  The ηs
    get no gradient, so Adam leaves them where they are (the JAX step passes
    zeros, which moves them by nothing either)."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = subpixel_losses(state.model, batch, **kwargs)
    loss.backward()
    metrics = reduce_step(state, metrics)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics


def subpixel_eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
                       **kwargs) -> Dict[str, torch.Tensor]:
    """:func:`subpixel_losses` in evaluation mode, no gradient; the module's
    mode is restored after."""
    was_training = state.model.training
    state.model.eval()
    try:
        with torch.no_grad():
            metrics = subpixel_losses(state.model, batch, **kwargs)[1]
    finally:
        state.model.train(was_training)
    return reduce_step(state, metrics, grads=False)


@register("agent", "Train_model_subpixel")
class SubpixelTrainAgent(TrainAgent):
    """:class:`TrainAgent` with the subpixel step in place of the joint one
    (``model.name: SubpixelNet``; ``model.lambda_subpix``, default 1)."""

    def _build(self) -> None:
        super()._build()
        m = self.config["model"]
        self.subpixel_kwargs = dict(
            det_loss_type=m.get("detector_loss", {}).get("loss_type", "softmax"),
            lambda_subpix=float(m.get("lambda_subpix", 1.0)))

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return subpixel_train_step(self.state, batch, **self.subpixel_kwargs)

    def eval_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return subpixel_eval_step(self.state, batch, **self.subpixel_kwargs)


@register("agent", "Val_model_subpixel")
class SubpixelValAgent:
    """Inference on a SubpixelNet: dense offsets and offset-refined keypoints
    (the JAX package's working equivalent of the reference's
    ``Val_model_subpixel``).  ``state_dict`` (reference names), when given,
    is loaded into ``model``; the module runs in evaluation mode on
    ``device``."""

    def __init__(self, model: nn.Module, state_dict: Optional[Mapping] = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        if state_dict is not None:
            load_reference_state_dict(model, state_dict)
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def _forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.model(torch.as_tensor(images, dtype=torch.float32).to(self.device))

    def run(self, images) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 1] → {semi, desc, subpixel, heatmap}."""
        out = dict(self._forward(images))
        out["heatmap"] = flatten_detection(out["semi"])
        return out

    def refine_points(self, images, pts: torch.Tensor) -> torch.Tensor:
        """Each keypoint plus the offset predicted at its rounded pixel
        (clipped into the image): pts [B, K, ≥2] (x, y[, score]) → the
        refined points, same shape, on the agent's device."""
        off = self._forward(images)["subpixel"].float()  # [B, H, W, 2]
        pts = torch.as_tensor(pts, dtype=torch.float32).to(self.device)
        ix = torch.round(pts[..., 0]).long().clamp(0, off.shape[2] - 1)
        iy = torch.round(pts[..., 1]).long().clamp(0, off.shape[1] - 1)
        b = torch.arange(pts.shape[0], device=self.device)[:, None]
        out = pts.clone()
        out[..., :2] += off[b, iy, ix]
        return out
