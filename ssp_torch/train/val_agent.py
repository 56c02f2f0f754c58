"""Inference agent, the reference's ``Val_model_heatmap`` (port of
``ssp/train/val_agent.py``).

The reference class wraps a loaded model for the export scripts: ``run``
(the heatmap), ``heatmap_to_pts`` (NMS keypoints) and ``desc_to_sparseDesc``
(descriptors at the keypoints).  Here one call does all three on the
device and the accessors return what it kept.  On the card the forward is
``best_apply_fn``'s folded bf16 forward (the stem and down1 kernels) unless
``model.fast_inference`` is false (the module itself, at the config's
``model.params.dtype``, fp32 by default), and the keypoints go through the
NMS kernel; then top-k, the optional soft-argmax refinement and the
descriptor sampling.  ``reference=True`` runs the kernels' plain versions
(the card-side check of the kernels).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ssp_torch._device import resolve_device
from ssp_torch.core.grid import flatten_detection
from ssp_torch.kernels.nms import nms_plain
from ssp_torch.models.fast_infer import best_apply_fn, make_fast_apply, supports_fast
from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import load_weights
from ssp_torch.postprocess.points import (BORDER_REMOVE, extract_keypoints, sample_descriptors,
                                          soft_argmax_refine)
from ssp_torch.registry import register


@register("agent", "Val_model_heatmap")
class ValAgent:
    def __init__(self, config: Dict[str, Any], input_hw=(240, 320), *, device="cuda",
                 reference: bool = False, **_unused):
        m = config["model"] if "model" in config else config
        self.conf_thresh = float(m.get("detection_threshold", 0.015))
        self.nms_dist = int(m.get("nms", 4))
        self.top_k = int(m.get("top_k", 1000))
        sub = m.get("subpixel", {}) or {}
        self.subpixel = bool(sub.get("enable", False))
        self.patch_size = int(sub.get("patch_size", 5))
        self.fast_inference = bool(m.get("fast_inference", True))
        self.name, self.params = m["name"], dict(m.get("params") or {})
        self.device = resolve_device(device)
        self.reference = reference
        self.model = build_model(self.name, device=self.device, **self.params)
        self.input_hw = tuple(input_hw)
        self._apply = None
        self._last: Dict[str, np.ndarray] = {}
        pretrained = config.get("pretrained") or m.get("pretrained")
        if pretrained:
            self.load_model(pretrained)

    def load_model(self, path) -> None:
        """The weights at ``path``: a flax npz or a checkpoint file (the
        port's ``superPointNet_<it>.pth.tar`` or a reference state dict)."""
        self.model = load_weights(path, self.name, self.params, device=self.device)
        if "dtype" in self.params:  # the config's compute type (a flax npz loads at fp32)
            dt = self.params["dtype"]
            self.model.dtype = getattr(torch, dt) if isinstance(dt, str) else dt
        self._apply = None

    loadModel = load_model  # reference-spelling alias

    def init_random(self) -> None:
        """Seeded random weights (a ``torch.Generator`` seeded 0; the numbers
        are not flax's)."""
        self.model = build_model(self.name, device=self.device,
                                 generator=torch.Generator().manual_seed(0), **self.params)
        self._apply = None

    def _forward(self):
        if self._apply is None:
            if self.reference and self.fast_inference and supports_fast(self.model):
                self._apply = make_fast_apply(self.model, device=self.device, reference=True)
            else:
                self._apply = best_apply_fn(self.model, input_hw=self.input_hw,
                                            enable=self.fast_inference, device=self.device)
        return self._apply

    # -- reference-shaped API -----------------------------------------
    @torch.inference_mode()
    def run(self, image: np.ndarray) -> np.ndarray:
        """image [H, W] → heatmap [H, W]; keeps the keypoints and
        descriptors for the accessors."""
        x = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        out = self._forward()(x[None, ..., None])
        heat = flatten_detection(out["semi"])[0, ..., 0].contiguous()
        if self.reference and self.nms_dist > 0:
            nmsed = nms_plain(heat[None], self.nms_dist, 3, border=BORDER_REMOVE)[0]
            pts, valid = extract_keypoints(nmsed, k=self.top_k, conf_thresh=self.conf_thresh,
                                           nms_radius=0, border=0)
        else:
            pts, valid = extract_keypoints(heat, k=self.top_k, conf_thresh=self.conf_thresh,
                                           nms_radius=self.nms_dist)
        if self.subpixel:
            pts = soft_argmax_refine(heat, pts, self.patch_size)
        desc = sample_descriptors(out["desc"][0].float(), pts)
        v = valid.cpu().numpy()
        self._last = {"heatmap": heat.cpu().numpy(), "pts": pts.cpu().numpy()[v],
                      "desc": desc.cpu().numpy()[v]}
        return self._last["heatmap"]

    def heatmap_to_pts(self) -> np.ndarray:
        return self._last["pts"]

    def desc_to_sparse_desc(self) -> np.ndarray:
        return self._last["desc"]

    desc_to_sparseDesc = desc_to_sparse_desc  # reference-spelling alias
