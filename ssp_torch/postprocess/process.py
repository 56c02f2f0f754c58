"""Batched training-time post-processing (port of
``ssp/postprocess/process.py``; reference ``models/model_utils.py``).

``SuperPointNet_process`` in the reference provides tensor-batched NMS,
soft-argmax offsets and fixed-N feature extraction.  Here it is a thin
class over the port's batched primitives, with the reference's method
names.  The JAX package vmaps per-image functions; the port's primitives
take leading batch dimensions, so nothing is vmapped, and NMS runs the
kernel on a CUDA tensor (:func:`ssp_torch.postprocess.nms.batched_nms`).
"""

from __future__ import annotations

from typing import Dict

import torch

from ssp_torch.postprocess.nms import batched_nms
from ssp_torch.postprocess.points import (
    extract_keypoints,
    sample_descriptors,
    soft_argmax_refine,
)


class SuperPointProcess:
    """Reference-shaped API: ``heatmap_to_nms``, ``pred_soft_argmax``,
    ``batch_extract_features`` (``models/model_utils.py:24-207``)."""

    def __init__(self, out_num_points: int = 500, patch_size: int = 5, nms_dist: int = 4,
                 conf_thresh: float = 0.015):
        self.out_num_points = out_num_points
        self.patch_size = patch_size
        self.nms_dist = nms_dist
        self.conf_thresh = conf_thresh

    def heatmap_to_nms(self, heatmap: torch.Tensor) -> torch.Tensor:
        """[B, H, W] → NMS'd heatmap (batched)."""
        return batched_nms(heatmap.contiguous(), self.nms_dist)

    def _extract(self, heatmap_nms: torch.Tensor):
        return extract_keypoints(heatmap_nms, k=self.out_num_points,
                                 conf_thresh=self.conf_thresh, nms_radius=0, nms_iterations=1)

    def pred_soft_argmax(self, heatmap_nms: torch.Tensor,
                         heatmap: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Subpixel offsets at the NMS peaks: fixed-K refined points per
        batch element."""
        pts, valid = self._extract(heatmap_nms)
        refined = soft_argmax_refine(heatmap, pts, self.patch_size)
        return {"pts": pts, "pred": refined[..., :2] - pts[..., :2], "valid": valid}

    def batch_extract_features(self, desc: torch.Tensor, heatmap_nms: torch.Tensor,
                               residual: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Fixed-N points, offsets and descriptors per batch element (the
        reference pads or crops to ``out_num_points``,
        ``model_utils.py:173-207``; here K is fixed by construction).

        Descriptors are sampled at the refined positions ``pts + residual``
        (``model_utils.py:190-194``); ``residual`` rows align with the points
        because :meth:`pred_soft_argmax` extracts with the same parameters
        from the same NMS maps."""
        pts, valid = self._extract(heatmap_nms)
        refined = torch.cat([pts[..., :2] + residual, pts[..., 2:]], dim=-1)
        return {"pts_int": pts[..., :2], "pts_offset": residual,
                "pts_desc": sample_descriptors(desc, refined), "valid": valid}
