"""Keypoint extraction and descriptor sampling (port of
``ssp/postprocess/points.py``).

Keypoints are ``(pts [K, 3] = (x, y, score), valid [K])``: an exact top-K
over the NMS'd heatmap with a confidence mask.  Ties come out as
``lax.top_k`` returns them, lowest index first — after NMS most scores are
0, so the tail of a K=1000 top-K is all ties.

``sample_descriptors_mxu`` and ``approx_max_k`` of the JAX package are TPU
workarounds for slow gathers and are not carried over: on the GPU the
gather sampler and the exact top-K are the path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ssp_torch.core.warp import bilinear_sample
from ssp_torch.kernels.nms import nms
from ssp_torch.postprocess.nms import zero_border

BORDER_REMOVE = 4  # reference border margin (utils/utils.py:588)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last dim, in
    descending order, equal values lowest index first (``lax.top_k``'s
    order): a stable descending sort."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def extract_keypoints(
    heatmap: torch.Tensor,
    k: int,
    conf_thresh: float = 0.015,
    nms_radius: int = 4,
    border: int = BORDER_REMOVE,
    nms_iterations: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """heatmap [*L, H, W] → (pts [*L, k, 3] (x, y, score) desc-sorted,
    valid [*L, k]).

    NMS → border removal → top-k → threshold mask.  With ``nms_radius > 0``
    suppression and border removal run in one call of
    ``ssp_torch.kernels.nms.nms`` (the kernel on a CUDA tensor, its plain
    version on a CPU one); ``nms_radius=0`` takes the heatmap as already
    suppressed.
    """
    H, W = heatmap.shape[-2:]
    if nms_radius > 0:
        flat = heatmap.reshape(-1, H, W).contiguous()
        nmsed = nms(flat, nms_radius, nms_iterations, border).reshape(heatmap.shape)
    elif border:
        nmsed = zero_border(heatmap, border)
    else:
        nmsed = heatmap
    scores, idx = top_k(nmsed.flatten(-2), k)
    pts = torch.stack([(idx % W).float(), (idx // W).float(), scores], dim=-1)
    return pts, scores >= conf_thresh


def sample_descriptors(coarse_desc: torch.Tensor, pts: torch.Tensor,
                       cell: int = 8) -> torch.Tensor:
    """Bilinearly sample and re-normalise descriptors at keypoints.

    coarse_desc [*L, Hc, Wc, D]; pts [*L, K, ≥2] with (x, y) in full-res
    pixels → [*L, K, D].  Coarse coordinate ``cx = x·(Wc−1)/W`` (the
    reference's ``grid_sample(align_corners=True)`` after ``x → 2x/W − 1``).
    """
    Hc, Wc = coarse_desc.shape[-3], coarse_desc.shape[-2]
    H, W = Hc * cell, Wc * cell
    cx = pts[..., 0] * (Wc - 1) / W
    cy = pts[..., 1] * (Hc - 1) / H
    desc = bilinear_sample(coarse_desc, torch.stack([cx, cy], dim=-1))
    return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-12)


def _extract_patches(heatmap: torch.Tensor, pts: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero-padded ``patch_size``² windows centred at the integer part of
    ``pts [*L, K, ≥2]`` in ``heatmap [*L, H, W]`` → [*L, K, p, p]."""
    pad = patch_size // 2
    padded = F.pad(heatmap, (pad, pad, pad, pad))
    Hp, Wp = padded.shape[-2:]
    d = torch.arange(patch_size, device=heatmap.device)
    # top-left of the window in padded coords is exactly (iy, ix) because of
    # the symmetric pad
    rows = (pts[..., 1].long()[..., None, None] + d[:, None]).clamp(0, Hp - 1)
    cols = (pts[..., 0].long()[..., None, None] + d[None, :]).clamp(0, Wp - 1)
    flat = (rows * Wp + cols).flatten(-3)
    out = torch.gather(padded.flatten(-2), -1, flat)
    return out.reshape(*pts.shape[:-1], patch_size, patch_size)


def soft_argmax_refine(heatmap: torch.Tensor, pts: torch.Tensor,
                       patch_size: int = 5) -> torch.Tensor:
    """Subpixel refinement by a spatial soft-argmax over local patches:
    patch → normalise by its sum → log → softmax expectation in pixel units
    → offset = expectation − patch//2.  heatmap [*L, H, W], pts [*L, K, 3] →
    refined pts [*L, K, 3] (score column preserved)."""
    patches = _extract_patches(heatmap, pts, patch_size)
    patches = patches / (patches.sum(dim=(-2, -1), keepdim=True) + 1e-6)
    logp = torch.log(torch.where(patches <= 0.0, torch.full_like(patches, 1e-24), patches))
    w = torch.softmax(logp.flatten(-2), dim=-1).reshape(patches.shape)
    grid = torch.arange(patch_size, dtype=torch.float32, device=heatmap.device)
    ex = (w * grid).sum(dim=(-2, -1))
    ey = (w * grid[:, None]).sum(dim=(-2, -1))
    offset = torch.stack([ex, ey], dim=-1) - patch_size // 2
    return torch.cat([pts[..., :2] + offset, pts[..., 2:]], dim=-1)
