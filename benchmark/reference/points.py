"""Plain PyTorch keypoint extraction and description, as SuperPoint's
export defines them (eric-yyjau/pytorch-superpoint ``export.py``):

* non-maximum suppression on the heatmap: a point survives where it is the
  maximum of its (2r+1)² window, then twice more where it is the maximum
  once the windows of earlier survivors are cleared (iterated local maxima);
  then every point within ``border`` pixels of the edge is cleared;
* the ``k`` best scores, ties to the lowest index, valid where the score
  reaches ``conf_thresh``;
* subpixel refinement: the soft-argmax of the 5×5 patch of the heatmap
  (not the suppressed one) around each point, the patch normalised by its
  sum before its logarithm goes through a softmax;
* descriptors: bilinear samples of the coarse map at
  (x·(Wc−1)/W, y·(Hc−1)/H), zero outside, renormalised.

Nothing of the program under test is imported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _window_max(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.max_pool2d(x[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]


def nms(heat: torch.Tensor, radius: int, iterations: int = 3, border: int = 4) -> torch.Tensor:
    """heat [B, H, W] ≥ 0 → the same with non-maxima and the border zeroed."""
    zeros = torch.zeros_like(heat)
    keep = heat == _window_max(heat, radius)
    for _ in range(iterations - 1):
        cleared = _window_max(keep.float(), radius) > 0
        rest = torch.where(cleared, zeros, heat)
        keep = keep | ((rest == _window_max(rest, radius)) & ~cleared)
    out = torch.where(keep, heat, zeros)
    if border:
        out[:, :border] = 0
        out[:, -border:] = 0
        out[:, :, :border] = 0
        out[:, :, -border:] = 0
    return out


def top_k(suppressed: torch.Tensor, k: int, conf_thresh: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] → (pts [B, k, 3] (x, y, score), valid [B, k])."""
    B, H, W = suppressed.shape
    scores, idx = torch.sort(suppressed.reshape(B, H * W), dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    pts = torch.stack([(idx % W).float(), (idx // W).float(), scores], dim=-1)
    return pts, scores >= conf_thresh


def refine(heat: torch.Tensor, pts: torch.Tensor, patch: int = 5) -> torch.Tensor:
    """Soft-argmax refinement of pts [B, K, 3] on heat [B, H, W]."""
    B, H, W = heat.shape
    pad = patch // 2
    padded = F.pad(heat, (pad, pad, pad, pad))
    d = torch.arange(patch, device=heat.device)
    rows = pts[..., 1].long()[..., None, None] + d[:, None]
    cols = pts[..., 0].long()[..., None, None] + d[None, :]
    flat = (rows * (W + 2 * pad) + cols).reshape(B, -1)
    win = torch.gather(padded.reshape(B, -1), 1, flat).reshape(*pts.shape[:2], patch, patch)
    win = win / (win.sum(dim=(-2, -1), keepdim=True) + 1e-6)
    logp = torch.log(torch.where(win <= 0, torch.full_like(win, 1e-24), win))
    wts = torch.softmax(logp.flatten(-2), dim=-1).reshape(win.shape)
    grid = torch.arange(patch, dtype=torch.float32, device=heat.device)
    off = torch.stack([(wts * grid).sum(dim=(-2, -1)), (wts * grid[:, None]).sum(dim=(-2, -1))],
                      dim=-1) - pad
    return torch.cat([pts[..., :2] + off, pts[..., 2:]], dim=-1)


def sample_descriptors(desc: torch.Tensor, xy: torch.Tensor, cell: int = 8) -> torch.Tensor:
    """desc [B, D, Hc, Wc], xy [B, K, 2] in pixels → [B, K, D] unit vectors."""
    B, D, Hc, Wc = desc.shape
    x = xy[..., 0] * (Wc - 1) / (Wc * cell)
    y = xy[..., 1] * (Hc - 1) / (Hc * cell)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    flat = desc.reshape(B, D, Hc * Wc).transpose(1, 2)  # [B, Hc·Wc, D]

    def tap(yi, xi):
        ok = (yi >= 0) & (yi < Hc) & (xi >= 0) & (xi < Wc)
        idx = (yi.clamp(0, Hc - 1) * Wc + xi.clamp(0, Wc - 1)).long()
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, D))
        return v * ok[..., None]

    x0i, y0i = x0.long(), y0.long()
    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    out = top * (1 - fy) + bot * fy
    return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-12)


def detect_describe(heat: torch.Tensor, desc: torch.Tensor, *, top_k_: int, conf_thresh: float,
                    nms_radius: int, border: int = 4, subpixel: bool = True):
    """heat [B, H, W], coarse desc [B, D, Hc, Wc] → (pts [B, k, 3], valid [B, k],
    desc [B, k, D]): the export's keypoints and descriptors."""
    pts, valid = top_k(nms(heat, nms_radius, 3, border), top_k_, conf_thresh)
    if subpixel:
        pts = refine(heat, pts)
    return pts, valid, sample_descriptors(desc, pts[..., :2])
