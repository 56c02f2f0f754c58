"""Image warping and valid masks by gather-based sampling (port of
``ssp/core/warp.py``).

Coordinates are pixel units, (x, y); out-of-bounds neighbours contribute
zero, as ``grid_sample(padding_mode="zeros", align_corners=True)`` does:
normalised x ∈ [-1, 1] maps linearly onto pixel centres ``0 … W-1``.
Unlike the JAX original (one image, ``vmap`` for a batch), the image may
carry leading batch dimensions that the coordinates share.

The erosion's structuring element is OpenCV's ``MORPH_ELLIPSE``, computed
here (:func:`_ellipse_element`): the port does not import ``cv2``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ssp_torch._device import constant
from ssp_torch.core.homography import warp_points
from ssp_torch.kernels.ordered_scatter import gather_rows


def _gather_hw(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img [*L, H, W, C], integer index maps iy/ix [*L, ...] → [*L, ..., C]
    (indices clipped into the image).  The gradient sums in a fixed order
    (:func:`~ssp_torch.kernels.ordered_scatter.gather_rows`)."""
    H, W, C = img.shape[-3:]
    R = math.prod(img.shape[:-3])
    iy = iy.clamp(0, H - 1)
    ix = ix.clamp(0, W - 1)
    idx = (iy * W + ix).reshape(R, -1)
    out = gather_rows(img.reshape(R, H * W, C), idx)
    return out.reshape(*iy.shape, C)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [*L, H, W, C]; coords [*L, ..., 2] (x, y) in pixel units →
    [*L, ..., C], zero padding outside the image."""
    H, W = img.shape[-3], img.shape[-2]
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    # the four taps in one gather, [*L, 4, ...]: one backward for all of them
    lead = img.dim() - 3
    iy = torch.stack([y0i, y0i, y0i + 1, y0i + 1], dim=lead)
    ix = torch.stack([x0i, x0i + 1, x0i, x0i + 1], dim=lead)
    ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    taps = _gather_hw(img, iy, ix) * ok[..., None].to(img.dtype)
    v00, v01, v10, v11 = taps.unbind(lead)

    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def nearest_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample with zero padding (same contract as
    :func:`bilinear_sample`; halves round to even, as ``jnp.round``)."""
    H, W = img.shape[-3], img.shape[-2]
    ix = torch.round(coords[..., 0]).long()
    iy = torch.round(coords[..., 1]).long()
    ok = ((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W))[..., None]
    return _gather_hw(img, iy, ix) * ok.to(img.dtype)


def _norm_grid(H: int, W: int, device=None) -> torch.Tensor:
    """[-1, 1]² align-corners grid of shape [H, W, 2] (x, y)."""
    xs = torch.linspace(-1.0, 1.0, W, device=device)
    ys = torch.linspace(-1.0, 1.0, H, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _denorm(coords: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Normalised (x, y) in [-1, 1] → pixel coords (align_corners=True)."""
    x = (coords[..., 0] + 1.0) * (W - 1) / 2.0
    y = (coords[..., 1] + 1.0) * (H - 1) / 2.0
    return torch.stack([x, y], dim=-1)


def inv_warp_image(img: torch.Tensor, H_inv: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Inverse-warp ``img [*L, H, W, C]`` by ``H_inv [*L, 3, 3]`` (normalised
    coords): every output pixel's normalised coordinate is mapped through
    ``H_inv`` and the input is sampled there.  An image without leading
    dimensions is shared by a batch of homographies."""
    height, width, C = img.shape[-3:]
    lead = H_inv.shape[:-2]
    grid = _norm_grid(height, width, img.device).reshape(-1, 2)
    src_pix = _denorm(warp_points(grid, H_inv), height, width)
    sample = bilinear_sample if mode == "bilinear" else nearest_sample
    out = sample(img.expand(*lead, height, width, C), src_pix)
    return out.reshape(*lead, height, width, C)


def _ellipse_element(radius: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2·radius, 2·radius))``
    as a uint8 array, by OpenCV's rule: with r = c = radius, row ``i`` is set
    on columns ``[c − dx, c + dx]`` (clipped to the element), ``dx =
    round(c·sqrt((r² − (i − r)²)/r²))`` with halves to even."""
    size, r = 2 * radius, radius
    k = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        dx = int(round(r * math.sqrt((r * r - dy * dy) / float(r * r))))
        k[i, max(r - dx, 0):min(r + dx + 1, size)] = 1
    return k


def _ellipse_offsets(radius: int) -> np.ndarray:
    """Non-zero (dy, dx) offsets of the element about its anchor
    ``(radius, radius)``."""
    ys, xs = np.nonzero(_ellipse_element(radius))
    return np.stack([ys - radius, xs - radius], axis=-1)


def erode_mask(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary erosion of a 0/1 ``mask [..., H, W]`` by the ellipse element;
    pixels outside the image count as 1 (``cv2.erode``'s default border).

    The JAX package takes the minimum over thirty-odd shifted copies.  For a
    0/1 mask that minimum is 0 exactly where the element, anchored at the
    pixel, covers a 0: one correlation of ``1 − mask`` (zero padding: the
    outside is 1) with the element, whose sums of at most (2·radius)² ones
    are exact in fp32.
    """
    if radius <= 0:
        return mask
    H, W = mask.shape[-2:]
    k = constant(torch.from_numpy(_ellipse_element(radius)).to(mask.dtype), mask.device)
    # the anchor sits at (radius, radius) of a 2·radius element: offsets run
    # from −radius to radius − 1
    holes = F.pad((1.0 - mask).reshape(-1, 1, H, W), (radius, radius - 1, radius, radius - 1))
    hit = F.conv2d(holes, k[None, None]) > 0.5
    return torch.where(hit, 0.0, 1.0).to(mask.dtype).reshape(mask.shape)


def compute_valid_mask(shape: Tuple[int, int], H_inv: torch.Tensor,
                       erosion_radius: int = 0) -> torch.Tensor:
    """Mask ``[*L, H, W]`` (fp32 0/1) of the pixels that map inside the source
    image under ``H_inv [*L, 3, 3]``: the closed form of warping an all-ones
    image with nearest sampling (four inequality tests on the mapped
    normalised coordinate, half a pixel of rounding allowed), then the
    ellipse erosion."""
    H_px, W_px = shape
    grid = _norm_grid(H_px, W_px, H_inv.device).reshape(-1, 2)
    src = warp_points(grid, H_inv)
    hx = 1.0 / (W_px - 1)
    hy = 1.0 / (H_px - 1)
    ok = ((src[..., 0] >= -1.0 - hx) & (src[..., 0] <= 1.0 + hx)
          & (src[..., 1] >= -1.0 - hy) & (src[..., 1] <= 1.0 + hy))
    mask = ok.reshape(*H_inv.shape[:-2], H_px, W_px).float()
    return erode_mask(mask, erosion_radius)
