"""Bilinear sampling with zero padding (port of ``ssp/core/warp.py``'s
``bilinear_sample`` and its gather helper).

Coordinates are pixel units, (x, y); out-of-bounds neighbours contribute
zero, as ``grid_sample(padding_mode="zeros", align_corners=True)`` does.
Unlike the JAX original (one image, ``vmap`` for a batch), the image may
carry leading batch dimensions that the coordinates share.
"""

from __future__ import annotations

import torch


def _gather_hw(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img [*L, H, W, C], integer index maps iy/ix [*L, ...] → [*L, ..., C]
    (indices clipped into the image)."""
    H, W, C = img.shape[-3:]
    lead = img.shape[:-3]
    iy = iy.clamp(0, H - 1)
    ix = ix.clamp(0, W - 1)
    flat = img.reshape(*lead, H * W, C)
    idx = (iy * W + ix).reshape(*lead, -1)
    out = torch.gather(flat, -2, idx[..., None].expand(*idx.shape, C))
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

    def inb(iy, ix):
        ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        return ok[..., None].to(img.dtype)

    v00 = _gather_hw(img, y0i, x0i) * inb(y0i, x0i)
    v01 = _gather_hw(img, y0i, x0i + 1) * inb(y0i, x0i + 1)
    v10 = _gather_hw(img, y0i + 1, x0i) * inb(y0i + 1, x0i)
    v11 = _gather_hw(img, y0i + 1, x0i + 1) * inb(y0i + 1, x0i + 1)

    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy
