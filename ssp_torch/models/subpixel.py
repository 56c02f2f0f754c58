"""SubpixelNet: the SuperPoint encoder and heads with a UNet decoder that
predicts dense subpixel offsets (port of ``ssp/models/subpixel.py``;
reference ``models/SubpixelNet.py:13-90``, deprecated there).

The encoder (``inc``, ``down1``-``down3``) and the detector and descriptor
heads are :class:`~ssp_torch.models.superpoint.SuperPointGauss2`'s, under
the same parameter names, so the folded forward reads a SubpixelNet's
``semi`` and ``desc`` as it reads gauss2's.  The decoder is three
:class:`Up` blocks (×2 bilinear upsampling with half-pixel centres, which is
``jax.image.resize(..., "linear")`` at ×2, then the skip concatenated after
the upsampled map, then a ``DoubleConv``) and ``outc``, a 1×1 conv with a
bias and no BatchNorm, to ``subpixel_channel`` offsets at the input's
resolution.  ``dtype`` is the compute type as in ``SuperPointGauss2``, bf16
by default as flax's module; ``semi``, ``desc`` and ``subpixel`` come out at
fp32 (or wider).  Inputs and outputs are NHWC.
"""

from __future__ import annotations

from typing import Dict, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssp_torch.models.superpoint import (DoubleConv, Down, InConv, _bn, _cbr, _conv, _out)
from ssp_torch.registry import register


class Up(nn.Module):
    """×2 bilinear upsampling, the skip concatenated after it, DoubleConv
    (reference ``unet_parts.up``; the JAX module's channel order)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        x = F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)
        return self.conv(torch.cat([x, skip.to(x.dtype)], dim=1))


class SubpixelNet(nn.Module):
    def __init__(self, subpixel_channel: int = 2,
                 dtype: Union[torch.dtype, str] = torch.bfloat16):
        super().__init__()
        c1, c2, c3, c4, c5, d1 = 64, 64, 128, 128, 256, 256
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.inc = InConv(1, c1)
        self.down1 = Down(c1, c2)
        self.down2 = Down(c2, c3)
        self.down3 = Down(c3, c4)
        self.convPa = nn.Conv2d(c4, c5, 3, padding=1)
        self.bnPa = _bn(c5)
        self.convPb = nn.Conv2d(c5, 65, 1)
        self.bnPb = _bn(65)
        self.convDa = nn.Conv2d(c4, c5, 3, padding=1)
        self.bnDa = _bn(c5)
        self.convDb = nn.Conv2d(c5, d1, 1)
        self.bnDb = _bn(d1)
        self.up1 = Up(c4 + c3, c2)
        self.up2 = Up(c2 + c2, c1)
        self.up3 = Up(c1 + c1, c1)
        self.outc = nn.Conv2d(c1, subpixel_channel, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x1 = self.inc(x.permute(0, 3, 1, 2).to(self.dtype))  # NHWC → NCHW
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        semi = _cbr(self.convPb, self.bnPb, _cbr(self.convPa, self.bnPa, x4), relu=False)
        desc = _out(_cbr(self.convDb, self.bnDb, _cbr(self.convDa, self.bnDa, x4), relu=False))
        desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-12)
        u = self.up3(self.up2(self.up1(x4, x3), x2), x1)
        return {"semi": _out(semi).permute(0, 2, 3, 1), "desc": desc.permute(0, 2, 3, 1),
                "subpixel": _out(_conv(self.outc, u)).permute(0, 2, 3, 1)}


@register("model", "SubpixelNet")
def _subpixel(**params) -> SubpixelNet:
    return SubpixelNet(**params)
