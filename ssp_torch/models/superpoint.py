"""SuperPoint / Semantic-SuperPoint backbone as a PyTorch ``nn.Module``.

Port of ``ssp/models/superpoint.py::SuperPointGauss2``.  Parameter and
buffer names are the reference's own (``inc.conv.conv.0.weight``,
``down1.mpconv.1.conv.3.weight``, ``convPa``/``bnPa``, …, reference
``models/SuperPointNet_gauss2_ssmall.py``), so reference state dicts load
strictly with ``load_state_dict``; ``ssp_torch.models.weights`` maps the
JAX package's flax checkpoints onto the same names.

Numerics of the flax module at ``dtype=float32``: BatchNorm eps 1e-5
(flax momentum 0.9 = torch momentum 0.1), BN-then-ReLU, descriptors
L2-normalised with +1e-12, the semantic head upsampled ×8 bilinearly
with half-pixel centres (``jax.image.resize(..., "linear")`` =
``F.interpolate(mode="bilinear", align_corners=False)`` for upsampling).

Inputs and outputs are NHWC, as in the JAX package; the module permutes
to NCHW inside.  Training mode is ``module.train()``; ``eval()`` is the
flax ``train=False``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssp_torch._device import resolve_device
from ssp_torch.registry import register

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # flax momentum 0.9


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class DoubleConv(nn.Module):
    """(conv3×3 → BN → ReLU) × 2 — reference ``models/unet_parts.py``
    ``double_conv``; Sequential indices 0/1 and 3/4 hold conv/BN."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), _bn(cout), nn.ReLU(inplace=True),
            nn.Conv2d(cout, cout, 3, padding=1), _bn(cout), nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class InConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Down(nn.Module):
    """2×2 maxpool → DoubleConv (reference ``unet_parts.down``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mpconv(x)


class SuperPointGauss2(nn.Module):
    """Detector + descriptor (+ optional semantic head) network.

    ``forward(x [B, H, W, 1])`` returns NHWC tensors:
      ``semi`` [B, H/8, W/8, 65] — detector logits (65th = dustbin)
      ``desc`` [B, H/8, W/8, 256] — L2-normalised coarse descriptors
      ``sem``  [B, H, W, n_classes] — only when ``semantic=True``
    """

    def __init__(self, semantic: bool = False, n_classes: int = 133):
        super().__init__()
        c1, c2, c3, c4, c5, d1 = 64, 64, 128, 128, 256, 256
        self.semantic = semantic
        self.n_classes = n_classes
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
        if semantic:
            self.convDS = nn.Conv2d(c4, c5, 3, padding=1)
            self.bnS1 = _bn(c5)
            self.convSout = nn.Conv2d(c5, n_classes, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        feat = self.down3(self.down2(self.down1(self.inc(x))))
        semi = self.bnPb(self.convPb(F.relu(self.bnPa(self.convPa(feat)))))
        desc = self.bnDb(self.convDb(F.relu(self.bnDa(self.convDa(feat)))))
        desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-12)
        out = {"semi": semi.permute(0, 2, 3, 1), "desc": desc.permute(0, 2, 3, 1)}
        if self.semantic:
            sem = self.convSout(F.relu(self.bnS1(self.convDS(feat))))
            Hc, Wc = sem.shape[-2:]
            sem = F.interpolate(sem, size=(Hc * 8, Wc * 8), mode="bilinear", align_corners=False)
            out["sem"] = sem.permute(0, 2, 3, 1)
        return out


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise as the flax module does: He-uniform conv kernels,
    zero conv biases, BN scale 1 / bias 0 / mean 0 / var 1; random draws
    come from ``generator`` only."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                lim = math.sqrt(6.0 / fan_in)
                w = torch.empty(m.weight.shape).uniform_(-lim, lim, generator=generator)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


@register("model", "SuperPointNet_gauss2")
def _gauss2(**params) -> SuperPointGauss2:
    params.pop("n_classes", None)
    return SuperPointGauss2(semantic=False, **params)


@register("model", "SuperPointNet_gauss2_ssmall")
def _gauss2_ssmall(n_classes: int = 133, **params) -> SuperPointGauss2:
    return SuperPointGauss2(semantic=True, n_classes=n_classes, **params)


def build_model(name: str, *, device="cuda", generator: Optional[torch.Generator] = None,
                **params) -> SuperPointGauss2:
    """Model factory by reference-compatible name, in eval mode on
    ``device``.  With ``generator`` the weights are drawn from it
    (:func:`init_weights`); otherwise they are PyTorch's defaults, to be
    overwritten by a checkpoint."""
    from ssp_torch import registry

    dev = resolve_device(device)
    model = registry.get("model", name)(**params)
    if generator is not None:
        init_weights(model, generator)
    return model.to(dev).eval()
