"""SuperPoint / Semantic-SuperPoint backbone as a PyTorch ``nn.Module``.

Port of ``ssp/models/superpoint.py::SuperPointGauss2`` and
``SuperPointMagicLeap`` (the public MagicLeap SuperPoint, registered as
``SuperPointNet_pretrained``).  Parameter and
buffer names are the reference's own (``inc.conv.conv.0.weight``,
``down1.mpconv.1.conv.3.weight``, ``convPa``/``bnPa``, …, reference
``models/SuperPointNet_gauss2_ssmall.py``), so reference state dicts load
strictly with ``load_state_dict``; ``ssp_torch.models.weights`` maps the
JAX package's flax checkpoints onto the same names.

Numerics of the flax module: BatchNorm eps 1e-5 (flax momentum 0.9 =
torch momentum 0.1), BN-then-ReLU, descriptors L2-normalised with +1e-12,
the semantic head upsampled ×8 bilinearly with half-pixel centres
(``jax.image.resize(..., "linear")`` = ``F.interpolate(mode="bilinear",
align_corners=False)`` for upsampling).

Training mode is ``module.train()``; ``eval()`` is the flax ``train=False``.
In training mode BatchNorm normalises by the batch statistics and moves its
running variance towards the *biased* batch variance, as flax does
(:class:`BatchNorm`); ``nn.BatchNorm2d`` would take the unbiased one.

``dtype`` is the flax module's compute type.  ``torch.float32`` (the
default) is the flax module at ``dtype=float32``.  ``torch.bfloat16`` is
its default, which the JAX trainer builds: conv operands and outputs in
bf16 (parameters stay fp32 and are cast at each use), BatchNorm math in
fp32 with a bf16 output, ReLU and max pools in bf16, ``semi`` and
``sem`` cast to fp32 and the descriptor normalised in fp32.

Inputs and outputs are NHWC, as in the JAX package; the module permutes
to NCHW inside.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssp_torch._device import resolve_device
from ssp_torch.parallel import mesh
from ssp_torch.registry import register

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # flax momentum 0.9


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-variance update.

    Evaluation normalises by the running statistics.  Training normalises
    by the batch's mean and biased variance and then moves ``running_mean``
    and ``running_var`` a ``momentum`` of the way towards them, the
    variance *biased* (flax ``nn.BatchNorm``), where PyTorch's own update
    takes the unbiased one (n/(n−1)).  The batch statistics come out of the
    same ``F.batch_norm`` call (with momentum 1 into scratch buffers), so no
    extra pass reads the input.  The input may be bf16: the statistics and
    the affine are fp32 and the output takes the input's type.

    In a process group of more than one rank (``ssp_torch.parallel``) the
    batch is the global one, every rank's rows, as flax's BatchNorm sees it
    under GSPMD (:meth:`_forward_global`); ``nn.SyncBatchNorm`` would move
    the running variance by the unbiased variance again and gathers with
    ``all_gather``, which gloo refuses for CUDA tensors.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if mesh.world() > 1:
            return self._forward_global(x)
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            # ``var`` holds the unbiased variance: scale it back to the biased
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return out

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        """Training mode over the global batch of all ranks
        (``ssp_torch.parallel``): Σx, Σx² per channel and the count, at fp32
        (or wider), summed over the ranks by one differentiable all-reduce;
        the biased variance E[x²] − E[x]², as flax computes it; the running
        averages moved by the global mean and biased variance."""
        dt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dt)
        C = x.shape[1]
        local = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                           xf.new_full((1,), x.numel() // C)])
        sums = mesh.all_reduce_sum(local)
        n = sums[2 * C]
        mean = sums[:C] / n
        var = torch.clamp(sums[C:2 * C] / n - mean * mean, min=0.0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        out = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
            self.num_batches_tracked.add_(1)
        return out.to(x.dtype)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` at ``x``'s type: fp32 parameters cast at the use, as a
    flax ``nn.Conv(dtype=...)`` casts them."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=conv.padding)


def _out(t: torch.Tensor) -> torch.Tensor:
    """A head's output at fp32 or wider: a bf16 forward gives fp32, an fp64
    one keeps fp64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _cbr(conv: nn.Conv2d, bn: BatchNorm, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """flax ``ConvBNRelu``: conv at ``x``'s type, BatchNorm in fp32 with an
    output of ``x``'s type, ReLU (which commutes with that rounding)."""
    y = bn(_conv(conv, x))
    return F.relu(y) if relu else y


class DoubleConv(nn.Module):
    """(conv3×3 → BN → ReLU) × 2 — reference ``models/unet_parts.py``
    ``double_conv``; Sequential indices 0/1 and 3/4 hold conv/BN.  The
    Sequential keeps the reference's layout and names; the forward runs its
    convs and BNs through :func:`_cbr`, at the input's type."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), _bn(cout), nn.ReLU(inplace=True),
            nn.Conv2d(cout, cout, 3, padding=1), _bn(cout), nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.conv
        return _cbr(seq[3], seq[4], _cbr(seq[0], seq[1], x))


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
      ``sem_coarse`` [B, H/8, W/8, n_classes] fp32 in place of ``sem`` with
      ``upsample_sem=False`` (the training forward: the fused semantic CE
      reads the 1/8-resolution logits)
    """

    def __init__(self, semantic: bool = False, n_classes: int = 133,
                 dtype: Union[torch.dtype, str] = torch.float32):
        super().__init__()
        c1, c2, c3, c4, c5, d1 = 64, 64, 128, 128, 256, 256
        self.semantic = semantic
        self.n_classes = n_classes
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
        if semantic:
            self.convDS = nn.Conv2d(c4, c5, 3, padding=1)
            self.bnS1 = _bn(c5)
            self.convSout = nn.Conv2d(c5, n_classes, 1)

    def forward(self, x: torch.Tensor, upsample_sem: bool = True) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC → NCHW
        feat = self.down3(self.down2(self.down1(self.inc(x))))
        semi = _cbr(self.convPb, self.bnPb, _cbr(self.convPa, self.bnPa, feat), relu=False)
        desc = _out(_cbr(self.convDb, self.bnDb, _cbr(self.convDa, self.bnDa, feat), relu=False))
        desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-12)
        out = {"semi": _out(semi).permute(0, 2, 3, 1), "desc": desc.permute(0, 2, 3, 1)}
        if self.semantic:
            sem = _out(_conv(self.convSout, _cbr(self.convDS, self.bnS1, feat)))
            if upsample_sem:
                Hc, Wc = sem.shape[-2:]
                sem = F.interpolate(sem, size=(Hc * 8, Wc * 8), mode="bilinear",
                                    align_corners=False)
                out["sem"] = sem.permute(0, 2, 3, 1)
            else:
                out["sem_coarse"] = sem.permute(0, 2, 3, 1)
        return out


class SuperPointMagicLeap(nn.Module):
    """MagicLeap SuperPoint: a plain VGG encoder, no BatchNorm (reference
    ``models/SuperPointNet_pretrained.py:21-60``).

    Channels 64,64 | 64,64 | 128,128 | 128,128 with a 2×2 max pool after
    each of the first three pairs and ReLU after every 3×3 conv; heads
    ``convPa`` (3×3, 128→256, ReLU) → ``convPb`` (1×1, 65) and ``convDa`` →
    ``convDb`` (1×1, 256), the descriptors divided by their norm + 1e-12.
    Parameter names are the reference's (``conv1a.weight``, …), so
    ``superpoint_v1.pth`` loads strictly.  ``forward(x [B, H, W, 1])``
    returns NHWC ``semi`` and ``desc``, as :class:`SuperPointGauss2` does.
    """

    def __init__(self):
        super().__init__()
        widths = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
                  ("conv3a", 64, 128), ("conv3b", 128, 128), ("conv4a", 128, 128),
                  ("conv4b", 128, 128))
        for name, cin, cout in widths:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convPa = nn.Conv2d(128, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa = nn.Conv2d(128, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, 256, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)  # NHWC → NCHW
        for stage in ("1", "2", "3", "4"):
            x = F.relu(getattr(self, f"conv{stage}a")(x))
            x = F.relu(getattr(self, f"conv{stage}b")(x))
            if stage != "4":
                x = F.max_pool2d(x, 2)
        semi = self.convPb(F.relu(self.convPa(x)))
        desc = self.convDb(F.relu(self.convDa(x)))
        desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-12)
        return {"semi": semi.permute(0, 2, 3, 1), "desc": desc.permute(0, 2, 3, 1)}


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


@register("model", "SuperPointNet_pretrained")
def _magicleap(**params) -> SuperPointMagicLeap:
    return SuperPointMagicLeap(**params)


def build_model(name: str, *, device="cuda", generator: Optional[torch.Generator] = None,
                **params) -> nn.Module:
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
