"""Photometric augmentation of a batch on its device (port of
``ssp/data/photometric.py``; primitives and ranges from the reference's
``utils/photometric.py``, rpautrat/SuperPoint).

Six primitives, each in two halves: ``draw_<name>(shape, generator, device,
**params)`` draws the per-image random values, and ``<name>(imgs, draws,
**params)`` applies them.  A test can so feed the port the very values the
JAX package drew.  :func:`photometric_augment` draws (or takes) one dict per
listed primitive and applies them in order, as the JAX package does.

Images are ``[B, H, W]`` float in [0, 1]; parameter ranges keep the
reference's 0-255 units, so additive quantities are divided by 255.  The two
convolution-shaped primitives (motion blur, the shade's blur) run as one
grouped convolution with a kernel per image.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ssp_torch._device import constant

ALL_PRIMITIVES = (
    "random_brightness",
    "random_contrast",
    "additive_speckle_noise",
    "additive_gaussian_noise",
    "additive_shade",
    "motion_blur",
)

DEFAULT_PARAMS: Dict[str, Any] = {
    "random_brightness": {"max_abs_change": 50},
    "random_contrast": {"strength_range": [0.5, 1.5]},
    "additive_gaussian_noise": {"stddev_range": [0, 10]},
    "additive_speckle_noise": {"prob_range": [0, 0.0035]},
    "additive_shade": {"transparency_range": [-0.5, 0.5], "kernel_size_range": [100, 150],
                       "nb_ellipses": 20},
    "motion_blur": {"max_kernel_size": 3},
}


def _per_image_conv(imgs: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """imgs [B, H, W] ⊛ kernels [B, kh, kw] (odd sizes), 'same' zero
    padding, cross-correlation as ``lax.conv_general_dilated``: one grouped
    convolution, each image its own group."""
    B, kh, kw = kernels.shape
    out = F.conv2d(imgs[None], kernels[:, None].to(imgs.dtype), padding=(kh // 2, kw // 2),
                   groups=B)
    return out[0]


def gaussian_blur(imgs: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of ``imgs [B, H, W]``, radius
    ``max(ceil(3σ), 1)``, the kernel normalised to sum 1."""
    radius = max(int(math.ceil(3.0 * float(sigma))), 1)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=imgs.device)
    k1 = torch.exp(-0.5 * (x / sigma) ** 2)
    k1 = k1 / k1.sum()
    B = imgs.shape[0]
    kx = k1[None, None, :].expand(B, 1, -1)
    ky = k1[None, :, None].expand(B, -1, 1)
    return _per_image_conv(_per_image_conv(imgs, kx), ky)


def _uniform(shape, lo, hi, generator, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


# ---------------------------------------------------------------- draws
def draw_random_brightness(shape, generator=None, device="cpu", max_abs_change=50):
    m = max_abs_change / 255.0
    return {"delta": _uniform((shape[0], 1, 1), -m, m, generator, device)}


def draw_random_contrast(shape, generator=None, device="cpu", strength_range=(0.5, 1.5)):
    return {"f": _uniform((shape[0], 1, 1), strength_range[0], strength_range[1], generator,
                          device)}


def draw_additive_gaussian_noise(shape, generator=None, device="cpu", stddev_range=(0, 10)):
    return {"std": _uniform((shape[0], 1, 1), stddev_range[0] / 255.0, stddev_range[1] / 255.0,
                            generator, device),
            "noise": torch.randn(tuple(shape), generator=generator, device=device)}


def draw_additive_speckle_noise(shape, generator=None, device="cpu", prob_range=(0, 0.0035)):
    return {"p": _uniform((shape[0], 1, 1), prob_range[0], prob_range[1], generator, device),
            "u": torch.rand(tuple(shape), generator=generator, device=device)}


def draw_additive_shade(shape, generator=None, device="cpu", transparency_range=(-0.5, 0.8),
                        kernel_size_range=(50, 100), nb_ellipses=20):
    B, H, W = shape
    n = int(nb_ellipses)
    min_dim = min(H, W)
    return {
        "t": _uniform((B, 1, 1), transparency_range[0], transparency_range[1], generator, device),
        "centers": torch.rand((B, n, 2), generator=generator, device=device)
        * constant(torch.tensor([W, H], dtype=torch.float32), torch.device(device)),
        "radii": _uniform((B, n, 2), min_dim / 12.0, min_dim / 3.0, generator, device),
        "theta": _uniform((B, n), 0.0, math.pi, generator, device),
        "ks": _uniform((B, 1), kernel_size_range[0], kernel_size_range[1], generator, device),
    }


def draw_motion_blur(shape, generator=None, device="cpu", max_kernel_size=7):
    B = shape[0]
    K = int(max_kernel_size) | 1
    if K <= 1:
        return {}
    return {"theta": _uniform((B,), 0.0, math.pi, generator, device),
            "half": _uniform((B,), 0.5, K / 2.0, generator, device)}


# ---------------------------------------------------------- primitives
def random_brightness(imgs, d, max_abs_change=50):
    return torch.clamp(imgs + d["delta"], 0.0, 1.0)


def random_contrast(imgs, d, strength_range=(0.5, 1.5)):
    mean = imgs.mean(dim=(1, 2), keepdim=True)
    return torch.clamp((imgs - mean) * d["f"] + mean, 0.0, 1.0)


def additive_gaussian_noise(imgs, d, stddev_range=(0, 10)):
    return torch.clamp(imgs + d["noise"] * d["std"], 0.0, 1.0)


def additive_speckle_noise(imgs, d, prob_range=(0, 0.0035)):
    """Salt and pepper: with per-image probability p a pixel snaps to 0 or 1."""
    u, p = d["u"], d["p"]
    out = torch.where(u < p, torch.zeros_like(imgs), imgs)
    return torch.where(u > 1.0 - p, torch.ones_like(imgs), out)


def additive_shade(imgs, d, transparency_range=(-0.5, 0.8), kernel_size_range=(50, 100),
                   nb_ellipses=20):
    """Multiply by (1 − t·mask), the mask a blurred union of random ellipses,
    built and blurred at 4× downsample when the image divides evenly and
    bilinearly upsampled (the JAX package's design and its σ ≈ k/4 blur)."""
    B, H, W = imgs.shape
    dev = imgs.device
    centers, radii, theta = d["centers"], d["radii"], d["theta"]
    f = 4 if (H % 4 == 0 and W % 4 == 0) else 1
    Hm, Wm = H // f, W // f
    ys = torch.arange(Hm, dtype=torch.float32, device=dev)[:, None] * f + (f - 1) / 2.0
    xs = torch.arange(Wm, dtype=torch.float32, device=dev)[None, :] * f + (f - 1) / 2.0
    dx = xs[None, None] - centers[..., 0, None, None]
    dy = ys[None, None] - centers[..., 1, None, None]
    c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    u = (c * dx + s * dy) / radii[..., 0, None, None]
    v = (-s * dx + c * dy) / radii[..., 1, None, None]
    mask = (u * u + v * v <= 1.0).float().amax(dim=1)  # [B, Hm, Wm]

    sigma_max = kernel_size_range[1] / 4.0 / f
    radius = max(int(math.ceil(2.0 * sigma_max)), 1)
    xk = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    sigma = d["ks"] / 4.0 / f  # [B, 1]
    k1 = torch.exp(-0.5 * (xk[None, :] / sigma) ** 2)
    k1 = k1 / k1.sum(dim=-1, keepdim=True)
    mask = _per_image_conv(_per_image_conv(mask, k1[:, None, :]), k1[:, :, None])
    if f > 1:
        mask = F.interpolate(mask[:, None], size=(H, W), mode="bilinear",
                             align_corners=False)[:, 0]
    return torch.clamp(imgs * (1.0 - d["t"] * mask), 0.0, 1.0)


def motion_blur(imgs, d, max_kernel_size=7):
    """Directional blur: a soft line segment of random angle and length on a
    static (max_kernel_size)² grid, one grouped convolution."""
    K = int(max_kernel_size) | 1
    if K <= 1:
        return imgs
    r = K // 2
    grid = torch.arange(-r, r + 1, dtype=torch.float32, device=imgs.device)
    ys, xs = grid[:, None], grid[None, :]
    c, s = torch.cos(d["theta"])[:, None, None], torch.sin(d["theta"])[:, None, None]
    along = c * xs[None] + s * ys[None]
    perp = -s * xs[None] + c * ys[None]
    line = torch.clamp(1.0 - perp.abs(), 0.0, 1.0) * (along.abs() <= d["half"][:, None, None])
    line = line / torch.clamp(line.sum(dim=(1, 2), keepdim=True), min=1e-6)
    return _per_image_conv(imgs, line)


_PRIMITIVES = {
    "random_brightness": (draw_random_brightness, random_brightness),
    "random_contrast": (draw_random_contrast, random_contrast),
    "additive_gaussian_noise": (draw_additive_gaussian_noise, additive_gaussian_noise),
    "additive_speckle_noise": (draw_additive_speckle_noise, additive_speckle_noise),
    "additive_shade": (draw_additive_shade, additive_shade),
    "motion_blur": (draw_motion_blur, motion_blur),
}


def _configured(primitives: Optional[Sequence[str]], params: Optional[Dict[str, Any]]):
    """[(name, merged params)] in the listed order."""
    out = []
    for name in (list(primitives) if primitives else list(ALL_PRIMITIVES)):
        if name not in _PRIMITIVES:
            raise KeyError(f"unknown photometric primitive {name!r}")
        kw = dict(DEFAULT_PARAMS.get(name, {}))
        kw.update((params or {}).get(name, {}) or {})
        out.append((name, kw))
    return out


def draw_photometric(shape, primitives: Optional[Sequence[str]] = None,
                     params: Optional[Dict[str, Any]] = None,
                     generator: Optional[torch.Generator] = None,
                     device="cpu") -> List[Dict[str, torch.Tensor]]:
    """One draw dict per configured primitive, for images of ``shape``."""
    return [_PRIMITIVES[name][0](tuple(shape), generator, device, **kw)
            for name, kw in _configured(primitives, params)]


def photometric_augment(imgs: torch.Tensor, primitives: Optional[Sequence[str]] = None,
                        params: Optional[Dict[str, Any]] = None, *,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[List[Dict[str, torch.Tensor]]] = None) -> torch.Tensor:
    """The configured primitives applied in the listed order to ``imgs
    [B, H, W]`` (the reference's YAML schema), with ``draws`` or values drawn
    from ``generator`` on the images' device; the result clipped to [0, 1]."""
    cfg = _configured(primitives, params)
    if draws is None:
        draws = draw_photometric(imgs.shape, primitives, params, generator, imgs.device)
    if len(draws) != len(cfg):
        raise ValueError(f"{len(draws)} draws for {len(cfg)} primitives")
    out = imgs
    for (name, kw), d in zip(cfg, draws):
        out = _PRIMITIVES[name][1](out, d, **kw)
    return torch.clamp(out, 0.0, 1.0)
