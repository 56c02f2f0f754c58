"""Batch preparation on the batch's device: from host batch to training
batch (port of ``ssp/data/pipeline.py``; reference ``datasets/Coco.py:341-404``
and ``datasets/data_tools.py``).

Photometric augmentation, homographic augmentation, the warped pair, point
warping, label and residual splatting, valid masks and the semantic warp.
The reference's semantics are kept: the warped pair resamples the *clean*
(pre-photometric) content, and the base and the warp get independent
photometric draws.

Conventions: points are (x, y) pixels; homographies act on align-corners
normalised coordinates ([-1, 1] ↔ pixel centres 0…W-1); ``H_pair`` maps base
points to warped-view points and images are resampled with its inverse
``H_pair_inv``.

**Warp route.**  As the JAX package switches on its backend, the images and
the semantic maps are warped by the two-pass warp on a CUDA tensor, one
batched call each through the ``vresample_coef`` kernel
(``ssp_torch.kernels.warp_twopass.inv_warp_image_twopass``), and by the
gather warp (``ssp_torch.core.warp.inv_warp_image``) on the CPU.
``warp="twopass"`` or ``"gather"`` forces a route; ``reference=True`` runs
the two-pass warp on the kernels' plain versions.

**Randomness.**  ``draws`` may hold any of ``"homographic"``, ``"pair"``
(each ``H_inv [B, 3, 3]``), ``"photo"`` and ``"photo_warped"`` (lists for
:func:`ssp_torch.data.photometric.photometric_augment`); what it lacks is
drawn.  Homographies come from ``host_generator`` on the CPU: the two-pass
warp then needs no copy back from the card to choose its rotation buckets.
Photometric values come from ``generator`` on the images' device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ssp_torch._device import to_device
from ssp_torch.core.homography import inv3, sample_homographies, warp_points
from ssp_torch.core.warp import compute_valid_mask, inv_warp_image
from ssp_torch.data.photometric import gaussian_blur, photometric_augment
from ssp_torch.kernels.warp_twopass import inv_warp_image_twopass


def pad_points(pts_list, k: Optional[int] = None):
    """Host side: ragged [(Nᵢ, 2)] → (points [B, K, 2] f32, valid [B, K])."""
    if k is None:
        k = max(max((len(p) for p in pts_list), default=1), 1)
    B = len(pts_list)
    points = np.zeros((B, k, 2), np.float32)
    valid = np.zeros((B, k), bool)
    for i, p in enumerate(pts_list):
        p = np.asarray(p, np.float32).reshape(-1, 2)[:k]
        points[i, : len(p)] = p
        valid[i, : len(p)] = True
    return points, valid


def _splat_index(pts: torch.Tensor, valid: torch.Tensor, shape: Tuple[int, int]):
    """(flat pixel index [B, N], in-frame and valid [B, N]) of points rounded
    to the nearest pixel (halves to even, as ``jnp.round``)."""
    H, W = shape
    ix = torch.round(pts[..., 0]).long()
    iy = torch.round(pts[..., 1]).long()
    ok = valid & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    return iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1), ok


def splat_labels(pts: torch.Tensor, valid: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Keypoints ``pts [B, N, 2]`` → binary ``[B, H, W]`` maps; invalid and
    out-of-frame points dropped, coincident points kept binary (scatter-max)."""
    H, W = shape
    lin, ok = _splat_index(pts, valid, shape)
    out = torch.zeros((pts.shape[0], H * W), device=pts.device)
    out.scatter_reduce_(1, lin, ok.float(), reduce="amax")
    return out.reshape(-1, H, W)


def splat_residuals(pts: torch.Tensor, valid: torch.Tensor,
                    shape: Tuple[int, int]) -> torch.Tensor:
    """``[B, H, W, 2]`` fractional offsets (x − round x, y − round y) summed at
    each keypoint's pixel (scatter-add; reference ``data_tools.py:58-60``)."""
    H, W = shape
    lin, ok = _splat_index(pts, valid, shape)
    res = (pts - torch.round(pts)) * ok[..., None]
    out = torch.zeros((pts.shape[0], H * W, 2), device=pts.device)
    out.scatter_add_(1, lin[..., None].expand(-1, -1, 2), res)
    return out.reshape(-1, H, W, 2)


def _norm_scale(H: int, W: int, device) -> torch.Tensor:
    return to_device(torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], dtype=torch.float32), device)


def _warp_sample(images: torch.Tensor, points: torch.Tensor, points_valid: torch.Tensor,
                 sem: Optional[torch.Tensor], H_inv: torch.Tensor, erosion: int,
                 ignore_class: int, sem_warp_mode: str, warp: str, reference: bool):
    """Warp (images, points, sem) by ``H_inv [B, 3, 3]`` (output → input).

    Returns (H_fwd, H_inv, warped images, warped points, points valid, valid
    mask, warped sem), all on the images' device.  ``H_inv`` may lie on the
    CPU: the two-pass warp reads it there."""
    B, H_px, W_px = images.shape
    dev = images.device
    H_inv = H_inv.float()
    H_dev = to_device(H_inv, dev)
    H_fwd = inv3(H_dev)

    def resample(x):
        if warp == "twopass":
            return inv_warp_image_twopass(x, H_inv, reference=reference)
        return inv_warp_image(x[..., None], H_dev)[..., 0]

    warped = resample(images)
    scale = _norm_scale(H_px, W_px, dev)
    wpts = (warp_points(points / scale - 1.0, H_fwd) + 1.0) * scale
    # points warped out of frame stop being labels (reference filter_points)
    points_valid = (points_valid & (wpts[..., 0] >= 0) & (wpts[..., 0] <= W_px - 1)
                    & (wpts[..., 1] >= 0) & (wpts[..., 1] <= H_px - 1))
    mask = compute_valid_mask((H_px, W_px), H_dev, erosion_radius=erosion)

    wsem = None
    if sem is not None:
        if sem_warp_mode == "bilinear":
            # the reference's semantics: class ids interpolated bilinearly as
            # floats, then truncated (``datasets/Coco_sem.py:406-409``)
            wsem_f = resample(sem.float())
        else:  # "nearest": exact label transport
            wsem_f = inv_warp_image(sem.float()[..., None], H_dev, mode="nearest")[..., 0]
        wsem = torch.where(mask > 0, wsem_f.int(),
                           torch.full_like(wsem_f, ignore_class, dtype=torch.int32))
    return H_fwd, H_dev, warped, wpts, points_valid, mask, wsem


def _labels_for(points, valid, shape, sigma):
    """labels_2d [B, H, W, 1] (with the optional Gaussian spread, each map
    divided by its peak) and labels_res [B, H, W, 2]."""
    labels = splat_labels(points, valid, shape)
    res = splat_residuals(points, valid, shape)
    if sigma:
        blurred = gaussian_blur(labels, float(sigma))
        peak = blurred.amax(dim=(1, 2), keepdim=True)
        labels = blurred / torch.clamp(peak, min=1e-6)
    return labels[..., None], res


def prepare_batch(
    images: torch.Tensor,
    points: torch.Tensor,
    points_valid: torch.Tensor,
    *,
    sem: Optional[torch.Tensor] = None,
    photometric: Optional[Dict[str, Any]] = None,
    homographic: Optional[Dict[str, Any]] = None,
    warped_pair: Optional[Dict[str, Any]] = None,
    gaussian_label_sigma: Optional[float] = None,
    ignore_class: int = 133,
    sem_warp_mode: str = "bilinear",
    generator: Optional[torch.Generator] = None,
    host_generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, Any]] = None,
    warp: Optional[str] = None,
    reference: bool = False,
) -> Dict[str, torch.Tensor]:
    """Host batch → training batch on the images' device.

    ``images [B, H, W]`` float in [0, 1], ``points [B, K, 2]`` (x, y),
    ``points_valid [B, K]``, optional ``sem [B, H, W]`` int.  The config
    dicts follow the reference's YAML schema.  Stages: (1) homographic
    augmentation rewrites the clean content (image, points, sem and mask
    move together); (2) the base view is the clean content with its own
    photometric draw; (3) the warped pair resamples the clean content with a
    fresh homography and its own photometric draw.  The output keys are the
    JAX package's.
    """
    draws = dict(draws or {})
    B, H_px, W_px = images.shape
    dev = images.device
    shape = (H_px, W_px)
    warp = warp or ("twopass" if dev.type == "cuda" else "gather")
    if warp not in ("twopass", "gather"):
        raise ValueError(f"warp route {warp!r}: expected 'twopass' or 'gather'")

    def homographies(name, cfg):
        if name in draws:
            return draws[name]
        params = {k: v for k, v in (cfg.get("params") or {}).items()
                  if k != "valid_border_margin"}
        return sample_homographies(B, generator=host_generator, **params)

    def photo(name, imgs):
        if not (photometric and photometric.get("enable")):
            return imgs
        return photometric_augment(imgs, photometric.get("primitives"),
                                   photometric.get("params"), generator=generator,
                                   draws=draws.get(name))

    common = dict(ignore_class=ignore_class, sem_warp_mode=sem_warp_mode, warp=warp,
                  reference=reference)
    clean = images
    valid_mask = torch.ones((B, H_px, W_px), device=dev)
    cur_sem = sem
    if homographic and homographic.get("enable"):
        _, _, clean, points, points_valid, valid_mask, cur_sem = _warp_sample(
            clean, points, points_valid, sem, homographies("homographic", homographic),
            int(homographic.get("valid_border_margin", 0)), **common)

    base = photo("photo", clean)
    labels_2d, labels_res = _labels_for(points, points_valid, shape, gaussian_label_sigma)
    batch: Dict[str, torch.Tensor] = {
        "image": base[..., None],
        "labels_2d": labels_2d,
        "labels_res": labels_res,
        "valid_mask": valid_mask,
        "points": points,
        "points_valid": points_valid,
    }
    if cur_sem is not None:
        batch["sem"] = cur_sem

    if warped_pair and warped_pair.get("enable"):
        H_fwd, H_inv, wclean, wpts, _, wmask, wsem = _warp_sample(
            clean, points, points_valid, cur_sem, homographies("pair", warped_pair),
            int(warped_pair.get("valid_border_margin", 0)), **common)
        wlabels, wres = _labels_for(wpts, points_valid, shape, gaussian_label_sigma)
        batch.update(
            warped_image=photo("photo_warped", wclean)[..., None],
            warped_labels_2d=wlabels,
            warped_res=wres,
            warped_valid_mask=wmask,
            H_pair=H_fwd,
            H_pair_inv=H_inv,
        )
        if wsem is not None:
            batch["warped_sem"] = wsem
    return batch
