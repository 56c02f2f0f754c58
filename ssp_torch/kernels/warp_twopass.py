"""Projective image warping by two 1-D resampling passes (port of
``ssp/kernels/warp_twopass.py``).

A projective warp factors into a vertical resample (per column) followed by
a horizontal resample (per row), the Catmull–Smith decomposition; each pass
is one launch of the resample kernel (``ssp_torch.kernels.vresample``) over
a whole batch of warps.  The decomposition degenerates for rotations near
±90°, so the homography's mean rotation is bucketed to the nearest multiple
of 90°: the exact 90° part is an array rotation and the two passes handle
the ≤ 45° residual.  Rectangular images are embedded top-left in a square
canvas of side ``max(H, W)`` with the homography conjugated by the affine
between canvas and image coordinates, so all rotation buckets share one
shape, and crop-aware keep bounds kill the canvas pixels that the final
crop discards.

What ``vmap`` did in the JAX package is a leading batch dimension here.
The warp is split in two: :func:`twopass_plan` does the 3×3 algebra, the
bucket choice and the passes' coefficients on the host (homographies that
live on the CPU, as the export and the training pipeline sample them, cost
nothing; homographies on the card cost one small copy to the host per
call), and :func:`twopass_apply` runs the two resample launches and turns
each warp by its own bucket in one gather with indices computed on the
device.  The apply never reads back from the card, so a CUDA graph can
replay it with the next plan copied in.

Accuracy: bilinear in each pass ≈ direct bilinear; the differences are
sub-pixel interpolation details, held against the gather warp in the tests.
Both passes are fp32 (the JAX package's off-TPU fallback is a bf16 one-hot
einsum; its TPU kernels, which this follows, are fp32).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ssp_torch._device import constant, to_device
from ssp_torch.core.homography import inv3
from ssp_torch.kernels.vresample import (KILL, vresample, vresample_coef, vresample_coef_plain,
                                          vresample_plain)

# The route of the two passes.  True (the coef route): the resample kernel
# rebuilds the coordinates itself (``vresample_coef``) from 20 scalars per warp
# and pass.  False (the rows route): they are built with tensor ops as
# [N, S, S] coordinate arrays that the kernel reads (``vresample``).  The JAX
# package keeps the rows route because its coef kernel lost on a TPU; on an
# H100 a whole homography-adaptation group of 8 images x 100 warps takes 77-90
# ms on the coef route against 96-99 ms on the rows route (H100 80GB HBM3, 700
# W, ``python -m ssp_torch.bench_ha --routes``), so the coef route is the
# default.
COEF_GRIDS = True


def _rot_k(k: int) -> torch.Tensor:
    """Rotation by k·90° in normalised square coords (x, y)."""
    c = [1.0, 0.0, -1.0, 0.0][k]
    s = [0.0, 1.0, 0.0, -1.0][k]
    return torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _entries(Hm: torch.Tensor):
    """The nine entries of ``Hm [N, 3, 3]``, each ``[N, 1, 1]``."""
    return tuple(Hm[:, r, c, None, None] for r in range(3) for c in range(3))


def _guard(den: torch.Tensor) -> torch.Tensor:
    return torch.where(den.abs() < 1e-8, torch.full_like(den, 1e-8), den)


def _twopass_grids(Hm: torch.Tensor, S: int, keep1: torch.Tensor,
                   keep2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coordinate grids of both passes for ``out(p) = img(Hm·p)`` on a square
    ``[S, S]`` canvas, ``Hm [N, 3, 3]``, |rotation| ≲ 45°.

    ``keep1 [N, S]`` / ``keep2 [N, S, S]`` mark the pass-1 output rows and
    pass-2 output pixels that are consumed downstream; the others get the
    kill value.  With Hm = [[a,b,c],[d,e,f],[g,h,i]] mapping output
    normalised (x, y) to source (u, v):

      pass 2 (horizontal): out(x, y) = tmp(u(x, y), y)
      pass 1 (vertical):   tmp(x', y) = img(x', v₁(x', y))

    where v₁(x', y) = v(x(x', y), y) and x(x', y) solves u(x, y) = x':
      x = (b·y + c − x'·(h·y + i)) / (x'·g − a)

    Returns (rows [N, S, S], cols [N, S, S]) in pixel units.
    """
    a, b, c, d, e, f, g, h, i = _entries(Hm)
    lin = torch.linspace(-1.0, 1.0, S, device=Hm.device)
    to_pix = (S - 1) / 2.0
    kill = torch.full((), KILL, device=Hm.device)

    # pass 1: vertical resample, grid over (x', y_out)
    xp, yo = lin[None, None, :], lin[None, :, None]
    x_src = (b * yo + c - xp * (h * yo + i)) / _guard(xp * g - a)
    v1 = (d * x_src + e * yo + f) / _guard(g * x_src + h * yo + i)
    rows = (v1 + 1.0) * to_pix
    # kill rows where the solve ran away (x far outside the canvas)
    rows = torch.where((x_src.abs() <= 1.5) & keep1[:, :, None], rows, kill)

    # pass 2: horizontal resample, grid over (y, x_out)
    u = (a * xp + b * yo + c) / _guard(g * xp + h * yo + i)
    cols = torch.where(keep2, (u + 1.0) * to_pix, kill)
    return rows, cols


def _vresample(img: torch.Tensor, rows: torch.Tensor, reference: bool = False) -> torch.Tensor:
    """``out[n, o, x] = img[m](rows[n, o, x], x)``, bilinear along axis 0,
    zero padding; rows in pixel units.  One launch of the resample kernel
    (its plain version with ``reference``)."""
    return (vresample_plain if reference else vresample)(img, rows, axis=0)


def _hresample(img: torch.Tensor, cols: torch.Tensor, reference: bool = False) -> torch.Tensor:
    """``out[n, y, o] = img[m](y, cols[n, y, o])``, bilinear along axis 1,
    zero padding.  The kernel takes the axis, so nothing is transposed."""
    return (vresample_plain if reference else vresample)(img, cols, axis=1)


def _twopass_square(img: torch.Tensor, Hm: torch.Tensor, keep1: torch.Tensor,
                    keep2: torch.Tensor, reference: bool = False) -> torch.Tensor:
    """``out[n](p) = img[m](Hm[n]·p)`` on square canvases ``[S, S]`` or
    ``[M, S, S]`` through coordinate arrays: a vertical, then a horizontal
    resample."""
    rows, cols = _twopass_grids(Hm, img.shape[-1], keep1, keep2)
    return _hresample(_vresample(img, rows, reference), cols, reference)


def _pass_coefs(Hm: torch.Tensor, rlo, rhi, clo, chi, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form bilinear-rational coefficients for both passes, batched:
    ``Hm [N, 3, 3]``, bounds ``[N]`` (or scalars) → two ``[N, 20]`` tensors
    for ``vresample_coef`` (num 4, den 4, kill_num 4, kill_den 4, keep
    bounds 4).

    Pass 1's source row on the (output row o = y, column x') grid is
    v₁ = N/D with

      N = (dc−af) + (fg−di)·x' + (db−ae)·y + (eg−dh)·x'y
      D = (gc−ai) + (gb−ah)·y                      (x'-independent)

    and the runaway-solve kill |x_src| > 1.5 becomes the divide-free
    |by+c−x'(hy+i)| > 1.5·|gx'−a|.  Pass 2 resamples along the columns, so
    on its (o = x_out, line = y) grid the source column is
    u = (c + b·y + a·x_out)/(i + h·y + g·x_out).
    """
    a, b, c = Hm[:, 0, 0], Hm[:, 0, 1], Hm[:, 0, 2]
    d, e, f = Hm[:, 1, 0], Hm[:, 1, 1], Hm[:, 1, 2]
    g, h, i = Hm[:, 2, 0], Hm[:, 2, 1], Hm[:, 2, 2]
    z, one = torch.zeros_like(a), torch.ones_like(a)
    rlo, rhi, clo, chi = (torch.as_tensor(v, dtype=a.dtype, device=a.device).expand_as(a)
                          for v in (rlo, rhi, clo, chi))
    Sf = torch.full_like(a, float(S))
    coef1 = torch.stack([
        d * c - a * f, f * g - d * i, d * b - a * e, e * g - d * h,
        g * c - a * i, z, g * b - a * h, z,
        c, -i, b, -h,
        -a, g, z, z,
        rlo, rhi, z, Sf,
    ], dim=-1)
    coef2 = torch.stack([
        c, b, a, z,
        i, h, g, z,
        z, z, z, z,
        one, z, z, z,
        clo, chi, rlo, rhi,
    ], dim=-1)
    return coef1.float(), coef2.float()


def _mean_rotation_bucket(Hm: torch.Tensor) -> torch.Tensor:
    """Nearest multiple of 90° of each homography's mean rotation, [N] in
    0..3."""
    Hn = Hm / Hm[..., 2:3, 2:3]
    theta = torch.atan2(Hn[..., 1, 0] - Hn[..., 0, 1], Hn[..., 0, 0] + Hn[..., 1, 1])
    return torch.remainder(torch.round(theta / (math.pi / 2)).long(), 4)


def _residual(Hm: torch.Tensor, H_px: int, W_px: int):
    """Hm ``[N, 3, 3]`` for an ``[H_px, W_px]`` image → (residual homographies
    ``Hres [N, 3, 3]`` on the square canvas after the 90° bucketing, keep
    bounds ``(rlo, rhi, clo, chi)`` each ``[N]``, buckets ``k [N]``), all on
    Hm's device."""
    S = max(H_px, W_px)
    Hm = Hm.float()

    # embed into a square canvas (top-left) and conjugate Hm with the affine
    # between canvas-normalised and image-normalised coords:
    # x_img = s_x·x_canvas + (s_x − 1),  s_x = (S−1)/(W−1)
    sx = (S - 1) / (W_px - 1)
    sy = (S - 1) / (H_px - 1)
    T = torch.tensor([[sx, 0.0, sx - 1.0], [0.0, sy, sy - 1.0], [0.0, 0.0, 1.0]],
                     device=Hm.device)
    Hc = inv3(T) @ Hm @ T

    # Hres = Hc ∘ Rk⁻¹ by table lookup
    k = _mean_rotation_bucket(Hc)
    rk_inv = torch.stack([_rot_k((4 - kk) % 4) for kk in range(4)]).to(Hm.device)
    Hres = Hc @ rk_inv[k]

    # crop-aware keep bounds: the final ``rot90(mid, k)[:H, :W]`` consumes
    # only a content rectangle of ``mid`` (k=0: rows<H, cols<W; k=1: rows<W,
    # cols≥S−H; k=2: rows≥S−H, cols≥S−W; k=3: rows≥S−W, cols<H); everything
    # else on the padded square is dead work and is killed
    table = torch.tensor([[0, 0, S - H_px, S - W_px], [H_px, W_px, S, S],
                          [0, S - H_px, S - W_px, 0], [W_px, S, S, H_px]],
                         dtype=torch.float32, device=Hm.device)
    return Hres, tuple(row[k] for row in table), k


def _canvas(img: torch.Tensor) -> torch.Tensor:
    """img ``[H, W]`` or ``[M, H, W]`` zero-padded bottom-right to the square
    ``[S, S]`` canvas, S = max(H, W)."""
    H_px, W_px = img.shape[-2:]
    S = max(H_px, W_px)
    return F.pad(img, (0, S - W_px, 0, S - H_px)).contiguous()


def _canvas_and_residual(img: torch.Tensor, Hm: torch.Tensor):
    """The set-up of the two passes: img ``[H, W]`` or ``[M, H, W]``, Hm
    ``[N, 3, 3]`` → (square canvas, residual homographies ``Hres [N, 3, 3]``
    after the 90° bucketing, keep bounds ``(rlo, rhi, clo, chi)`` each
    ``[N]``, buckets ``k [N]``); the last three on Hm's device."""
    return (_canvas(img), *_residual(Hm, *img.shape[-2:]))


def _keep_masks(bounds: torch.Tensor, S: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep bounds ``[4, N]`` (rlo, rhi, clo, chi) → (keep1 ``[N, S]``, keep2
    ``[N, S, S]``) on ``device``."""
    ar = torch.arange(S, device=device, dtype=torch.float32)
    rlo, rhi, clo, chi = to_device(bounds, device)[:, :, None]
    keep1 = (ar >= rlo) & (ar < rhi)
    return keep1, keep1[:, :, None] & ((ar >= clo) & (ar < chi))[:, None, :]


def _rotate_crop(mid: torch.Tensor, k: torch.Tensor, H_px: int, W_px: int) -> torch.Tensor:
    """``rot90(mid[n], k[n], (0, 1))[:H_px, :W_px]`` for every warp ``n`` of
    ``mid [N, S, S]``, as one gather whose indices are computed on mid's
    device from ``k [N]`` (on that device too): the host needs no bucket, and the result is a
    copy of mid's values, bit for bit.

    The rotation by k·90° reads output pixel (i, j) from mid's (row, col) =
    (i, j), (j, S−1−i), (S−1−i, S−1−j), (S−1−j, i) for k = 0..3: the flat
    offset α·i + β·j + γ with (α, β, γ) from a table by k."""
    N, S = mid.shape[0], mid.shape[-1]
    dev = mid.device
    table = constant(torch.tensor([[S, 1, 0], [-1, S, S - 1], [-S, -1, S * S - 1],
                                   [1, -S, S * (S - 1)]]), dev)
    a, b, c = (t[:, None, None] for t in table[k].unbind(-1))
    base = torch.arange(N, device=dev)[:, None, None] * (S * S) + c
    idx = (base + a * torch.arange(H_px, device=dev)[:, None]
           + b * torch.arange(W_px, device=dev)[None, :])
    return torch.take(mid, idx)


def twopass_plan(Hm: torch.Tensor, H_px: int, W_px: int) -> Dict[str, torch.Tensor]:
    """The host half of the warp of ``[H_px, W_px]`` images by ``Hm [N, 3,
    3]`` (on any device; taken to the host): the 3×3 algebra, the rotation
    buckets and the keep bounds, as CPU tensors of fixed shapes.  On the coef
    route ``{"coef1", "coef2"}`` (``[N, 20]`` each, the two passes'
    coefficients), on the rows route ``{"Hres" [N, 3, 3], "bounds" [4,
    N]}``; both with ``"k" [N]``, the buckets.  A plan may be made while the
    card is busy and copied over with the next launch (``ssp_torch.graphs``)."""
    Hres, bounds, k = _residual(Hm.detach().cpu(), H_px, W_px)
    if COEF_GRIDS:
        coef1, coef2 = _pass_coefs(Hres, *bounds, max(H_px, W_px))
        return {"coef1": coef1, "coef2": coef2, "k": k}
    return {"Hres": Hres, "bounds": torch.stack(bounds), "k": k}


def twopass_apply(img: torch.Tensor, plan: Dict[str, torch.Tensor],
                  reference: bool = False) -> torch.Tensor:
    """The device half: img ``[H, W]`` or ``[M, H, W]`` warped by
    :func:`twopass_plan`'s ``plan`` (its tensors on the host or already on
    img's device) → ``[N, H, W]``.  Two launches of the resample kernel
    (their plain versions with ``reference``) and one gather; nothing is read
    back to the host, so the call can be captured in a CUDA graph."""
    H_px, W_px = img.shape[-2:]
    dev = img.device
    canvas = _canvas(img)
    if "coef1" in plan:
        resample = vresample_coef_plain if reference else vresample_coef
        tmp = resample(canvas, to_device(plan["coef1"], dev), axis=0)
        mid = resample(tmp, to_device(plan["coef2"], dev), axis=1)
    else:
        keep1, keep2 = _keep_masks(plan["bounds"], canvas.shape[-1], dev)
        mid = _twopass_square(canvas, to_device(plan["Hres"], dev), keep1, keep2, reference)
    return _rotate_crop(mid, to_device(plan["k"], dev), H_px, W_px)


def inv_warp_image_twopass(img: torch.Tensor, Hm: torch.Tensor,
                           reference: bool = False) -> torch.Tensor:
    """Twin of ``ssp_torch.core.warp.inv_warp_image`` (bilinear) for
    single-channel images: :func:`twopass_plan` then :func:`twopass_apply`.

    img ``[H, W]`` (shared by all warps) or ``[M, H, W]`` fp32; Hm
    ``[N, 3, 3]`` (or ``[3, 3]`` with a 2-D image) acting on [-1, 1]²
    normalised output coords (align-corners convention), ``N % M == 0``,
    warp ``n`` reading image ``n // (N/M)``.  Hm may live on the CPU while
    the images are on the card (module docstring).  Returns ``[N, H, W]``
    (``[H, W]`` for a single homography).  ``reference=True`` runs the
    resample kernels' plain versions instead (the card-side check of the
    kernels).
    """
    single = Hm.dim() == 2
    if single:
        if img.dim() != 2:
            raise ValueError("one homography takes one [H, W] image")
        Hm = Hm[None]
    if img.dim() not in (2, 3) or Hm.shape[1:] != (3, 3):
        raise ValueError(f"img {tuple(img.shape)}, Hm {tuple(Hm.shape)}: expected [H, W] or "
                         f"[M, H, W] and [N, 3, 3]")
    out = twopass_apply(img, twopass_plan(Hm, *img.shape[-2:]), reference)
    return out[0] if single else out
