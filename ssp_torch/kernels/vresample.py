"""1-D bilinear resample along one axis of fp32 images, zero padding: the
two passes of the two-pass projective warp.

Replaces the TPU kernels ``ssp/kernels/vresample_pallas.py::vresample_pallas``
(:func:`vresample`: coordinates from an array) and
``::vresample_coef_pallas`` (:func:`vresample_coef`: coordinates rebuilt in
the kernel from 20 scalars per warp) with the CUDA kernels of
``ssp_torch/csrc/vresample.cu``.

The function: ``out[n, o, l] = Σ_i max(0, 1 − |r − i|)·img[m, i, l]`` with
``o`` along the resampled axis, ``l`` the other axis and ``r`` the source
coordinate of the output pixel in pixel units.  At most two terms are
non-zero: ``⌊r⌋`` with weight ``1 − f`` and ``⌊r⌋ + 1`` with weight ``f``,
each dropped outside ``[0, L − 1]``.  A coordinate outside ``(−1, L)``
(the kill value −10, ±1e9, ±inf) gives 0, and so does NaN.

What bounds it on an H100: bytes.  Per output pixel the function reads 4 B
of coordinate (none from 20 scalars), writes 4 B and reads two taps that
neighbouring pixels share; there is next to no arithmetic.  The TPU kernels
loop over a band of source rows with hat weights because the TPU cannot
gather; their tiles, unroll, band search and ``S % 32`` rule are not carried
over.  Here one thread gathers the two taps of one output pixel, the
resampled axis is a parameter, so the horizontal pass makes no transposed
copy, and ``N`` warps read ``M`` images (``N % M == 0``, warp ``n`` reads
image ``n // (N/M)``) without the images being expanded.

:func:`vresample_plain` and :func:`vresample_coef_plain` compute the same
functions with PyTorch ops (floor/frac, two gathers, range masks) and are
what the wrappers run for a CPU tensor.  ``launches`` and ``coef_launches``
count the kernel launches of :func:`vresample` and :func:`vresample_coef`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ssp_torch.kernels import _build

KILL = -10.0  # coordinate that marks "no source"; any value ≤ −1 does
launches = 0
coef_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_COEF_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _batched(img: torch.Tensor, per_warp: torch.Tensor, what: str) -> Tuple[torch.Tensor, int, int]:
    """Checks shared by both wrappers → (img as [M, R, C], N, M)."""
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError(f"img must be float32 [R, C] or [M, R, C], got {img.dtype} "
                         f"{tuple(img.shape)}")
    if per_warp.dtype != torch.float32 or per_warp.device != img.device:
        raise ValueError(f"{what} must be float32 on img's device, got {per_warp.dtype} "
                         f"on {per_warp.device}")
    img3 = img if img.dim() == 3 else img[None]
    N, M = per_warp.shape[0], img3.shape[0]
    if N == 0 or N % M:
        raise ValueError(f"{N} warps do not divide over {M} images")
    return img3, N, M


def vresample_plain(img: torch.Tensor, coords: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """:func:`vresample` in plain PyTorch: floor and fraction, two gathers
    along ``axis``, range masks, all fp32."""
    squeeze = coords.dim() == 2
    img3, N, M = _batched(img, coords[None] if squeeze else coords, "coords")
    coords = coords.reshape(N, *coords.shape[-2:])
    dim = 2 + axis  # in the [M, N/M, R, C] view
    L = img3.shape[1 + axis]
    ok = (coords > -1.0) & (coords < float(L))
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    r = torch.where(ok, coords, zero)
    fl = torch.floor(r)
    f = r - fl
    i0 = fl.long().reshape(M, N // M, *coords.shape[1:])
    src = img3[:, None].expand(M, N // M, *img3.shape[1:])
    v0 = torch.gather(src, dim, i0.clamp(0, L - 1)).reshape(coords.shape)
    v1 = torch.gather(src, dim, (i0 + 1).clamp(0, L - 1)).reshape(coords.shape)
    i0 = i0.reshape(coords.shape)
    v0 = torch.where(i0 >= 0, v0, zero)
    v1 = torch.where(i0 + 1 < L, v1, zero)
    out = torch.where(ok, (1.0 - f) * v0 + f * v1, zero)
    return out[0] if squeeze else out


def vresample(img: torch.Tensor, coords: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``out[n, o, l] = img[m](coords[n, o, l], l)``: bilinear along ``axis``
    (0: rows, 1: columns) of the image, zero padding.

    img ``[R, C]`` or ``[M, R, C]`` fp32; coords ``[N, Ro, Co]`` (or
    ``[Ro, Co]`` with a 2-D image) fp32, pixel units along ``axis``, with
    the other dimension equal to the image's.  Returns coords' shape.  CPU
    tensors run :func:`vresample_plain`; CUDA tensors launch the kernel.
    """
    global launches
    if axis not in (0, 1) or coords.dim() not in (2, 3) or (coords.dim() == 2 and img.dim() != 2):
        raise ValueError(f"axis {axis}, img {tuple(img.shape)}, coords {tuple(coords.shape)}: "
                         f"expected axis 0/1 and [N, Ro, Co], or [Ro, Co] with an [R, C] image")
    img3, N, M = _batched(img, coords if coords.dim() == 3 else coords[None], "coords")
    Ro, Co = coords.shape[-2:]
    if coords.shape[-1 - axis] != img3.shape[2 - axis]:
        raise ValueError(f"coords {tuple(coords.shape)} and img {tuple(img.shape)} differ along "
                         f"the axis that is not resampled")
    if img.device.type == "cpu":
        return vresample_plain(img, coords, axis)
    if img.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {img.device}")
    if not (img.is_contiguous() and coords.is_contiguous()):
        raise ValueError("img and coords must be contiguous")
    out = torch.empty_like(coords)
    fn = _build.load("vresample").ssp_vresample_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(img.data_ptr(), coords.data_ptr(), out.data_ptr(), N, M, Ro, Co,
             img3.shape[1 + axis], axis, torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(err, "ssp_vresample_launch")
    launches += 1
    return out


def coef_coords(coefs: torch.Tensor, R: int, C: int, axis: int = 0) -> torch.Tensor:
    """The coordinate grids ``[N, R, C]`` that :func:`vresample_coef` builds
    in its kernel from ``coefs [N, 20]``, with tensor ops in the kernel's
    order, one rounding per operation.

    ``coefs[n] = [num(4), den(4), kill_num(4), kill_den(4), olo, ohi, llo,
    lhi]``; each quadruple ``(c0, c_l, c_o, c_ol)`` is bilinear over the
    normalised ``[-1, 1]`` indices ``Lo`` (along ``axis``) and ``Ll`` (the
    other axis).  ``r = (num/den + 1)·(L − 1)/2`` with ``|den|`` kept
    ≥ 1e-8, clipped to ``[−64, L + 64]``, and killed (−10) where
    ``|kill_num| > 1.5·|kill_den|`` or the pixel is outside the keep bounds
    ``olo ≤ o < ohi``, ``llo ≤ l < lhi``.
    """
    dev = coefs.device
    L, n_lines = (R, C) if axis == 0 else (C, R)
    io = torch.arange(L, device=dev, dtype=torch.float32)
    il = torch.arange(n_lines, device=dev, dtype=torch.float32)
    half = (L - 1) / 2.0
    # divisors as tensors on the device: PyTorch turns a division by a Python
    # number into a multiplication by its reciprocal, which rounds otherwise
    half_o = torch.full((), half, device=dev)
    half_l = torch.full((), (n_lines - 1) / 2.0, device=dev)
    Lo, Ll = io / half_o - 1.0, il / half_l - 1.0
    # broadcast to [N, R, C]: o runs along ``axis``
    if axis == 0:
        io, Lo, il, Ll = io[:, None], Lo[:, None], il[None, :], Ll[None, :]
    else:
        io, Lo, il, Ll = io[None, :], Lo[None, :], il[:, None], Ll[:, None]
    c = coefs[:, :, None, None]

    def q(k):
        return (c[:, k] + c[:, k + 1] * Ll) + (c[:, k + 2] + c[:, k + 3] * Ll) * Lo

    den = q(4)
    den = torch.where(den.abs() < 1e-8, torch.full_like(den, 1e-8), den)
    r = (q(0) / den + 1.0) * half
    keep = ((q(8).abs() <= 1.5 * q(12).abs())
            & (io >= c[:, 16]) & (io < c[:, 17]) & (il >= c[:, 18]) & (il < c[:, 19]))
    return torch.where(keep, r.clamp(-64.0, L + 64.0), torch.full_like(r, KILL))


def vresample_coef_plain(img: torch.Tensor, coefs: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """:func:`vresample_coef` in plain PyTorch: :func:`coef_coords`, then
    :func:`vresample_plain`."""
    squeeze = coefs.dim() == 1
    coords = coef_coords(coefs.reshape(-1, 20), *img.shape[-2:], axis)
    return vresample_plain(img, coords[0] if squeeze else coords, axis)


def vresample_coef(img: torch.Tensor, coefs: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The resample of :func:`vresample` with the coordinates rebuilt from
    ``coefs`` (see :func:`coef_coords`) inside the kernel: no coordinate
    array is read.

    img ``[R, C]`` or ``[M, R, C]`` fp32; coefs ``[N, 20]`` (or ``[20]`` with
    a 2-D image) fp32.  Returns ``[N, R, C]`` (or ``[R, C]``).  CPU tensors
    run :func:`vresample_coef_plain`; CUDA tensors launch the kernel.
    """
    global coef_launches
    if (axis not in (0, 1) or coefs.shape[-1] != 20 or coefs.dim() not in (1, 2)
            or (coefs.dim() == 1 and img.dim() != 2)):
        raise ValueError(f"axis {axis}, img {tuple(img.shape)}, coefs {tuple(coefs.shape)}: "
                         f"expected axis 0/1 and [N, 20], or [20] with an [R, C] image")
    img3, N, M = _batched(img, coefs.reshape(-1, 20), "coefs")
    R, C = img3.shape[1:]
    if R < 2 or C < 2:
        raise ValueError(f"img must be at least 2×2, got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return vresample_coef_plain(img, coefs, axis)
    if img.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {img.device}")
    if not (img.is_contiguous() and coefs.is_contiguous()):
        raise ValueError("img and coefs must be contiguous")
    out = torch.empty((N, R, C) if coefs.dim() == 2 else (R, C), dtype=torch.float32,
                      device=img.device)
    fn = _build.load("vresample").ssp_vresample_coef_launch
    fn.argtypes, fn.restype = _COEF_ARGTYPES, ctypes.c_int
    err = fn(img.data_ptr(), coefs.data_ptr(), out.data_ptr(), N, M, R, C, axis,
             torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(err, "ssp_vresample_coef_launch")
    coef_launches += 1
    return out
