"""The OpenCV drawing and filtering calls of the synthetic-shapes generator
and of the drawing helpers, without OpenCV (C++
``ssp_torch/csrc/raster_host.cpp``).

Each function reproduces, byte for byte, the ``cv2`` call it is named after
at the arguments ``ssp_torch.data.synthetic_shapes`` passes (8-bit
single-channel canvases, 8-connected lines, integer coordinates) or, for
:func:`line_aa` and :func:`circle_color`, those ``ssp_torch.utils.draw``
passes (8-bit canvases of 1, 3 or 4 channels, a colour per channel), or, for
:func:`warp_perspective`, those of the sequence evaluation
(``ssp_torch.cli.eval_sequence``: float32 images, bilinear) and of the
corpus tools (``ssp_torch.cli.make_synth_hpatches``, ``make_kitti_tree``:
uint8 and float32 images), or, for :func:`gaussian_blur_sigma`, those of
``ssp_torch.cli.make_coco_sem_labels``.  The
drawing functions paint into the uint8 array they are given, in place, as
``cv2`` does; the filters return a new array.  The library is built with
the system ``g++`` at first use (``ssp_torch.kernels._build``); its calls go
through ``ctypes``, which releases the GIL.
"""

from __future__ import annotations

import ctypes

import numpy as np


def _lib() -> ctypes.CDLL:
    from ssp_torch.kernels import _build

    lib = _build.load("raster_host")
    if not getattr(lib, "_ssp_typed", False):
        ptr, i, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
        lib.ssp_line.argtypes = [ptr, i, i, i64, i64, i64, i64, i, i]
        lib.ssp_fill_convex_poly.argtypes = [ptr, i, i, ptr, i, i]
        lib.ssp_fill_poly.argtypes = [ptr, i, i, ptr, i, i]
        lib.ssp_circle_filled.argtypes = [ptr, i, i, i, i, i, i]
        lib.ssp_circle_filled_color.argtypes = [ptr, i, i, i, i, i, i, ptr]
        lib.ssp_line_aa.argtypes = [ptr, i, i, i, i64, i64, i64, i64, ptr]
        lib.ssp_ellipse_filled.argtypes = [ptr, i, i, i, i, i, i, f64, i]
        lib.ssp_box_blur.argtypes = [ptr, ptr, i, i, i]
        lib.ssp_gaussian_blur.argtypes = [ptr, ptr, i, i, i]
        lib.ssp_affine_transform.argtypes = [ptr, ptr, ptr]
        lib.ssp_perspective_transform.argtypes = [ptr, ptr, ptr]
        lib.ssp_gaussian_blur_sigma.argtypes = [ptr, ptr, i, i, f64]
        lib.ssp_warp_perspective.argtypes = [ptr, i, i, ptr, i, i, ptr]
        lib.ssp_warp_perspective_u8.argtypes = [ptr, i, i, ptr, i, i, ptr]
        lib._ssp_typed = True
    return lib


def _canvas(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 2 or not img.flags.c_contiguous:
        raise ValueError(f"a canvas is a C-contiguous uint8 [H, W] array, not "
                         f"{img.dtype} {img.shape}")
    return img


def _points(pts) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(pts).reshape(-1, 2), dtype=np.int32)


def line(img: np.ndarray, pt1, pt2, color: int, thickness: int = 1) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness)``: integer (x, y) end
    points, anywhere (the segment is clipped to the canvas)."""
    _canvas(img)
    h, w = img.shape
    _lib().ssp_line(img.ctypes.data, h, w, int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1]),
                    int(color), int(thickness))


def fill_convex_poly(img: np.ndarray, pts, color: int) -> None:
    """``cv2.fillConvexPoly(img, pts, color)`` for int32 (x, y) vertices
    [N, 2] (degenerate or non-convex ones drawn as OpenCV draws them)."""
    _canvas(img)
    p = _points(pts)
    h, w = img.shape
    _lib().ssp_fill_convex_poly(img.ctypes.data, h, w, p.ctypes.data, len(p), int(color))


def fill_poly(img: np.ndarray, pts, color: int) -> None:
    """``cv2.fillPoly(img, [pts], color)`` for one int32 (x, y) contour."""
    _canvas(img)
    p = _points(pts)
    h, w = img.shape
    _lib().ssp_fill_poly(img.ctypes.data, h, w, p.ctypes.data, len(p), int(color))


def circle_filled(img: np.ndarray, center, radius: int, color: int) -> None:
    """``cv2.circle(img, center, radius, color, -1)``."""
    _canvas(img)
    h, w = img.shape
    _lib().ssp_circle_filled(img.ctypes.data, h, w, int(center[0]), int(center[1]),
                             int(radius), int(color))


def _color_canvas(img: np.ndarray, color) -> tuple:
    """(h, w, channels, the colour as uint8 bytes) of a C-contiguous uint8
    [H, W] or [H, W, C] canvas, C in 1..4; the colour has a value per
    channel (OpenCV's scalar, channel 0 first)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or not img.flags.c_contiguous or \
            (img.ndim == 3 and not 1 <= img.shape[2] <= 4):
        raise ValueError(f"a colour canvas is a C-contiguous uint8 [H, W] or [H, W, 1..4] "
                         f"array, not {img.dtype} {img.shape}")
    nch = 1 if img.ndim == 2 else img.shape[2]
    col = np.zeros(4, np.uint8)
    vals = [int(v) for v in np.atleast_1d(color)][:nch]
    col[:len(vals)] = vals
    return img.shape[0], img.shape[1], nch, col


def line_aa(img: np.ndarray, pt1, pt2, color) -> None:
    """``cv2.line(img, pt1, pt2, color, 1, cv2.LINE_AA)``: integer (x, y)
    end points, anywhere (the segment is clipped to the canvas); each pixel
    is blended towards ``color``."""
    h, w, nch, col = _color_canvas(img, color)
    _lib().ssp_line_aa(img.ctypes.data, h, w, nch, int(pt1[0]), int(pt1[1]), int(pt2[0]),
                       int(pt2[1]), col.ctypes.data)


def circle_color(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` on a canvas of 1-4
    channels."""
    h, w, nch, col = _color_canvas(img, color)
    _lib().ssp_circle_filled_color(img.ctypes.data, h, w, nch, int(center[0]), int(center[1]),
                                   int(radius), col.ctypes.data)


def ellipse_filled(img: np.ndarray, center, axes, angle: float, color: int) -> None:
    """``cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)``; OpenCV
    rounds ``angle`` to whole degrees."""
    _canvas(img)
    h, w = img.shape
    _lib().ssp_ellipse_filled(img.ctypes.data, h, w, int(center[0]), int(center[1]),
                              int(axes[0]), int(axes[1]), float(angle), int(color))


def blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` (odd ``k``, reflected borders)."""
    src = np.ascontiguousarray(_canvas(img))
    out = np.empty_like(src)
    _lib().ssp_box_blur(src.ctypes.data, out.ctypes.data, *src.shape, int(k))
    return out


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` (odd ``k`` ≥ 3)."""
    if k < 3 or k % 2 == 0:
        raise ValueError(f"GaussianBlur takes an odd kernel size >= 3, not {k}")
    src = np.ascontiguousarray(_canvas(img))
    out = np.empty_like(src)
    _lib().ssp_gaussian_blur(src.ctypes.data, out.ctypes.data, *src.shape, int(k))
    return out


def gaussian_blur_sigma(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)``: OpenCV's 8-bit kernel size
    ``cvRound(6 sigma + 1) | 1`` and taps from ``sigma`` (> 0)."""
    if not sigma > 0:
        raise ValueError(f"gaussian_blur_sigma takes a sigma > 0, not {sigma}")
    src = np.ascontiguousarray(_canvas(img))
    out = np.empty_like(src)
    _lib().ssp_gaussian_blur_sigma(src.ctypes.data, out.ctypes.data, *src.shape, float(sigma))
    return out


def affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getAffineTransform(src, dst)``: float32 [3, 2] pairs → [2, 3]
    float64."""
    s = np.ascontiguousarray(src, np.float32).reshape(3, 2)
    d = np.ascontiguousarray(dst, np.float32).reshape(3, 2)
    out = np.empty((2, 3), np.float64)
    _lib().ssp_affine_transform(s.ctypes.data, d.ctypes.data, out.ctypes.data)
    return out


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)``: float32 [4, 2] pairs →
    [3, 3] float64."""
    s = np.ascontiguousarray(src, np.float32).reshape(4, 2)
    d = np.ascontiguousarray(dst, np.float32).reshape(4, 2)
    out = np.empty((3, 3), np.float64)
    _lib().ssp_perspective_transform(s.ctypes.data, d.ctypes.data, out.ctypes.data)
    return out


def warp_perspective(img: np.ndarray, H: np.ndarray, dsize) -> np.ndarray:
    """``cv2.warpPerspective(img, H, dsize, flags=cv2.INTER_LINEAR)`` of a
    float32 or uint8 ``[h, w]`` image (``BORDER_CONSTANT`` 0), in its dtype;
    ``H`` [3, 3] maps the source to the destination, ``dsize`` is (width,
    height).  Any other dtype is taken as float32."""
    u8 = np.asarray(img).dtype == np.uint8
    src = np.ascontiguousarray(img, np.uint8 if u8 else np.float32)
    if src.ndim != 2:
        raise ValueError(f"a float32 or uint8 [H, W] image, not {img.dtype} {img.shape}")
    m = np.ascontiguousarray(H, np.float64).reshape(3, 3)
    dw, dh = (int(v) for v in dsize)
    out = np.empty((dh, dw), src.dtype)
    warp = _lib().ssp_warp_perspective_u8 if u8 else _lib().ssp_warp_perspective
    if warp(src.ctypes.data, src.shape[0], src.shape[1], out.ctypes.data, dh, dw,
            m.ctypes.data) != 0:
        raise ValueError("warp_perspective: the homography is singular")
    return out
