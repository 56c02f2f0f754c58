"""The OpenCV primitives that the port's SIFT and ORB are built from
(``ssp_torch/csrc/features_host.cpp``), each callable alone: the surface
that the tests hold against ``cv2``.  The detectors themselves are in
:mod:`ssp_torch.export.features`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ssp_torch.export.features import _gray


def _lib() -> ctypes.CDLL:
    from ssp_torch.kernels import _build

    lib = _build.load("features_host")
    if not getattr(lib, "_ssp_primitives_typed", False):
        ptr, i, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.ssp_cv_gaussian_blur_f32.argtypes = [ptr, ptr, i, i, f64]
        lib.ssp_cv_gaussian_blur_u8_float.argtypes = [ptr, ptr, i, i, i, f64]
        lib.ssp_cv_gaussian_kernel_f32.argtypes = [i, f64, ptr]
        lib.ssp_cv_resize_f32.argtypes = [ptr, i, i, ptr, i, i, i]
        lib.ssp_cv_resize_linear_exact_u8.argtypes = [ptr, i, i, ptr, i, i]
        lib.ssp_cv_copy_make_border_u8.argtypes = [ptr, i, i, i, ptr]
        lib.ssp_cv_exp32f.argtypes = [ptr, ptr, i]
        lib.ssp_cv_fast_atan2.argtypes = [ptr, ptr, ptr, i]
        lib._ssp_primitives_typed = True
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def gaussian_blur_f32(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` on a float32 [H, W] image."""
    img = _f32(img)
    out = np.empty_like(img)
    _lib().ssp_cv_gaussian_blur_f32(img.ctypes.data, out.ctypes.data, *img.shape, float(sigma))
    return out


def gaussian_blur_u8_float(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur`` of an 8-bit image through OpenCV's float
    separable filter (its path for a sub-matrix, as ORB blurs its pyramid;
    ``cv2.sepFilter2D`` with the float kernel gives the same bytes)."""
    img = _gray(img)
    out = np.empty_like(img)
    _lib().ssp_cv_gaussian_blur_u8_float(img.ctypes.data, out.ctypes.data, *img.shape,
                                         int(ksize), float(sigma))
    return out


def gaussian_kernel_f32(n: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(n, sigma, cv2.CV_32F)`` as [n] (sigma > 0)."""
    out = np.empty(n, np.float32)
    _lib().ssp_cv_gaussian_kernel_f32(int(n), float(sigma), out.ctypes.data)
    return out


def resize_f32(img: np.ndarray, size: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR or INTER_NEAREST)``
    on float32; ``size`` is (w, h) as for OpenCV.  INTER_LINEAR is OpenCV's
    at SIFT's scale, twice the size, where every weight product is exact; at
    other scales a sum may round the other way."""
    img = _f32(img)
    w, h = size
    out = np.empty((h, w), np.float32)
    _lib().ssp_cv_resize_f32(img.ctypes.data, *img.shape, out.ctypes.data, h, w, int(nearest))
    return out


def resize_linear_exact_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR_EXACT)`` on
    8-bit."""
    img = _gray(img)
    w, h = size
    out = np.empty((h, w), np.uint8)
    _lib().ssp_cv_resize_linear_exact_u8(img.ctypes.data, *img.shape, out.ctypes.data, h, w)
    return out


def copy_make_border_u8(img: np.ndarray, border: int) -> np.ndarray:
    """``cv2.copyMakeBorder(img, b, b, b, b, cv2.BORDER_REFLECT_101)``."""
    img = _gray(img)
    out = np.empty((img.shape[0] + 2 * border, img.shape[1] + 2 * border), np.uint8)
    _lib().ssp_cv_copy_make_border_u8(img.ctypes.data, *img.shape, int(border), out.ctypes.data)
    return out


def exp32f(x: np.ndarray) -> np.ndarray:
    """``cv::hal::exp32f`` (``cv2.exp`` on float32) elementwise."""
    x = _f32(x)
    out = np.empty_like(x)
    _lib().ssp_cv_exp32f(x.ctypes.data, out.ctypes.data, x.size)
    return out


def fast_atan2(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``cv::fastAtan2`` in degrees (``cv2.phase(x, y, angleInDegrees=True)``)."""
    y, x = np.broadcast_arrays(_f32(y), _f32(x))
    y, x = _f32(y), _f32(x)
    out = np.empty_like(x)
    _lib().ssp_cv_fast_atan2(y.ctypes.data, x.ctypes.data, out.ctypes.data, x.size)
    return out
