"""OpenCV 5.0's SIFT and ORB without OpenCV (C++
``ssp_torch/csrc/features_host.cpp``).  The OpenCV primitives they are
built from are callable alone through ``ssp_torch.export._cv_primitives``,
for their tests against OpenCV.

:func:`sift` is ``cv2.SIFT_create(nfeatures).detectAndCompute(img, None)``
and :func:`orb` is ``cv2.ORB_create(nfeatures).detectAndCompute(img,
None)`` on an 8-bit grey image, with OpenCV's other defaults.  Both return
the keypoints as :class:`Keypoints` in OpenCV's order, and the descriptors:
float32 [N, 128] (integers in [0, 255]) for SIFT, uint8 [N, 32] for ORB.
ORB gives OpenCV's bytes on every path of OpenCV.  SIFT gives the bytes of
OpenCV's portable path (``cv2.setUseOptimized(False)``); OpenCV's
dispatched AVX2/AVX-512 code and IPP round differently (FMA), so against
OpenCV's default path SIFT differs as OpenCV's two paths differ from each
other.

The library is built with the system ``g++`` at first use
(``ssp_torch.kernels._build``); its calls go through ``ctypes``, which
releases the GIL.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np


def _lib() -> ctypes.CDLL:
    from ssp_torch.kernels import _build

    lib = _build.load("features_host")
    if not getattr(lib, "_ssp_typed", False):
        ptr, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for fn in (lib.ssp_sift, lib.ssp_orb):
            fn.restype, fn.argtypes = ptr, [ptr, i, i, i]
        lib.ssp_features_count.restype, lib.ssp_features_count.argtypes = i64, [ptr]
        lib.ssp_features_copy.restype, lib.ssp_features_copy.argtypes = None, [ptr] * 4
        lib.ssp_features_free.restype, lib.ssp_features_free.argtypes = None, [ptr]
        lib._ssp_typed = True
    return lib


class Keypoints(NamedTuple):
    """OpenCV's ``KeyPoint`` fields, one row per keypoint."""

    pt: np.ndarray        # [N, 2] float32 (x, y)
    size: np.ndarray      # [N] float32
    angle: np.ndarray     # [N] float32, degrees
    response: np.ndarray  # [N] float32
    octave: np.ndarray    # [N] int32, OpenCV's packed octave


def _gray(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected a uint8 [H, W] image, got {img.dtype} {img.shape}")
    return img


def _detect(fn, img: np.ndarray, nfeatures: int, desc_dtype, desc_dim: int
            ) -> Tuple[Keypoints, np.ndarray]:
    img = _gray(img)
    if nfeatures < 0:
        raise ValueError(f"nfeatures must be >= 0, got {nfeatures}")
    lib = _lib()
    handle = fn(img.ctypes.data, img.shape[0], img.shape[1], int(nfeatures))
    if handle is None:  # where OpenCV raises: SIFT on an empty image, ORB on a side of 1
        raise ValueError(f"OpenCV refuses a {img.shape} image here")
    try:
        n = lib.ssp_features_count(handle)
        kp = np.zeros((n, 5), np.float32)
        octave = np.zeros(n, np.int32)
        desc = np.zeros((n, desc_dim), desc_dtype)
        if n:
            lib.ssp_features_copy(handle, kp.ctypes.data, octave.ctypes.data, desc.ctypes.data)
    finally:
        lib.ssp_features_free(handle)
    return Keypoints(kp[:, :2].copy(), kp[:, 2].copy(), kp[:, 3].copy(), kp[:, 4].copy(),
                     octave), desc


def sift(img: np.ndarray, nfeatures: int = 0) -> Tuple[Keypoints, np.ndarray]:
    """``cv2.SIFT_create(nfeatures).detectAndCompute(img, None)``: keypoints
    and float32 [N, 128] descriptors (``nfeatures`` 0 keeps all)."""
    return _detect(_lib().ssp_sift, img, nfeatures, np.float32, 128)


def orb(img: np.ndarray, nfeatures: int = 500) -> Tuple[Keypoints, np.ndarray]:
    """``cv2.ORB_create(nfeatures).detectAndCompute(img, None)``: keypoints
    and uint8 [N, 32] descriptors."""
    return _detect(_lib().ssp_orb, img, nfeatures, np.uint8, 32)
