"""Shared host-side dataset machinery (port of ``ssp/data/base.py``).

The host decodes, resizes and pads; everything else runs on the device.
``read_gray`` decodes JPEG, PNG and binary netpbm without OpenCV
(:func:`ssp_torch.data.imageio.decode_gray`) and reproduces what the JAX
package gets from OpenCV: ``cv2.imread(..., IMREAD_GRAYSCALE)``, then
``cv2.resize(..., INTER_AREA)`` to uint8 (:func:`resize_area`), then /255.
This module also holds the netpbm reader (:func:`read_pnm`) and OpenCV's
``cvtColor`` luma (:func:`rgb_to_gray`), which is what OpenCV applies to
color netpbm files (PNG goes through libpng's own weights instead).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

_PNM_CHANNELS = {b"P5": 1, b"P6": 3}


def read_pnm_header(path) -> Tuple[int, int, int, int]:
    """(height, width, channels, raster offset) of a binary netpbm file
    (P5 or P6, maxval 255), from its header alone."""
    with open(path, "rb") as f:
        head = f.read(4096)
        while True:
            parsed = _parse_pnm_header(head, path)
            if parsed is not None:
                return parsed
            more = f.read(len(head))
            if not more:
                raise ValueError(f"{path}: truncated netpbm header")
            head += more


def _parse_pnm_header(head: bytes, path):
    """Parse magic, width, height and maxval; None if ``head`` ends first."""
    magic = head[:2]
    if magic not in _PNM_CHANNELS:
        raise ValueError(f"{path}: not a binary netpbm (P5/P6) file")
    values, pos = [], 2
    while len(values) < 3:
        while pos < len(head) and head[pos:pos + 1].isspace():
            pos += 1
        if pos >= len(head):
            return None
        if head[pos:pos + 1] == b"#":  # a comment runs to the end of its line
            end = head.find(b"\n", pos)
            if end < 0:
                return None
            pos = end + 1
            continue
        start = pos
        while pos < len(head) and head[pos:pos + 1].isdigit():
            pos += 1
        if pos >= len(head):
            return None
        if pos == start:
            raise ValueError(f"{path}: malformed netpbm header")
        values.append(int(head[start:pos]))
    if not head[pos:pos + 1].isspace():
        raise ValueError(f"{path}: malformed netpbm header")
    width, height, maxval = values
    if maxval != 255:
        raise ValueError(f"{path}: netpbm maxval {maxval}; only 8-bit (255) files are read")
    return height, width, _PNM_CHANNELS[magic], pos + 1


def read_pnm(path) -> np.ndarray:
    """Binary netpbm → uint8 [H, W] (P5) or [H, W, 3] RGB (P6)."""
    height, width, channels, offset = read_pnm_header(path)
    with open(path, "rb") as f:
        f.seek(offset)
        raw = np.frombuffer(f.read(height * width * channels), np.uint8)
    if raw.size != height * width * channels:
        raise ValueError(f"{path}: truncated netpbm raster")
    return raw.reshape(height, width, channels)[..., 0] if channels == 1 else \
        raw.reshape(height, width, 3)


def write_pnm(path, img: np.ndarray) -> None:
    """uint8 [H, W] → binary P5, [H, W, 3] RGB → binary P6."""
    img = np.ascontiguousarray(img, np.uint8)
    magic = {2: b"P5", 3: b"P6"}[img.ndim]
    with open(path, "wb") as f:
        f.write(b"%s\n%d %d\n255\n" % (magic, img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] RGB → uint8 [H, W] with OpenCV's codec weights: the
    0.299/0.587/0.114 luma in 14-bit fixed point, rounded half up."""
    cr, cg = int(0.299 * (1 << 14) + 0.5), int(0.587 * (1 << 14) + 0.5)
    cb = (1 << 14) - cr - cg
    rgb = rgb.astype(np.int32)
    t = rgb[..., 0] * cr + rgb[..., 1] * cg + rgb[..., 2] * cb
    return ((t + (1 << 13)) >> 14).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _area_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """The area weights along one axis, as OpenCV tabulates them for a
    downscale: per output index its source indices and fp32 weights in
    summation order, [dst, taps] (padded with weight 0).  Cached per size
    pair (read only: a corpus has few sizes)."""
    scale = 1.0 / (dst / src)
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(f2 - s2, 1.0, cell) / cell))
        rows.append(row)
    n = max(len(r) for r in rows)
    idx = np.zeros((dst, n), np.int64)
    w = np.zeros((dst, n), np.float32)
    for d, row in enumerate(rows):
        for t, (s, a) in enumerate(row):
            idx[d, t], w[d, t] = s, a
    return idx, w


@functools.lru_cache(maxsize=64)
def _linear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's two-tap weights for INTER_AREA where it enlarges: source
    index and the 11-bit fixed-point weight pair per output index.  Cached
    per size pair (read only)."""
    inv = dst / src
    scale = 1.0 / inv
    idx = np.zeros(dst, np.int64)
    w = np.zeros((dst, 2), np.int64)
    for d in range(dst):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else f - np.float32(math.floor(f))
        idx[d] = s
        w[d] = np.rint(np.array([np.float32(1.0) - f, f], np.float32) * np.float32(2048))
    return idx, w


def resize_area(img: np.ndarray, hw: Sequence[int]) -> np.ndarray:
    """uint8 [H, W] → uint8 (h, w), as ``cv2.resize(img, (w, h),
    interpolation=cv2.INTER_AREA)`` computes it:

    * the same size: a copy;
    * integer factors on both axes: block means (2×2: (sum + 2) >> 2;
      otherwise sum·(1/area) in fp32, rounded half to even);
    * a downscale on both axes: box integration with fractional edge
      weights, summed in fp32 in OpenCV's order (rows, then columns);
    * otherwise: OpenCV's area-mode bilinear in 11-bit fixed point.
    """
    sh, sw = img.shape
    dh, dw = int(hw[0]), int(hw[1])
    if (dh, dw) == (sh, sw):
        return img.copy()
    scale_x, scale_y = 1.0 / (dw / sw), 1.0 / (dh / sh)
    ix, iy = round(scale_x), round(scale_y)
    if scale_x >= 1 and scale_y >= 1:
        if abs(scale_x - ix) < np.finfo(np.float64).eps and \
                abs(scale_y - iy) < np.finfo(np.float64).eps:
            s = img.astype(np.int32).reshape(dh, iy, dw, ix).sum(axis=(1, 3))
            if (ix, iy) == (2, 2):
                return ((s + 2) >> 2).astype(np.uint8)
            out = s.astype(np.float32) * np.float32(1.0 / (ix * iy))
            return np.clip(np.rint(out), 0, 255).astype(np.uint8)
        xi, xw = _area_taps(sw, dw)
        yi, yw = _area_taps(sh, dh)
        src = img.astype(np.float32)
        rows = np.zeros((sh, dw), np.float32)
        for t in range(xi.shape[1]):
            rows += src[:, xi[:, t]] * xw[:, t]
        out = np.zeros((dh, dw), np.float32)
        for t in range(yi.shape[1]):
            out += yw[:, t, None] * rows[yi[:, t]]
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    xi, xw = _linear_taps(sw, dw)
    yi, yw = _linear_taps(sh, dh)
    x1 = np.minimum(xi + 1, sw - 1)
    edge = xi + 1 >= sw  # past the last column: the last pixel, weight 1
    src = img.astype(np.int64)
    rows = src[:, xi] * np.where(edge, 2048, xw[:, 0]) + src[:, x1] * np.where(edge, 0, xw[:, 1])
    r0 = rows[np.clip(yi, 0, sh - 1)]
    r1 = rows[np.clip(yi + 1, 0, sh - 1)]
    out = (((yw[:, 0, None] * (r0 >> 4)) >> 16) + ((yw[:, 1, None] * (r1 >> 4)) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def read_gray(path, resize: Optional[Sequence[int]] = None) -> np.ndarray:
    """Grayscale float32 ∈ [0, 1] of a JPEG, PNG or binary netpbm file (as
    ``cv2.imread(..., IMREAD_GRAYSCALE)`` decodes it), optionally resized to
    (H, W) with INTER_AREA (the reference's resize mode,
    ``datasets/Coco.py:158``).  A form the decoder does not read raises
    ``ValueError`` (:mod:`ssp_torch.data.imageio`)."""
    from ssp_torch.data.imageio import decode_gray

    img = decode_gray(path)
    if resize is not None:
        img = resize_area(img, resize)
    return img.astype(np.float32) / 255.0


class ImageDataset:
    """Indexable sample source with a uniform ``batches`` iterator.

    Subclasses implement ``__len__`` and ``__getitem__`` returning a dict
    of numpy arrays with at least ``image`` [H, W].
    """

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError

    @staticmethod
    def split_dir(split: str) -> str:
        """Subdirectory predictions/labels for ``split`` live under."""
        return split

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    _BATCH_SKIP = ("name",)  # non-array fields stay off the device path

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                workers: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite iterator of stacked host batches; drops the ragged epoch
        tail so every batch is exactly ``batch_size``, and samples with
        replacement from a corpus smaller than one batch.  ``workers > 0``
        decodes a batch's samples on a thread pool; the batches are the same
        for any worker count."""
        n = len(self)
        if n == 0:
            raise ValueError(f"{type(self).__name__}: empty dataset")
        rng = np.random.default_rng(seed)
        pool = None
        if workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=workers)
        try:
            while True:
                order = rng.permutation(n) if shuffle else np.arange(n)
                if n < batch_size:
                    order = (rng.integers(0, n, batch_size) if shuffle
                             else np.resize(order, batch_size))
                for start in range(0, len(order) - batch_size + 1, batch_size):
                    idxs = [int(i) for i in order[start:start + batch_size]]
                    samples = (list(pool.map(self.__getitem__, idxs)) if pool is not None
                               else [self[i] for i in idxs])
                    keys = [k for k in samples[0] if k not in self._BATCH_SKIP]
                    yield {k: np.stack([s[k] for s in samples]) for k in keys}
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def images(self) -> Iterator[Tuple[str, np.ndarray]]:
        """(name, image) stream for export pipelines."""
        for i in range(len(self)):
            s = self[i]
            yield s.get("name", str(i)), s["image"]
