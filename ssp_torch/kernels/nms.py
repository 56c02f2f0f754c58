"""Fused iterated-NMS with border zeroing, [B, H, W] fp32.

Replaces the TPU kernel ``ssp/kernels/nms_pallas.py::nms_pallas`` with the
CUDA kernel ``ssp_torch/csrc/nms.cu``.  It computes exactly
``ssp_torch.postprocess.nms.simple_nms`` followed by ``zero_border``
(:func:`nms_plain`, which :func:`nms` runs for a CPU tensor).

What bounds it on an H100: memory.  The function reads the heatmap once
and writes it once (2 × 19.7 MB at 480×640×16, ~12 µs at 3.35 TB/s); its
arithmetic is max/compare.  The plain version's five window-max passes
each round-trip the heatmap through device memory; the kernel runs the
whole chain on a shared-memory tile whose halo is the chain's receptive
field, ``radius·(2·iterations − 1)`` pixels, with the masks as bit words
and no window-max plane, while the next tile's scores arrive (its header
comment has the layout).  :func:`geometry` chooses the tile and the
shared memory it takes; the kernel checks them against its layout.  The
TPU kernel's whole-image/row-tile split and its row and lane padding
answered VMEM and lane limits and are not carried over.

``launches`` counts the kernel launches of :func:`nms`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ssp_torch.kernels import _build

SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may use on Hopper
RADIUS_MAX = 8           # csrc/nms.cu is instantiated for radius 0..8
# core tiles, rows × columns, in order of preference: the first whose tile
# fits SMEM_LIMIT is taken (64 × 128 at radius 4, 3 iterations)
CORES = ((64, 128), (32, 128), (32, 64), (16, 64), (16, 32), (8, 32))
_SLACK = 32  # floats before and after each plane (csrc/nms.cu)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


class Geometry(NamedTuple):
    """A launch of csrc/nms.cu: a core of ``core_h × core_w`` cells, loaded
    with ``halo`` rows and ``halo_w`` columns on each side (``halo`` rounded
    up to 4, for 16-byte copies) into a ``tile_h × tile_w`` tile of row
    pitch ``pitch`` floats (an odd number of 16-byte units: conflict-free
    float4 rows) and ``words`` 32-bit mask words per row; ``smem`` bytes."""

    core_h: int
    core_w: int
    halo: int
    halo_w: int
    tile_h: int
    tile_w: int
    pitch: int
    words: int
    smem: int


@functools.lru_cache(maxsize=None)
def geometry(radius: int, iterations: int, core=None) -> Geometry:
    """The tile of a launch: ``core`` (rows, columns), or the first of
    :data:`CORES` that fits.  Shared memory: the scores double-buffered, a
    row-pass plane (fp32, each with slack for the edge runs), and two bit
    planes.  Raises ``ValueError`` for a radius the kernel does not take or
    a chain whose tile does not fit."""
    if not 0 <= radius <= RADIUS_MAX or iterations < 1:
        raise ValueError(f"the NMS kernel takes radius 0..{RADIUS_MAX} and iterations >= 1, "
                         f"got {radius}, {iterations}")
    halo = radius * (2 * iterations - 1)
    halo_w = -(-halo // 4) * 4
    for core_h, core_w in ((core,) if core is not None else CORES):
        tile_h, tile_w = core_h + 2 * halo, core_w + 2 * halo_w
        pitch, words = tile_w + 4, -(-tile_w // 32)
        smem = 4 * (3 * (tile_h * pitch + 2 * _SLACK) + 2 * tile_h * words)
        g = Geometry(core_h, core_w, halo, halo_w, tile_h, tile_w, pitch, words, smem)
        if smem <= SMEM_LIMIT:
            return g
    raise ValueError(f"radius {radius} × {iterations} iterations needs {g.smem} B of shared "
                     f"memory at a {g.core_h}×{g.core_w} core, more than a block has")


def nms_plain(scores: torch.Tensor, radius: int = 4, iterations: int = 3,
              border: int = 0) -> torch.Tensor:
    """The same function through PyTorch's max-pool chain."""
    from ssp_torch.postprocess.nms import simple_nms, zero_border

    out = simple_nms(scores, radius, iterations)
    return zero_border(out, border) if border else out


def nms(scores: torch.Tensor, radius: int = 4, iterations: int = 3,
        border: int = 0) -> torch.Tensor:
    """scores [B, H, W] (or [H, W]) fp32 → suppressed heatmap, same shape.

    ``border > 0`` also zeroes detections within ``border`` pixels of the
    image edge.  CPU tensors run :func:`nms_plain`; CUDA tensors launch
    the kernel.
    """
    global launches
    if scores.dim() not in (2, 3) or scores.dtype != torch.float32:
        raise ValueError(f"scores must be float32 [B, H, W] or [H, W], got "
                         f"{scores.dtype} {tuple(scores.shape)}")
    if radius < 0 or iterations < 1 or border < 0:
        raise ValueError(f"bad radius/iterations/border: {radius}, {iterations}, {border}")
    if scores.device.type == "cpu":
        return nms_plain(scores, radius, iterations, border)
    if scores.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {scores.device}")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    g = geometry(radius, iterations)
    x = scores if scores.dim() == 3 else scores[None]
    out = torch.empty_like(x)
    if x.numel():
        launch(x, out, radius, iterations, border, g)
        launches += 1
    return out if scores.dim() == 3 else out[0]


def launch(x: torch.Tensor, out: torch.Tensor, radius: int, iterations: int, border: int,
           g: Geometry) -> None:
    """One launch of the kernel with the tile ``g`` on contiguous CUDA fp32
    ``x`` and ``out`` [B, H, W]; counts nothing (:func:`nms` does)."""
    B, H, W = x.shape
    vec = W % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = _build.load("nms").ssp_nms_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(x.data_ptr(), out.data_ptr(), B, H, W, radius, iterations, border,
             g.core_h, g.core_w, g.pitch, g.smem, int(vec),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssp_nms_launch")
