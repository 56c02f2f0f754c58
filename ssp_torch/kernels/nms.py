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
field, ``radius·(2·iterations − 1)`` pixels, runs each window max only
where the next one reads it (a region that shrinks by ``radius`` per
pass), and writes only the tile's core.  The TPU kernel's whole-image/row-tile split and its row and lane
padding answered VMEM and lane limits and are not carried over.

``launches`` counts the kernel launches of :func:`nms`.
"""

from __future__ import annotations

import ctypes

import torch

from ssp_torch.kernels import _build

CORE_H, MIN_CORE_W = 32, 32  # csrc/nms.cu's core tile: 32 rows, 128, 64 or 32 columns
SMEM_LIMIT = 227 * 1024       # dynamic shared memory one block may use on Hopper
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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
    halo = radius * (2 * iterations - 1)
    smem = (CORE_H + 2 * halo) * (MIN_CORE_W + 2 * halo) * 18
    if smem > SMEM_LIMIT:
        raise ValueError(f"radius {radius} × {iterations} iterations needs {smem} B of "
                         f"shared memory, more than a block has")
    x = scores if scores.dim() == 3 else scores[None]
    B, H, W = x.shape
    out = torch.empty_like(x)
    fn = _build.load("nms").ssp_nms_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(x.data_ptr(), out.data_ptr(), B, H, W, radius, iterations, border,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssp_nms_launch")
    launches += 1
    return out if scores.dim() == 3 else out[0]
