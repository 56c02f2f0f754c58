"""Ordered scatter-add, and the gather whose backward it is.

:func:`ordered_scatter` computes ``out[r, t, :] = Σ_{k : idx[r, k] = t}
src[r, k, :]`` with every sum taken from +0 in increasing ``k``: the result
of a serial ``scatter_add_`` into zeros, bit for bit, on the card as on the
CPU, and the same from run to run.  CUDA's own backward of ``torch.gather``
and of advanced indexing adds with atomics in an order that changes between
runs, so a training step whose loss gathers (the sparse descriptor loss)
gave other gradients from the same state each time it ran.

:func:`gather_rows` is ``src[r, idx[r, k], :]`` with that backward: the
forward is ``torch.gather``, the backward :func:`ordered_scatter`.  The
training path's gathers go through it (``ssp_torch/core/warp.py``'s taps,
the sparse descriptor loss's reads).

The CUDA kernel is ``ssp_torch/csrc/ordered_scatter.cu``; CPU tensors run
:func:`ordered_scatter_plain`.  It replaces no TPU kernel (the JAX package
gathers with one-hot products or XLA scatters, deterministic on a TPU).
What bounds it on the card is bytes: ``src`` and ``idx`` read once, ``out``
written once.  A call is two launches: a counting sort of each row's hits
by ``t``, made stable, into a CSR of int32 scratch (offsets ``[R, T+1]``
and the order of ``k`` ``[R, K]``, allocated here), then a warp per 4
output rows that reads their segments' ``src`` rows with 16-byte loads, 8
rows in flight, and adds them in order from +0 in registers.  No host sync
and no float atomics, so a CUDA graph captures the call.  ``launches``
counts the calls that reach the card (one per call).
"""

from __future__ import annotations

import ctypes

import torch

from ssp_torch.kernels import _build

launches = 0
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.float64: 1}


def _check(src: torch.Tensor, idx: torch.Tensor, T: int) -> None:
    if src.dim() != 3 or idx.dim() != 2 or tuple(idx.shape) != tuple(src.shape[:2]):
        raise ValueError(f"src must be [R, K, C] and idx [R, K], got {tuple(src.shape)} and "
                         f"{tuple(idx.shape)}")
    if src.dtype not in _DTYPES or idx.dtype != torch.int64:
        raise ValueError(f"src must be float32 or float64 and idx int64, got {src.dtype} and "
                         f"{idx.dtype}")
    if src.device != idx.device:
        raise ValueError(f"src on {src.device}, idx on {idx.device}")
    if T <= 0:
        raise ValueError(f"T must be positive, got {T}")


def ordered_scatter_plain(src: torch.Tensor, idx: torch.Tensor, T: int) -> torch.Tensor:
    """The same sums in PyTorch: a ``scatter_add_`` into zeros, serial in
    ``k`` on the CPU (on the card its order is not fixed)."""
    _check(src, idx, T)
    R, K, C = src.shape
    out = torch.zeros((R, T, C), dtype=src.dtype, device=src.device)
    return out.scatter_add_(1, idx[..., None].expand(R, K, C), src)


def ordered_scatter(src: torch.Tensor, idx: torch.Tensor, T: int) -> torch.Tensor:
    """``src [R, K, C]`` (float32 or float64) summed into ``[R, T, C]`` at
    ``idx [R, K]`` (int64 in ``[0, T)``) in increasing ``k``.  CPU tensors run
    :func:`ordered_scatter_plain`; CUDA tensors launch the kernel, which
    raises if it cannot build or launch."""
    global launches
    _check(src, idx, T)
    if src.device.type == "cpu":
        return ordered_scatter_plain(src, idx, T)
    if src.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {src.device}")
    R, K, C = src.shape
    out = torch.empty((R, T, C), dtype=src.dtype, device=src.device)
    if R == 0 or C == 0:
        return out
    if K == 0:
        return out.zero_()
    launch(src.contiguous(), idx.contiguous(), out)
    launches += 1
    return out


def launch(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel's two launches on contiguous CUDA ``src [R, K, C]``,
    ``idx [R, K]`` into ``out [R, T, C]``, with the CSR scratch allocated
    here; counts nothing (:func:`ordered_scatter` does)."""
    lib = _build.load("ordered_scatter")
    fn, size = lib.ssp_ordered_scatter_launch, lib.ssp_ordered_scatter_scratch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        size.argtypes, size.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    R, K, C = src.shape
    T = out.shape[1]
    csr = torch.empty(size(R, K, T), dtype=torch.int32, device=src.device)
    err = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), csr.data_ptr(), R, K, T, C,
             _DTYPES[src.dtype], torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "ssp_ordered_scatter_launch")


class _OrderedGather(torch.autograd.Function):
    """``torch.gather`` along dim 1 of ``src [R, T, C]`` with ``idx [R, K]``,
    whose backward is :func:`ordered_scatter`."""

    @staticmethod
    def forward(ctx, src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.T = src.shape[1]
        return torch.gather(src, 1, idx[..., None].expand(*idx.shape, src.shape[2]))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return ordered_scatter(grad.contiguous(), idx, ctx.T), None


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src [R, T, C]``, ``idx [R, K]`` → ``[R, K, C]``, ``out[r, k] =
    src[r, idx[r, k]]``; its gradient sums in increasing ``k``."""
    return _OrderedGather.apply(src, idx.long())
