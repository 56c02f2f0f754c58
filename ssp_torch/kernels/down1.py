"""Fused SuperPoint down1: two conv3×3 64→64 + folded BN + ReLU (→ 2×2
max), NHWC, SAME padding.

Replaces the TPU kernel ``ssp/kernels/down1_pallas.py::down1_pallas_packed``
with the CUDA kernel ``ssp_torch/csrc/conv_pair.cu``: the stem's function
with a 64-channel first conv, which is an implicit GEMM like the second.

What bounds it on an H100: tensor-core operations, ~0.18 TFLOP of bf16
work at 480×640×16 (~0.18 ms at 989 TFLOP/s) against ~0.2 GB of HBM
traffic (~0.06 ms).  Both convs run on ``mma.sync`` bf16 tensor cores; the
intermediate (with its 1-pixel halo, zeroed outside the image) stays in
shared memory as bf16, and the pool is fused.  The TPU kernel was gated
to B ≤ 4 by measurements on a v5e; this one runs at every batch size.

:func:`down1_plain` computes the same function in PyTorch and is what
:func:`down1` runs for a CPU tensor.  ``launches`` counts the kernel
launches of :func:`down1` and :func:`down1_prepared`.
"""

from __future__ import annotations

import torch

from ssp_torch.kernels.stem import (C, PreparedPair, check_x, conv_pair_plain, kernel_layout,
                                    launch_pair, prepare_pair)

launches = 0


def down1_plain(x: torch.Tensor, wa, sa, ba, wb, sb, bb, pool: bool = True) -> torch.Tensor:
    """down1 in plain PyTorch: x [B, H2, W2, 64] bf16 → bf16
    ``[B, H2/2, W2/2, 64]`` (pool) or ``[B, H2, W2, 64]``."""
    return conv_pair_plain(x, wa, sa, ba, wb, sb, bb, pool)


def prepare_down1(wa: torch.Tensor, scale_a: torch.Tensor, bias_a: torch.Tensor,
                  wb: torch.Tensor, scale_b: torch.Tensor, bias_b: torch.Tensor) -> PreparedPair:
    """down1's weights (as :func:`down1` takes them) → what
    :func:`down1_prepared` launches with; done once per model."""
    return prepare_pair(C, (wa, scale_a, bias_a, wb, scale_b, bias_b), kernel_layout,
                        kernel_layout)


def down1_prepared(x: torch.Tensor, prep: PreparedPair, pool: bool = True) -> torch.Tensor:
    """:func:`down1` with weights from :func:`prepare_down1`."""
    global launches
    check_x(x, C, torch.bfloat16, pool, prep)
    if x.device.type == "cpu":
        return down1_plain(x, *prep.params, pool=pool)
    out = launch_pair("conv_pair", "ssp_down1_launch", x, prep, pool)
    launches += 1
    return out


def down1(x: torch.Tensor, wa: torch.Tensor, scale_a: torch.Tensor, bias_a: torch.Tensor,
          wb: torch.Tensor, scale_b: torch.Tensor, bias_b: torch.Tensor,
          pool: bool = True) -> torch.Tensor:
    """x [B, H2, W2, 64] bf16 (the pooled stem output) → down1 output.

    wa/wb [3, 3, 64, 64] bf16 HWIO; scale/bias fp32 [64] folded inference
    BN.  Any H2 and W2 (even for ``pool``).  CPU tensors run
    :func:`down1_plain`; CUDA tensors launch the kernel.
    """
    return down1_prepared(x, prepare_down1(wa, scale_a, bias_a, wb, scale_b, bias_b), pool)
