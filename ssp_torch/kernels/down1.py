"""SuperPoint down1: two conv3×3 64→64 + folded BN + ReLU (→ 2×2 max), NHWC,
SAME padding.

Replaces the TPU kernel ``ssp/kernels/down1_pallas.py::down1_pallas_packed``
with the CUDA kernel ``ssp_torch/csrc/down1.cu``: one "conv3×3 64→64 →
scale·x + bias → ReLU (→ 2×2 max)" kernel, launched twice per call, the
first time into a bf16 intermediate that the wrapper allocates.

What bounds it on an H100: tensor-core operations, ~0.18 TFLOP of bf16
work at 16×240×320 (~0.18 ms at 989 TFLOP/s) against ~0.2 GB of HBM
traffic for the function (~0.06 ms) and 2 × 157 MB more for the
intermediate's round trip (~0.09 ms, hidden under the products).  Both
weight images with one warpgroup's input and intermediate tiles do not
fit one block's shared memory; one conv's weights leave room for three
warpgroups, each with a tile of its own, whose phases overlap.  Each
launch is the stem's second conv (persistent blocks holding the swizzled
weight image, ``wgmma`` products with A from ``ldmatrix``, the pool
fused) with a ``cp.async`` load of the input tile in place of the stem's
first conv.
The TPU kernel was gated to B ≤ 4 by measurements on a v5e; this one runs
at every batch size.

Numerics are the TPU kernel's: the intermediate is rounded to bf16 where
the TPU kernel rounds the second conv's input, and is 0 outside the image
(the second launch's zero halo), not ReLU(bias).  :func:`down1_plain`
computes the same function in PyTorch and is what :func:`down1` runs for a
CPU tensor.  ``launches`` counts the calls of :func:`down1` and
:func:`down1_prepared` that reach the card; each is two CUDA launches.
"""

from __future__ import annotations

import torch

from ssp_torch.kernels.stem import (C, PreparedPair, check_x, conv_pair_plain, launch_pair,
                                    prepare_pair, swizzle_w2)

launches = 0


def down1_plain(x: torch.Tensor, wa, sa, ba, wb, sb, bb, pool: bool = True) -> torch.Tensor:
    """down1 in plain PyTorch: x [B, H2, W2, 64] bf16 → bf16
    ``[B, H2/2, W2/2, 64]`` (pool) or ``[B, H2, W2, 64]``."""
    return conv_pair_plain(x, wa, sa, ba, wb, sb, bb, pool)


def prepare_down1(wa: torch.Tensor, scale_a: torch.Tensor, bias_a: torch.Tensor,
                  wb: torch.Tensor, scale_b: torch.Tensor, bias_b: torch.Tensor) -> PreparedPair:
    """down1's weights (as :func:`down1` takes them) → what
    :func:`down1_prepared` launches with: both convs' weights as the
    swizzled images of :func:`ssp_torch.kernels.stem.swizzle_w2`; done once
    per model."""
    return prepare_pair(C, (wa, scale_a, bias_a, wb, scale_b, bias_b), swizzle_w2, swizzle_w2)


def down1_prepared(x: torch.Tensor, prep: PreparedPair, pool: bool = True) -> torch.Tensor:
    """:func:`down1` with weights from :func:`prepare_down1`."""
    global launches
    check_x(x, C, torch.bfloat16, pool, prep)
    if x.device.type == "cpu":
        return down1_plain(x, *prep.params, pool=pool)
    out = launch_pair("down1", "ssp_down1_launch", x, prep, pool, mid=True)
    launches += 1
    return out


def down1(x: torch.Tensor, wa: torch.Tensor, scale_a: torch.Tensor, bias_a: torch.Tensor,
          wb: torch.Tensor, scale_b: torch.Tensor, bias_b: torch.Tensor,
          pool: bool = True) -> torch.Tensor:
    """x [B, H2, W2, 64] bf16 (the pooled stem output) → down1 output.

    wa/wb [3, 3, 64, 64] bf16 HWIO; scale/bias fp32 [64] folded inference
    BN.  Any H2 and W2 (even for ``pool``); ``x`` contiguous with a 16-byte
    aligned start.  CPU tensors run :func:`down1_plain`; CUDA tensors launch
    the kernel.
    """
    return down1_prepared(x, prepare_down1(wa, scale_a, bias_a, wb, scale_b, bias_b), pool)
