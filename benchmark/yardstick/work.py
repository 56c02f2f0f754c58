"""Operations and bytes of the cell's work, counted from the shapes: the
model's FLOPs per image (2 × the multiply-adds of every conv) and each hand
kernel's least time per launch on one H100.

A least time is the larger of the operations at the published peak for the
kernel's arithmetic and the bytes at the memory bandwidth; each input byte is
counted read once and each output byte written once (the arithmetic of the
port's ``chip_smoke.py::conv_nms_bounds``, copied).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense rates: bf16 tensor cores, fp32 outside
# the tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def least_s(ops: float, ops_peak: float, nbytes: float) -> float:
    return max(ops / ops_peak, nbytes / PEAK_BYTES)


def conv_layers(widths: Dict[str, int], semantic_classes: int = 0
                ) -> List[Tuple[int, int, int, int]]:
    """(cin, cout, kernel size, pixel divisor) of every conv of the gauss2
    network, in order."""
    c1, c2, c3, c4, c5, d1 = (widths[k] for k in ("c1", "c2", "c3", "c4", "c5", "d1"))
    det = widths["det"]
    layers = [(1, c1, 3, 1), (c1, c1, 3, 1), (c1, c2, 3, 4), (c2, c2, 3, 4),
              (c2, c3, 3, 16), (c3, c3, 3, 16), (c3, c4, 3, 64), (c4, c4, 3, 64),
              (c4, c5, 3, 64), (c5, det, 1, 64), (c4, c5, 3, 64), (c5, d1, 1, 64)]
    if semantic_classes:
        layers += [(c4, c5, 3, 64), (c5, semantic_classes, 1, 64)]
    return layers


def forward_flops(widths: Dict[str, int], h: int, w: int, semantic_classes: int = 0) -> float:
    """FLOPs of one image's forward at h × w."""
    return float(sum(2 * k * k * cin * cout * (h * w // div)
                     for cin, cout, k, div in conv_layers(widths, semantic_classes)))


def stem_least_s(b: int, h: int, w: int, c1: int) -> float:
    """The stem kernel (conv 1→c1, conv c1→c1, 2×2 max) on [b, h, w] fp32."""
    px = b * h * w
    out_bytes = px // 4 * c1 * 2
    w_bytes = 9 * c1 * (1 + c1) * 2 + 4 * c1 * 4
    return least_s(2.0 * px * c1 * 9 * (1 + c1), PEAK_BF16, px * 4 + out_bytes + w_bytes)


def down1_least_s(b: int, h: int, w: int, c: int) -> float:
    """The down1 kernel (two c→c convs at h/2 × w/2, then 2×2 max) on the
    stem's bf16 output."""
    px2 = b * (h // 2) * (w // 2)
    in_bytes = px2 * c * 2
    return least_s(2.0 * px2 * c * 9 * c * 2, PEAK_BF16,
                   in_bytes * 5 // 4 + 2 * 9 * c * c * 2 + 4 * c * 4)


def nms_least_s(b: int, h: int, w: int, radius: int) -> float:
    """The NMS kernel (3 iterations) on [b, h, w] fp32: per pixel 5 separable
    window maxes of 4r operations and ~10 compares, fp32."""
    n = b * h * w
    return least_s(n * (5 * 4 * radius + 10.0), PEAK_FP32, 2 * n * 4)

