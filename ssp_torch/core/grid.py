"""Cell-grid ops: space↔depth, 65-channel labels, heatmap flattening.

Port of ``ssp/core/grid.py``: NHWC tensors, the same channel order
``c·b² + dy·b + dx`` (PyTorch's ``pixel_unshuffle`` order) and the same
64-channel no-dustbin pass-through.  Pure reshape/permute + softmax.
"""

from __future__ import annotations

import torch

CELL = 8  # SuperPoint cell size (8×8 pixels per detector cell)


def space_to_depth(x: torch.Tensor, block: int = CELL) -> torch.Tensor:
    """[B, H, W, C] → [B, H/b, W/b, C·b²], channel ``c·b² + dy·b + dx``."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // block, block, W // block, block, C)
    x = x.permute(0, 1, 3, 5, 2, 4)  # → [B, H/b, W/b, C, dy, dx]
    return x.reshape(B, H // block, W // block, C * block * block)


def depth_to_space(x: torch.Tensor, block: int = CELL) -> torch.Tensor:
    """[B, Hc, Wc, C·b²] → [B, Hc·b, Wc·b, C] (inverse of space_to_depth)."""
    B, Hc, Wc, Cb = x.shape
    C = Cb // (block * block)
    x = x.reshape(B, Hc, Wc, C, block, block)
    x = x.permute(0, 1, 4, 2, 5, 3)  # → [B, Hc, dy, Wc, dx, C]
    return x.reshape(B, Hc * block, Wc * block, C)


def labels_to_cells(
    labels_2d: torch.Tensor, block: int = CELL, add_dustbin: bool = True
) -> torch.Tensor:
    """Binary keypoint map [B, H, W, 1] → cell labels [B, Hc, Wc, 64(+1)].

    With the dustbin: cells holding no keypoint get dustbin=1, and each
    cell's distribution is normalised to sum to one.
    """
    cells = space_to_depth(labels_2d, block)
    if add_dustbin:
        n = cells.sum(dim=-1, keepdim=True)
        dustbin = (n < 1.0).to(cells.dtype)
        cells = torch.cat([cells, dustbin], dim=-1)
        cells = cells / cells.sum(dim=-1, keepdim=True)
    return cells


def flatten_detection(semi: torch.Tensor) -> torch.Tensor:
    """Detector logits [B, Hc, Wc, 65] → full-res heatmap [B, H, W, 1].

    softmax over the 65 channels, drop the dustbin, depth-to-space.  A
    64-channel no-dustbin head passes through depth-to-space raw.
    """
    if semi.shape[-1] == CELL * CELL:
        return depth_to_space(semi, CELL)
    dense = torch.softmax(semi, dim=-1)
    return depth_to_space(dense[..., :-1], CELL)
