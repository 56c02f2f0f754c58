"""Semantic segmentation loss: cross-entropy with an ignore class (port of
``ssp/losses/semantic.py``; reference ``sem_loss``, ``nn.CrossEntropyLoss(
ignore_index=133)``: the mean NLL over the pixels that are not ignored).

:func:`semantic_loss_coarse` is the CE of the ×8 bilinear upsample of
1/8-resolution logits without the upsample: every full-resolution pixel of
phase ``p = (y mod 8, x mod 8)`` is a fixed combination of a 3×3
neighbourhood of coarse cells (half-pixel centres, edge clamp, the
``jax.image.resize(..., "linear")`` and ``F.interpolate(mode="bilinear",
align_corners=False)`` convention), so the CE reads ``[B, Hc, Wc, 9, C]``
taps through the ``[64, 9]`` phase matrix.  Value and gradient equal the
upsample-then-CE form.  The class pick is an index (``gather``); the JAX
package's one-hot reduction avoided a TPU gather.

``valid_total`` is the global batch's count of pixels that are not ignored
when the batch is split over ranks (``ssp_torch.train.step``): each rank's
loss is then its additive share of the global batch's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ssp_torch._device import constant


def _picked(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``."""
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def semantic_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_class: int = 133, *,
                  valid_total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: [B, H, W, C]; labels: int [B, H, W] in [0, C] (C = ignore)."""
    valid = (labels != ignore_class).float()
    safe = torch.where(labels == ignore_class, torch.zeros_like(labels), labels)
    nll = torch.logsumexp(logits, dim=-1) - _picked(logits, safe)
    total = valid.sum() if valid_total is None else valid_total
    return (nll * valid).sum() / (total + 1e-9)


def _phase_tables(scale: int):
    """Bilinear ↑scale phase weights: full-res pixel ``p = scale·i + d``
    samples coarse coordinate ``i + (2d + 1 − scale)/(2·scale)``, i.e. cells
    ``i + lo(d)`` and ``i + lo(d) + 1`` (``lo ∈ {−1, 0}``) with weights
    ``(w0, w1)``."""
    d = np.arange(scale)
    f = (2.0 * d + 1.0 - scale) / (2.0 * scale)
    lo = np.where(f < 0, -1, 0)
    t = f - lo
    return lo.astype(np.int32), (1.0 - t).astype(np.float32), t.astype(np.float32)


def _phase_tap_matrix(scale: int) -> np.ndarray:
    """[scale², 9] weights of each phase over the 3×3 coarse neighbourhood
    (offsets −1..+1, flattened row-major)."""
    lo, w0, w1 = _phase_tables(scale)
    P = np.zeros((scale * scale, 9), np.float32)
    for dh in range(scale):
        for dw in range(scale):
            p = dh * scale + dw
            for r, wr in ((lo[dh] + 1, w0[dh]), (lo[dh] + 2, w1[dh])):
                for c, wc in ((lo[dw] + 1, w0[dw]), (lo[dw] + 2, w1[dw])):
                    P[p, r * 3 + c] += wr * wc
    return P


def edge_pad(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` → ``[B, H + 2, W + 2, C]`` with the edge rows and
    columns repeated (``F.pad(mode="replicate")``), by concatenation: the
    gradient sums each edge cell's parts in a fixed order, where the CUDA
    backward of the replicate pad adds them with atomics."""
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def semantic_loss_coarse(coarse: torch.Tensor, labels: torch.Tensor, ignore_class: int = 133, *,
                         valid_total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``semantic_loss(upsample(coarse, 8), labels)`` read from the coarse
    logits ``[B, Hc, Wc, C]``; ``labels`` int ``[B, 8·Hc, 8·Wc]``."""
    B, Hc, Wc, C = coarse.shape
    scale = 8
    P = constant(torch.from_numpy(_phase_tap_matrix(scale)), coarse.device)  # [s², 9]
    P = P.to(coarse.dtype)  # an fp64 forward keeps fp64
    # 3×3 tap neighbourhood through an edge-clamped pad
    cpad = edge_pad(coarse)
    V = torch.stack([cpad[:, r:r + Hc, c:c + Wc, :] for r in range(3) for c in range(3)],
                    dim=3)  # [B, Hc, Wc, 9, C]
    lab = labels.reshape(B, Hc, scale, Wc, scale).permute(0, 1, 3, 2, 4)
    lab = lab.reshape(B, Hc, Wc, scale * scale)
    valid = (lab != ignore_class).float()
    safe = torch.where(lab == ignore_class, torch.zeros_like(lab), lab)
    logits = torch.einsum("bhwkc,pk->bhwpc", V, P)  # [B, Hc, Wc, s², C]
    nll = torch.logsumexp(logits, dim=-1) - _picked(logits, safe)
    total = valid.sum() if valid_total is None else valid_total
    return (nll * valid).sum() / (total + 1e-9)
