"""Seed-made gray frames: overlapping rectangles of random gray levels on a
dark noisy background, so the detector fires on corners and keypoint
comparisons are not made among near-ties of a noise image.

The same construction as the port's ``bench.py::structured_images``
(one rectangle per 4096 pixels, at least 4; sides from 8 px to a third of
the frame; levels in [0.2, 1); background in [0, 0.1)), drawn in a few
vectorised calls on the device from a ``torch.Generator`` seeded by the run's
seed instead of a host loop.
"""

from __future__ import annotations

import torch


def structured_frames(n: int, h: int, w: int, generator: torch.Generator) -> torch.Tensor:
    """[n, h, w] float32 in [0, 1) on the generator's device."""
    dev = generator.device
    out = torch.rand((n, h, w), generator=generator, device=dev) * 0.1
    m = max(4, h * w // 4096)
    u = torch.rand((5, n, m), generator=generator, device=dev, dtype=torch.float64)
    y0 = (u[0] * (h - 8)).long()
    x0 = (u[1] * (w - 8)).long()
    y1 = y0 + 8 + (u[2] * (torch.clamp(h - y0, max=h // 3) - 8 + 1).clamp_min(1)).long()
    x1 = x0 + 8 + (u[3] * (torch.clamp(w - x0, max=w // 3) - 8 + 1).clamp_min(1)).long()
    level = (0.2 + 0.8 * u[4]).float()
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    for r in range(m):  # later rectangles cover earlier ones
        inside = ((ys >= y0[:, r, None, None]) & (ys < y1[:, r, None, None])
                  & (xs >= x0[:, r, None, None]) & (xs < x1[:, r, None, None]))
        out = torch.where(inside, level[:, r, None, None], out)
    return out
