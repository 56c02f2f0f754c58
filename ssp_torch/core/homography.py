"""Random-homography sampling and point warping (port of
``ssp/core/homography.py``).

A half-size centred patch of the unit square is perturbed by
truncated-normal perspective displacements, one of several candidate
scalings, a uniform in-bounds translation and one of several candidate
rotations; the homography maps the output unit square onto the perturbed
patch (output → input, the inverse-warp convention).

As in the JAX package there is no rejection loop: every scale and angle
candidate is evaluated and one *valid* candidate is picked uniformly by a
masked argmax, with fixed shapes.  What ``vmap`` did there is a leading
batch dimension here: :func:`sample_homographies` builds all ``n``
homographies in one pass.  Random numbers come from a ``torch.Generator``
and are drawn on the generator's device, so a CPU generator gives the same
homographies whatever device they are used on.  They are not the numbers
``jax.random`` gives for any key: the two samplers agree in distribution.

fp32 throughout; PyTorch's fp32 matmul and elementwise ops do not drop to
a lower precision by default.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ssp_torch._device import to_device


def adjugate3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate of [..., 3, 3] (adj(M) = det(M)·M⁻¹)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    row0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1)
    row1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1)
    row2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 3, 3]."""
    adj = adjugate3(M)
    det = (M[..., 0, 0] * adj[..., 0, 0] + M[..., 0, 1] * adj[..., 1, 0]
           + M[..., 0, 2] * adj[..., 2, 0])
    return adj / det[..., None, None]


def _quad_basis(q: torch.Tensor) -> torch.Tensor:
    """Projective map sending the basis frame e1, e2, e3, (1, 1, 1) onto the
    4 points ``q [..., 4, 2]``: columns λᵢ·[qᵢ, 1] with [λ] = A⁻¹·[q₄, 1]."""
    qh = torch.cat([q, torch.ones_like(q[..., :1])], dim=-1)  # [..., 4, 3]
    A = qh[..., :3, :].transpose(-1, -2)  # columns are q1..q3 homogeneous
    lam = (inv3(A) @ qh[..., 3, :, None])[..., 0]
    return A * lam[..., None, :]


def homography_from_corners(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """The 3×3 H with H @ [pts1, 1]ᵀ ∝ [pts2, 1]ᵀ (4 points, (x, y)), as
    ``cv2.getPerspectiveTransform(pts1, pts2)``, by the projective-basis
    construction; normalised so H[2, 2] = 1.  Leading dimensions batch."""
    H = _quad_basis(pts2) @ inv3(_quad_basis(pts1))
    return H / H[..., 2:3, 2:3]


def warp_points(points: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Warp ``points [..., N, 2]`` (x, y) by homography ``H [..., 3, 3]``."""
    pts_h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    warped = pts_h @ H.transpose(-1, -2)
    return warped[..., :2] / (warped[..., 2:] + 1e-12)


def scale_homography(H: torch.Tensor, shape: Tuple[int, int],
                     shift: Tuple[float, float] = (-1.0, -1.0)) -> torch.Tensor:
    """Conjugate a normalised-coordinate H into pixel coordinates: with ``T``
    mapping pixel (x, y) → normalised ([shift, shift+2]²), returns
    ``T⁻¹ H T``.  ``shape`` is (H, W)."""
    height, width = shape
    T = to_device(torch.tensor([[2.0 / width, 0.0, shift[0]], [0.0, 2.0 / height, shift[1]],
                                [0.0, 0.0, 1.0]], dtype=H.dtype), H.device)
    return inv3(T) @ H @ T


def _pick_valid(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Uniformly pick one index among ``valid [..., m]`` (boolean) with iid
    U(0, 1) draws ``u`` of the same shape: the argmax of ``u`` restricted to
    the valid set is uniform on it."""
    return torch.argmax(torch.where(valid, u, torch.full_like(u, -1.0)), dim=-1)


def _trunc_normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal truncated to ±2σ (``scipy.stats.truncnorm(-2, 2)``),
    by the inverse CDF of a uniform draw."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    p = lo + u * (1.0 - 2.0 * lo)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp(-2.0, 2.0).float()


def sample_homographies(
    n: int,
    *,
    generator: Optional[torch.Generator] = None,
    shift: float = -1.0,
    perspective: bool = True,
    scaling: bool = True,
    rotation: bool = True,
    translation: bool = True,
    n_scales: int = 5,
    n_angles: int = 25,
    scaling_amplitude: float = 0.1,
    perspective_amplitude_x: float = 0.1,
    perspective_amplitude_y: float = 0.1,
    patch_ratio: float = 0.5,
    max_angle: float = math.pi / 2,
    allow_artifacts: bool = False,
    translation_overflow: float = 0.0,
) -> torch.Tensor:
    """[n, 3, 3] random homographies on the unit square (+``shift``), each
    mapping output coords → input coords.  Callers use ``shift=-1`` to get
    homographies acting on ``[-1, 1]²`` normalised image coordinates.

    The result lives on the generator's device (the CPU without one).
    """
    dev = generator.device if generator is not None else torch.device("cpu")

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    # output square corners and centred input patch, (x, y), in [0, 1]²
    pts1 = torch.tensor([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]], device=dev)
    margin = (1.0 - patch_ratio) / 2.0
    pts2 = (margin + patch_ratio * pts1).expand(n, 4, 2)

    if perspective:
        ax = perspective_amplitude_x if allow_artifacts else min(perspective_amplitude_x, margin)
        ay = perspective_amplitude_y if allow_artifacts else min(perspective_amplitude_y, margin)
        t = _trunc_normal((n, 3), generator, dev)
        py, lx, rx = t[:, 0] * ay / 2.0, t[:, 1] * ax / 2.0, t[:, 2] * ax / 2.0
        pts2 = pts2 + torch.stack([
            torch.stack([lx, py], -1), torch.stack([lx, -py], -1),
            torch.stack([rx, py], -1), torch.stack([rx, -py], -1)], dim=1)

    def pick(cand: torch.Tensor, fallback: int) -> torch.Tensor:
        """cand [n, m, 4, 2] → one valid candidate per sample, [n, 4, 2].
        ``fallback`` indexes the candidate that is always safe."""
        m = cand.shape[1]
        if allow_artifacts:
            # the reference draws uniformly over the first m − 1 candidates:
            # for the scales that keeps the leading 1 and drops the last
            # sampled scale, for the angles it drops the trailing zero
            valid = (torch.arange(m, device=dev) < m - 1).expand(n, m)
        else:
            valid = ((cand >= 0.0) & (cand < 1.0)).all(dim=3).all(dim=2)
            valid[:, fallback] = True
        choice = _pick_valid(rand(n, m), valid)
        return cand[torch.arange(n, device=dev), choice]

    if scaling:
        # n_scales truncated-normal candidates after a guaranteed scale 1
        s = _trunc_normal((n, n_scales), generator, dev)
        scales = torch.cat([torch.ones(n, 1, device=dev), 1.0 + s * scaling_amplitude / 2.0], 1)
        center = pts2.mean(dim=1, keepdim=True)
        cand = (pts2 - center)[:, None] * scales[:, :, None, None] + center[:, None]
        pts2 = pick(cand, 0)

    if translation:
        t_min = pts2.min(dim=1).values
        t_max = (1.0 - pts2).min(dim=1).values
        if allow_artifacts:
            t_min = t_min + translation_overflow
            t_max = t_max + translation_overflow
        pts2 = pts2 + (rand(n, 2) * (t_max + t_min) - t_min)[:, None, :]

    if rotation:
        angles = torch.linspace(-max_angle, max_angle, n_angles, device=dev)
        angles = torch.cat([angles, torch.zeros(1, device=dev)])  # zero fallback, last
        center = pts2.mean(dim=1, keepdim=True)
        cos, sin = torch.cos(angles), torch.sin(angles)
        rot = torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)
        cand = torch.einsum("npc,acd->napd", pts2 - center, rot) + center[:, None]
        pts2 = pick(cand, n_angles)

    # the unit square conjugated onto [shift, shift + 2]² when shifted
    scale = 2.0 if shift else 1.0
    return homography_from_corners(pts1 * scale + shift, pts2 * scale + shift)


def sample_homography(*, generator: Optional[torch.Generator] = None, **params) -> torch.Tensor:
    """One [3, 3] homography (see :func:`sample_homographies`)."""
    return sample_homographies(1, generator=generator, **params)[0]
