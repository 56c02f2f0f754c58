"""Sparse descriptor loss: fixed-size match / non-match sampling (port of
``ssp/losses/descriptor_sparse.py``; reference ``descriptor_loss_sparse``).

  * every Hc×Wc cell coordinate is warped by the pair homography
    (conjugated into cell units) and rounded; in-bounds ones are matches;
  * ``num_matching_attempts`` (1000) matches are drawn with replacement from
    them; the match loss is the cosine hinge ``mean(max(0, 1 − d·d′))`` with
    the descriptors sampled bilinearly at ``uv·(S−1)/S`` (method "2d", the
    ``grid_sample(align_corners=True)`` of normalised ``uv/S·2 − 1``) or read
    at the integer cell (method "1d");
  * ``num_masked_non_matches_per_match`` (100) random cells of the warped
    view per match, perturbed off collisions with the true match and wrapped
    at the borders; the non-match loss is ``sum(max(0, d·d′ − 0.2)) /
    (hard negatives + 1)``;
  * total = λ_d·match + non_match; the batch takes the mean of each (over
    ``batch_total`` samples when the batch is split over ranks, so that each
    rank's loss is its additive share of the global batch's).

The draws (:class:`SparseDraws`) are separate from the arithmetic, so a test
can feed the port the JAX package's own draws.  The port draws its own from
a ``torch.Generator`` (:func:`sample_draws`); ``jax.random`` cannot be
reproduced.

What differs from the JAX package's arithmetic: its matmul and one-hot
formulations (TPU gather workarounds) are indexes here.  The non-match dot
products are read out of the per-sample Gram matrix ``D_a(match) · D_bᵀ``
([M, Hc·Wc], one batched fp32 matmul) with ``gather``: indexing the
[M, N, D] descriptor rows instead would move 100× the bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ssp_torch._device import constant
from ssp_torch.core.homography import scale_homography, warp_points
from ssp_torch.core.warp import bilinear_sample


MARGIN_POS, MARGIN_NEG = 1.0, 0.2  # the hinges' margins (reference defaults)


@dataclass
class SparseDraws:
    """The loss's random numbers for a batch of B samples.

    ``choice [B, M]`` match indices into the Hc·Wc cells; ``rand_flat
    [B, M·N]`` non-match cells; ``sign_u [B, M·N]`` U(0, 1) for the
    perturbation's sign; ``normal [B, M·N]`` N(0, 1) for its size.
    """

    choice: torch.Tensor
    rand_flat: torch.Tensor
    sign_u: torch.Tensor
    normal: torch.Tensor


def cell_matches(H_pair: torch.Tensor, shape: Tuple[int, int]):
    """(uv_a [C, 2] cell coords (x, y) row-major, uv_b [B, C, 2] their warps,
    rounded, valid [B, C] in-bounds) for ``H_pair [B, 3, 3]`` on a
    ``shape = (Hc, Wc)`` grid."""
    Hc, Wc = shape
    vy, vx = torch.meshgrid(torch.arange(Hc, device=H_pair.device),
                            torch.arange(Wc, device=H_pair.device), indexing="ij")
    uv_a = torch.stack([vx, vy], dim=-1).reshape(-1, 2).float()
    H_cells = scale_homography(H_pair.float(), (Hc, Wc))
    uv_b = torch.round(warp_points(uv_a, H_cells))
    valid = ((uv_b[..., 0] >= 0) & (uv_b[..., 0] <= Wc - 1)
             & (uv_b[..., 1] >= 0) & (uv_b[..., 1] <= Hc - 1))
    return uv_a, uv_b, valid


def sample_draws(valid: torch.Tensor, num_matching_attempts: int,
                 num_masked_non_matches_per_match: int,
                 generator: Optional[torch.Generator] = None) -> SparseDraws:
    """The port's own draws on ``valid``'s device: matches uniform with
    replacement over each sample's valid cells (over all cells where none is
    valid, as the JAX package's masked categorical does)."""
    B, C = valid.shape
    M, N = num_matching_attempts, num_masked_non_matches_per_match
    dev = valid.device
    w = valid.float()
    w = torch.where(w.sum(dim=1, keepdim=True) > 0, w, torch.ones_like(w))
    return SparseDraws(
        choice=torch.multinomial(w, M, replacement=True, generator=generator),
        rand_flat=torch.randint(0, C, (B, M * N), generator=generator, device=dev),
        sign_u=torch.rand((B, M * N), generator=generator, device=dev),
        normal=torch.randn((B, M * N), generator=generator, device=dev),
    )


def descriptor_loss_sparse(
    desc: torch.Tensor,
    desc_warped: torch.Tensor,
    H_pair: torch.Tensor,
    draws: Optional[SparseDraws] = None,
    *,
    generator: Optional[torch.Generator] = None,
    num_matching_attempts: int = 1000,
    num_masked_non_matches_per_match: int = 100,
    lamda_d: float = 1.0,
    method: str = "2d",
    batch_total: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, None, torch.Tensor, torch.Tensor]:
    """desc/desc_warped ``[B, Hc, Wc, D]``; H_pair ``[B, 3, 3]`` normalised
    homography (image 1 → image 2).  Returns (mean total, None, mean match,
    mean non-match), the reference's return contract.  Without ``draws``
    they are drawn from ``generator``."""
    B, Hc, Wc, D = desc.shape
    M, N = num_matching_attempts, num_masked_non_matches_per_match
    uv_a, uv_b, valid = cell_matches(H_pair, (Hc, Wc))
    if draws is None:
        draws = sample_draws(valid, M, N, generator)
    bidx = torch.arange(B, device=desc.device)[:, None]
    choice = draws.choice.long()
    m_a = uv_a[choice]  # [B, M, 2]
    m_b = uv_b[bidx, choice]

    flat_a = desc.reshape(B, Hc * Wc, D)
    flat_b = desc_warped.reshape(B, Hc * Wc, D)
    if method == "2d":
        scale = constant(torch.tensor([(Wc - 1) / Wc, (Hc - 1) / Hc]), desc.device)
        da = bilinear_sample(desc, m_a * scale)
        db = bilinear_sample(desc_warped, m_b * scale)
    else:
        def cell(uv):
            ix = uv[..., 0].long().clamp(0, Wc - 1)
            iy = uv[..., 1].long().clamp(0, Hc - 1)
            return iy * Wc + ix

        da = flat_a[bidx, cell(m_a)]
        db = flat_b[bidx, cell(m_b)]
    match_loss = torch.relu(MARGIN_POS - (da * db).sum(dim=-1)).mean(dim=1)  # [B]

    # non-matches: random cells of the warped view, perturbed off collisions
    nm_u = (draws.rand_flat % Wc).float().reshape(B, M, N)
    nm_v = torch.div(draws.rand_flat, Wc, rounding_mode="floor").float().reshape(B, M, N)
    too_close = (((m_b[..., 0:1] - nm_u).abs() < 1.0) | ((m_b[..., 1:2] - nm_v).abs() < 1.0))
    sign = torch.floor(draws.sign_u * 2.0) - 0.5
    noise = (draws.normal * 10.0 + sign).reshape(B, M, N)
    perturb = torch.where(too_close, noise, torch.zeros_like(noise))

    def wrap(x, upper):
        x = torch.where(x > upper, x - upper, x)
        return torch.where(x < 0.0, x + upper, x)

    nm_u = wrap(nm_u + perturb, float(Wc - 1))
    nm_v = wrap(nm_v + perturb, float(Hc - 1))
    idx_b = nm_u.long().clamp(0, Wc - 1) + nm_v.long().clamp(0, Hc - 1) * Wc  # [B, M, N]
    idx_a = m_a[..., 0].long() + m_a[..., 1].long() * Wc  # [B, M]
    gram = flat_a[bidx, idx_a] @ flat_b.transpose(1, 2)  # [B, M, Hc·Wc]
    nm_dot = torch.gather(gram, 2, idx_b)
    nm_hinge = torch.relu(nm_dot - MARGIN_NEG)
    num_hard = (nm_hinge > 0.0).sum(dim=(1, 2))
    non_match_loss = nm_hinge.sum(dim=(1, 2)) / (num_hard + 1.0)

    total = lamda_d * match_loss + non_match_loss
    if batch_total is None:
        return total.mean(), None, match_loss.mean(), non_match_loss.mean()
    return (total.sum() / batch_total, None, match_loss.sum() / batch_total,
            non_match_loss.sum() / batch_total)
