"""Port parity: ``ssp_torch.core.homography`` against ``ssp.core.homography``.

The closed-form 3×3 algebra is fp32 on both sides and agrees to atol 1e-5
(products of O(1) numbers summed in another order).  The samplers cannot
agree draw by draw (torch cannot reproduce threefry bits), so they are held
together in distribution over a few thousand draws, and the port's own
candidate rule is checked directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.core import homography as jh
from ssp_torch.core import homography as th
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

HA_PARAMS = dict(translation=True, rotation=True, scaling=True, perspective=True,
                 scaling_amplitude=0.2, perspective_amplitude_x=0.2,
                 perspective_amplitude_y=0.2, allow_artifacts=True, patch_ratio=0.85)
UNIT = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]], np.float32)


def _matrices(seed, n=6):
    rng = np.random.default_rng(seed)
    return (np.eye(3) + rng.normal(0, 0.2, (n, 3, 3))).astype(np.float32)


def test_inv3_and_adjugate_match_jax():
    M = _matrices(0)
    np.testing.assert_allclose(th.inv3(torch.from_numpy(M)).numpy(),
                               np.asarray(jh.inv3(jnp.asarray(M))), atol=1e-5)
    np.testing.assert_allclose(th.adjugate3(torch.from_numpy(M)).numpy(),
                               np.asarray(jh.adjugate3(jnp.asarray(M))), atol=1e-5)


def test_homography_from_corners_matches_jax():
    rng = np.random.default_rng(1)
    pts2 = (UNIT + rng.normal(0, 0.08, (5, 4, 2))).astype(np.float32)
    got = th.homography_from_corners(torch.from_numpy(UNIT), torch.from_numpy(pts2)).numpy()
    for n in range(5):
        want = np.asarray(jh.homography_from_corners(jnp.asarray(UNIT), jnp.asarray(pts2[n])))
        np.testing.assert_allclose(got[n], want, atol=1e-5)
    # and it does what it says: H·[pts1, 1] ∝ [pts2, 1]
    mapped = th.warp_points(torch.from_numpy(UNIT).expand(5, 4, 2), torch.from_numpy(got))
    np.testing.assert_allclose(mapped.numpy(), pts2, atol=1e-5)


def test_warp_points_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (6, 40, 2)).astype(np.float32)
    M = _matrices(2)
    want = np.asarray(jh.warp_points(jnp.asarray(pts), jnp.asarray(M)))
    got = th.warp_points(torch.from_numpy(pts), torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # one homography shared by a batch of point sets
    want1 = np.asarray(jh.warp_points(jnp.asarray(pts), jnp.asarray(M[0])))
    got1 = th.warp_points(torch.from_numpy(pts), torch.from_numpy(M[0])).numpy()
    np.testing.assert_allclose(got1, want1, atol=1e-5)


@pytest.mark.parametrize("shift", [(-1.0, -1.0), (0.0, 0.0)])
def test_scale_homography_matches_jax(shift):
    M = _matrices(3, n=1)[0]
    want = np.asarray(jh.scale_homography(jnp.asarray(M), (240, 320), shift))
    got = th.scale_homography(torch.from_numpy(M), (240, 320), shift).numpy()
    # entries reach ~|M|·W: atol 1e-5 relative to the largest entry
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()))


def _corners(Hs):
    """Where each homography sends the unit square's corners ([-1, 1]²)."""
    sq = UNIT * 2.0 - 1.0
    return th.warp_points(torch.from_numpy(sq).expand(len(Hs), 4, 2), torch.as_tensor(Hs)).numpy()


@pytest.mark.parametrize("params", [HA_PARAMS, dict(allow_artifacts=False)],
                         ids=["export", "defaults"])
def test_sampler_matches_jax_in_distribution(params):
    """Corner displacements of 4000 draws per side.  Their spreads are about
    0.2-0.6; the standard error of a mean over 4000 draws is below 0.01 and
    that of a spread below 0.007, so 0.04 and 8% are wide of noise and far
    inside what a wrong amplitude, a missing stage or a transposed rotation
    would move (the stages differ by factors of two)."""
    n = 4000
    want = _corners(np.array(jh.sample_homographies(jax.random.key(0), n, shift=-1.0, **params)))
    Hs = th.sample_homographies(n, generator=torch.Generator().manual_seed(0), shift=-1.0, **params)
    assert Hs.shape == (n, 3, 3) and Hs.dtype == torch.float32 and bool(torch.isfinite(Hs).all())
    np.testing.assert_allclose(Hs[:, 2, 2].numpy(), 1.0, atol=1e-6)
    got = _corners(Hs)
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=0.04)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.08, atol=0.01)
    # patch size and orientation: side lengths and the mean rotation angle
    for a in (got, want):
        a -= a.mean(axis=1, keepdims=True)
    side = lambda c: np.linalg.norm(c[:, 1] - c[:, 0], axis=-1)
    np.testing.assert_allclose(side(got).mean(), side(want).mean(), rtol=0.03)
    ang = lambda c: np.arctan2(c[:, 1, 1] - c[:, 0, 1], c[:, 1, 0] - c[:, 0, 0])
    np.testing.assert_allclose(ang(got).std(), ang(want).std(), rtol=0.08)


def test_sampler_keeps_candidates_inside_without_artifacts():
    """``allow_artifacts=False``: every stage picks among the candidates that
    keep the patch inside the unit square (or its safe fallback), so the
    sampled patch never leaves [-1, 1]² (fp32 slack 1e-5)."""
    Hs = th.sample_homographies(3000, generator=torch.Generator().manual_seed(1), shift=-1.0,
                                scaling_amplitude=0.4, perspective_amplitude_x=0.3,
                                perspective_amplitude_y=0.3, patch_ratio=0.7,
                                allow_artifacts=False)
    c = _corners(Hs)
    assert c.min() >= -1.0 - 1e-5 and c.max() <= 1.0 + 1e-5, (c.min(), c.max())


def test_sampler_is_reproducible_and_stage_flags_work():
    g = lambda: torch.Generator().manual_seed(5)
    a = th.sample_homographies(7, generator=g(), **HA_PARAMS)
    b = th.sample_homographies(7, generator=g(), **HA_PARAMS)
    assert torch.equal(a, b)
    one = th.sample_homography(generator=g(), **HA_PARAMS)
    assert one.shape == (3, 3)
    # every stage off: the centred patch alone, H = patch_ratio·I about 0
    plain = th.sample_homographies(2, perspective=False, scaling=False, rotation=False,
                                   translation=False, patch_ratio=0.5)
    want = torch.tensor([[0.5, 0.0, 0.0], [0.0, 0.5, 0.0], [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(plain.numpy(), want.expand(2, 3, 3).numpy(), atol=1e-6)


def test_pick_valid_is_uniform_on_the_valid_set():
    valid = torch.tensor([True, False, True, True, False]).expand(6000, 5)
    u = torch.rand(6000, 5, generator=torch.Generator().manual_seed(2))
    idx = th._pick_valid(u, valid)
    counts = torch.bincount(idx, minlength=5).numpy()
    assert counts[1] == 0 and counts[4] == 0
    # three valid choices at 1/3 each: 2000 ± 37 (1σ); 5σ either way
    assert np.all(np.abs(counts[[0, 2, 3]] - 2000) < 190), counts
