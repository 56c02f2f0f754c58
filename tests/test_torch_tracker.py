"""Port parity for matching and tracking: ``ssp_torch.postprocess.tracker``
against ``ssp.postprocess.tracker`` on seeded descriptor sets.

Bars: exact.  Both sides run the same numpy arithmetic on the same inputs
(the matcher and tracker stay on the host by design), so matches, distances
and track tables are equal bit for bit.  The tensor matcher
``nn_match_two_way_torch`` against ``nn_match_two_way_jax``: indices and
validity exact, distances to 1e-6 (fp32 matmuls in two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.postprocess.tracker import PointTracker as JPointTracker
from ssp.postprocess.tracker import nn_match_two_way as j_match
from ssp.postprocess.tracker import nn_match_two_way_jax
from ssp_torch.postprocess import PointTracker, nn_match_two_way
from ssp_torch.postprocess.tracker import nn_match_two_way_torch
from test_torch_threads import _one_thread  # noqa: F401  (autouse)


def _desc(rng, n, d=32, base=None, noise=0.3):
    """[d, n] unit columns; near copies of ``base`` columns when given."""
    x = rng.normal(size=(d, n)) if base is None else base[:, :n] + noise * rng.normal(size=(d, n))
    return (x / np.linalg.norm(x, axis=0, keepdims=True)).astype(np.float32)


def _pts(rng, n):
    return np.stack([rng.uniform(0, 96, n), rng.uniform(0, 64, n),
                     rng.uniform(0, 1, n)]).astype(np.float32)


@pytest.mark.parametrize("n1,n2", [(0, 5), (5, 0), (0, 0), (1, 1), (40, 30), (30, 40)])
@pytest.mark.parametrize("thresh", [0.0, 0.7, 1.0, 2.1])
def test_nn_match_two_way_exact(n1, n2, thresh):
    rng = np.random.default_rng(n1 * 100 + n2)
    d1 = _desc(rng, n1)
    d2 = _desc(rng, n2, base=d1) if n2 <= n1 and n1 else _desc(rng, n2)
    want, got = j_match(d1, d2, thresh), nn_match_two_way(d1, d2, thresh)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_nn_match_negative_threshold_raises():
    d = _desc(np.random.default_rng(0), 3)
    with pytest.raises(ValueError):
        nn_match_two_way(d, d, -0.1)


@pytest.mark.parametrize("n1,n2,thresh", [(40, 30, 0.7), (30, 40, 1.0), (8, 8, 0.3)])
def test_nn_match_two_way_torch_matches_jax(n1, n2, thresh):
    rng = np.random.default_rng(n1 + n2)
    d1 = _desc(rng, n1).T
    d2 = _desc(rng, n2, base=d1.T).T if n2 <= n1 else _desc(rng, n2).T
    idx_j, valid_j, dist_j = (np.asarray(a) for a in
                              nn_match_two_way_jax(jnp.asarray(d1), jnp.asarray(d2), thresh))
    idx, valid, dist = nn_match_two_way_torch(torch.from_numpy(d1), torch.from_numpy(d2), thresh)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    np.testing.assert_allclose(dist.numpy(), dist_j, rtol=0, atol=1e-6)
    # the same matches as the host matcher
    host = nn_match_two_way(d1.T, d2.T, thresh)
    np.testing.assert_array_equal(np.flatnonzero(valid.numpy()), host[0].astype(int))


@pytest.mark.parametrize("max_length,sizes", [(2, (30, 25)), (3, (30, 25, 35)),
                                              (3, (20, 0, 20)), (2, (0, 10))])
def test_point_tracker_exact(max_length, sizes):
    """Frames of descriptors that partly continue the previous frame's:
    matches, scores and the track table after every update are equal."""
    rng = np.random.default_rng(sum(sizes) + max_length)
    want, got = JPointTracker(max_length, 0.7), PointTracker(max_length, 0.7)
    prev = None
    for n in sizes:
        desc = _desc(rng, n, base=prev) if prev is not None and prev.shape[1] >= n > 0 \
            else _desc(rng, n)
        pts = _pts(rng, n)
        want.update(pts, desc)
        got.update(pts, desc)
        for a, b in ((got.get_matches(), want.get_matches()),
                     (got.get_mscores(), want.get_mscores()), (got.tracks, want.tracks)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for min_length in (1, 2):
            np.testing.assert_array_equal(got.get_tracks(min_length), want.get_tracks(min_length))
        prev = desc if n else prev
    assert got.track_count == want.track_count


def test_point_tracker_rejects_bad_arguments():
    with pytest.raises(ValueError):
        PointTracker(max_length=1)
    with pytest.raises(ValueError):
        PointTracker().get_tracks(0)
