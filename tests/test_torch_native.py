"""Port parity: the host ops of ``ssp_torch.native`` (C++
``ssp_torch/csrc/ops_host.cpp``) against the JAX package's C++ (``ssp.native``,
which ``tests/test_native.py`` builds too) and against their own plain numpy
versions, on seeded inputs.

* Greedy NMS: keep masks equal to the JAX C++ on 240×320 maps, with
  deliberate ties (scores rounded to a few levels, so tied neighbours within
  the distance decide by the sort's order) and with ``min_score``; equal to
  the plain version on the same maps: it sorts with libstdc++'s introsort
  (``std_sort``), so tied scores come in ``std::sort``'s order, also past the
  introsort's depth limit, where it falls back to a heap sort.
* Warp: within 1e-6 of the JAX C++ and of the plain version.
* Matcher: indices and mutuality equal to the JAX C++ and distances within
  1e-6; equal to the plain version (similarities summed in the same order);
  ties on both sides resolve to the first index.
"""

import numpy as np
import pytest

from ssp import native as jnative
from ssp_torch import native
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

HW = (240, 320)


def _scores(seed: int, levels=None) -> np.ndarray:
    """A seeded score map, most of it small; ``levels`` rounds it to that many
    steps (ties), otherwise every score is distinct."""
    n = HW[0] * HW[1]
    s = ((np.random.default_rng(seed).permutation(n) + 1.0) / n).reshape(HW) ** 4
    if levels is not None:
        s = np.round(s * levels) / levels
    return s.astype(np.float32)


def _unit(rng, n: int, d: int) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("levels", [None, 8, 40], ids=["no-ties", "ties8", "ties40"])
@pytest.mark.parametrize("dist,min_score", [(4, 0.0), (4, 0.1), (2, 0.015)])
def test_greedy_nms_matches_jax_cpp(levels, dist, min_score):
    scores = _scores(1, levels)
    got = native.greedy_nms(scores, dist, min_score)
    want = jnative.greedy_nms(scores, dist, min_score)
    assert got.dtype == bool and got.shape == HW
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 100
    assert not got[scores < min_score].any() and not got[scores <= 0].any()
    if levels is not None:  # the ties are real: tied scores within the distance of each other
        flat = scores[scores > max(min_score, 0)]
        assert len(np.unique(flat)) < len(flat) // 10


@pytest.mark.parametrize("levels", [None, 8, 40], ids=["no-ties", "ties8", "ties40"])
@pytest.mark.parametrize("dist,min_score", [(4, 0.0), (4, 0.1), (1, 0.015)])
def test_greedy_nms_matches_plain(levels, dist, min_score):
    scores = _scores(2, levels)
    if levels is None:
        assert len(np.unique(scores)) == scores.size
    got = native.greedy_nms(scores, dist, min_score)
    np.testing.assert_array_equal(got, native.greedy_nms_plain(scores, dist, min_score))
    if levels is not None:  # a stable sort would keep other points
        flat = scores.reshape(-1)
        cand = np.flatnonzero((flat >= np.float32(min_score)) & (flat > 0))
        stable = np.zeros(scores.size, bool)
        sup = np.zeros(scores.shape, bool)
        for i in cand[np.argsort(-flat[cand], kind="stable")]:
            y, x = divmod(int(i), scores.shape[1])
            if not sup[y, x]:
                stable[i] = True
                sup[max(0, y - dist):y + dist + 1, max(0, x - dist):x + dist + 1] = True
        assert (stable.reshape(scores.shape) != got).any()


def test_greedy_nms_plain_past_the_introsort_depth(monkeypatch):
    """Musser's median-of-three killer, rounded to ties, as one row of
    scores: the introsort exhausts its depth and heap-sorts, and the keep
    mask still equals the C++'s."""
    k = 2048
    a = np.zeros(2 * k)
    for i in range(1, k + 1):
        if i % 2:
            a[i - 1], a[i] = i, k + i
        a[k + i - 1] = 2 * i
    scores = (np.floor(a / 3) / (2 * k) + 0.01).astype(np.float32)[None, :]
    heaps = []
    make_heap = native._make_heap
    monkeypatch.setattr(native, "_make_heap", lambda *args: heaps.append(1) or make_heap(*args))
    got = native.greedy_nms_plain(scores, 1)
    assert heaps
    np.testing.assert_array_equal(got, native.greedy_nms(scores, 1))
    np.testing.assert_array_equal(got, jnative.greedy_nms(scores, 1))


def test_greedy_nms_keeps_isolated_points_and_suppresses_neighbours():
    s = np.zeros((16, 16), np.float32)
    s[4, 4], s[5, 6], s[12, 12] = 0.5, 0.4, 0.05
    for fn in (native.greedy_nms, native.greedy_nms_plain):
        keep = fn(s, 2, 0.1)
        assert keep.sum() == 1 and keep[4, 4]
        assert fn(s, 1, 0.0).sum() == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inv_warp_matches_jax_cpp_and_plain(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=HW).astype(np.float32)
    H_mat = np.eye(3) + rng.normal(scale=[[0.05, 0.05, 0.1], [0.05, 0.05, 0.1],
                                          [0.02, 0.02, 0.0]])
    got = native.inv_warp_bilinear(img, H_mat)
    assert got.dtype == np.float32 and got.shape == HW
    np.testing.assert_allclose(got, jnative.inv_warp_bilinear(img, H_mat), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, native.inv_warp_bilinear_plain(img, H_mat), rtol=0,
                               atol=1e-6)
    assert (got == 0).any() and (got > 0).mean() > 0.5  # both inside and outside the image


def test_inv_warp_identity_is_the_image():
    img = np.random.default_rng(3).uniform(size=(24, 40)).astype(np.float32)
    np.testing.assert_allclose(native.inv_warp_bilinear(img, np.eye(3)), img, atol=1e-6)


@pytest.mark.parametrize("n1,n2,d,thresh", [(300, 250, 256, 1.4), (1000, 900, 64, 0.9),
                                            (40, 35, 32, 1.2)])
def test_matcher_matches_jax_cpp_and_plain(n1, n2, d, thresh):
    rng = np.random.default_rng(n1)
    d1, d2 = _unit(rng, n1, d), _unit(rng, n2, d)
    d2[:20] = d1[:20] + 0.01 * _unit(rng, 20, d)  # some near pairs, so some mutual matches
    d2[:20] /= np.linalg.norm(d2[:20], axis=1, keepdims=True)
    got = native.nn_match_two_way_native(d1, d2, thresh)
    want = jnative.nn_match_two_way_native(d1, d2, thresh)
    assert got.shape[0] == 3 and got.shape[1] >= 20
    np.testing.assert_array_equal(got[:2], want[:2])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, native.nn_match_two_way_plain(d1, d2, thresh))


def test_matcher_ties_take_the_first_index():
    """Duplicate descriptors on both sides: the nearest is the first of the
    equal similarities, on both sides, so mutuality decides as the JAX C++'s
    ``best2`` update order does."""
    rng = np.random.default_rng(4)
    d1 = _unit(rng, 6, 16)
    d1[3] = d1[1]
    d2 = np.concatenate([d1[[1, 1, 0]], _unit(rng, 3, 16)])
    got = native.nn_match_two_way_native(d1, d2, 2.0)
    np.testing.assert_array_equal(got, jnative.nn_match_two_way_native(d1, d2, 2.0))
    np.testing.assert_array_equal(got, native.nn_match_two_way_plain(d1, d2, 2.0))
    rows = dict(zip(got[0].astype(int), got[1].astype(int)))
    assert rows[1] == 0 and 3 not in rows and rows[0] == 2


def test_empty_and_bad_inputs():
    d = _unit(np.random.default_rng(5), 4, 8)
    assert native.nn_match_two_way_native(d[:0], d, 1.0).shape == (3, 0)
    assert native.nn_match_two_way_plain(d, d[:0], 1.0).shape == (3, 0)
    with pytest.raises(ValueError, match=r"\[N1, D\]"):
        native.nn_match_two_way_native(d, d[:, :4], 1.0)
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        native.greedy_nms(np.zeros((2, 3, 4), np.float32), 2)
    with pytest.raises(ValueError, match=r"\[3, 3\]"):
        native.inv_warp_bilinear(np.zeros((4, 4), np.float32), np.eye(2))
