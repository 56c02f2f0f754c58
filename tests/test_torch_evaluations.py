"""The port's evaluation modules (``ssp_torch/evaluations``) against the
JAX package's and against the libraries they stand in for.

* ``compute_repeatability`` and ``evaluate_semantic``: the same numpy
  arithmetic as ``ssp.evaluations``, so equal (exact).
* ``bf_match_cross_check``: identical ``(query, train)`` lists to
  ``cv2.BFMatcher(cv2.NORM_L2, crossCheck=True)``, exact duplicates
  included (OpenCV keeps the lowest index in both directions).
* ``average_precision``: ``sklearn.metrics.average_precision_score``
  within 1e-12, ties included.
* ``find_homography`` against ``cv2.findHomography(..., cv2.RANSAC)`` on 60
  seeded match sets (20-400 matches, 0-60% outliers, 0.5-1 px Gaussian
  noise, float32 and float64): the inlier masks agree on ≥ 98% of all
  points; where both fit, the mean four-corner error against the true H is
  on average no more than cv2's + 0.1 px; ``None`` where cv2 gives none
  (fewer than 4 points, all points collinear); two calls give the same
  result.  The fit draws OpenCV's own sets (its generator, its order), so
  it does better than these bars: measured, every mask equal to OpenCV's
  and the corner errors equal to 1e-6 px.
"""

import cv2
import numpy as np
import pytest
from sklearn.metrics import average_precision_score

from ssp.evaluations import detector as j_det
from ssp.evaluations import semantic as j_sem
from ssp_torch.evaluations import detector, semantic
from ssp_torch.evaluations.homography_fit import find_homography
from ssp_torch.evaluations.matching import average_precision, bf_match_cross_check
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

W, H = 320, 240
CORNERS = np.array([[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1]], np.float64)
MASK_AGREEMENT_MIN = 0.98
CORNER_SLACK_PX = 0.1


def _warp(p, Hm):
    q = np.c_[p, np.ones(len(p))] @ Hm.T
    return q[:, :2] / q[:, 2:]


# -- repeatability --------------------------------------------------------------


def _points(rng, n, hw, score_levels=None):
    xy = rng.uniform([0, 0], [hw[1], hw[0]], (n, 2))
    s = (rng.integers(0, score_levels, n) / score_levels if score_levels
         else rng.uniform(0.01, 1, n))
    return np.c_[xy, s].astype(np.float32)


@pytest.mark.parametrize("case", ["same_size", "other_size", "empty1", "empty2", "top_k_ties"])
def test_repeatability_equals_jax(case):
    rng = np.random.default_rng(["same_size", "other_size", "empty1", "empty2",
                                 "top_k_ties"].index(case))
    hw1, hw2 = (60, 80), ((72, 90) if case == "other_size" else (60, 80))
    Hm = np.eye(3)
    Hm[:2, :2] += rng.uniform(-0.1, 0.1, (2, 2))
    Hm[:2, 2] = rng.uniform(-5, 5, 2)
    levels = 4 if case == "top_k_ties" else None
    p1 = _points(rng, 0 if case == "empty1" else 150, hw1, levels)
    p2 = _points(rng, 0 if case == "empty2" else 140, hw2, levels)
    if case != "empty1" and case != "empty2":
        p2[:60, :2] = _warp(p1[:60, :2], Hm) + rng.normal(0, 0.7, (60, 2))
    for keep in (1000, 50):
        kw = dict(keep_k_points=keep, distance_thresh=3.0, shape2_hw=hw2)
        want = j_det.compute_repeatability(p1, p2, Hm, hw1, **kw)
        got = detector.compute_repeatability(p1, p2, Hm, hw1, **kw)
        assert got == want
    np.testing.assert_array_equal(detector._top_k(p1, 20), j_det._top_k(p1, 20))
    np.testing.assert_array_equal(detector.warp_keypoints_np(p1[:, :2], Hm),
                                  j_det.warp_keypoints_np(p1[:, :2], Hm))


# -- semantic -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["logits", "labels"])
def test_semantic_metrics_equal_jax(kind):
    rng = np.random.default_rng(7)
    n_classes = 12
    target = rng.integers(0, 8, (2, 16, 24))  # classes 8..11 absent
    target[0, :3] = 133  # the ignore class
    target[1, :2] = 255  # an out-of-range void label
    target[1, 2, :5] = -1
    if kind == "logits":
        pred = rng.normal(size=(2, 16, 24, n_classes)).astype(np.float32)
    else:
        pred = rng.integers(-2, n_classes + 3, (2, 16, 24))  # out of range: clipped
    want = j_sem.evaluate_semantic(pred, target, n_classes=n_classes)
    got = semantic.evaluate_semantic(pred, target, n_classes=n_classes)
    assert got == want
    np.testing.assert_array_equal(semantic.confusion_matrix(pred.argmax(-1) if kind == "logits"
                                                            else pred, target, n_classes),
                                  j_sem.confusion_matrix(pred.argmax(-1) if kind == "logits"
                                                         else pred, target, n_classes))
    assert semantic.semantic_metrics(np.zeros((3, 3))) == j_sem.semantic_metrics(np.zeros((3, 3)))


# -- the matcher ----------------------------------------------------------------


def _unit(rng, n, d=256):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_bf_match_equals_cv2_cross_check(seed):
    rng = np.random.default_rng(seed)
    n1, n2 = (int(v) for v in rng.integers(4, 700, 2))
    d1, d2 = _unit(rng, n1), _unit(rng, n2)
    if seed % 2:  # exact duplicates on both sides, and matches that are near copies
        d1[:3] = d1[3:6]
        d2[:4] = d1[0]
        d2[6] = d2[5]
        k = min(n1, n2) // 2
        d2[-k:] = d1[:k] + rng.normal(0, 0.05, (k, 256)).astype(np.float32)
    matches = cv2.BFMatcher(cv2.NORM_L2, crossCheck=True).match(d1, d2)
    query, train = bf_match_cross_check(d1, d2)
    assert list(query) == [m.queryIdx for m in matches]
    assert list(train) == [m.trainIdx for m in matches]
    assert len(query) > 0


def test_bf_match_lowest_index_on_ties_and_empty_sets():
    rng = np.random.default_rng(0)
    d = _unit(rng, 5, 8)
    q = np.stack([d[0], d[0], d[1], d[2], d[3]])
    t = np.stack([d[1], d[0], d[0], d[2], d[2], d[4]])
    matches = cv2.BFMatcher(cv2.NORM_L2, crossCheck=True).match(q, t)
    got = list(zip(*bf_match_cross_check(q, t)))
    assert got == [(m.queryIdx, m.trainIdx) for m in matches]
    assert got[:3] == [(0, 1), (2, 0), (3, 3)]  # duplicates: the lowest index on both sides
    for a, b in ((q[:0], t), (q, t[:0])):
        query, train = bf_match_cross_check(a, b)
        assert query.shape == train.shape == (0,)


# -- average precision ----------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True])
def test_average_precision_equals_sklearn(ties):
    rng = np.random.default_rng(int(ties))
    for _ in range(100):
        n = int(rng.integers(1, 300))
        labels = rng.uniform(size=n) < rng.uniform(0.05, 0.95)
        labels[rng.integers(n)] = True
        scores = (rng.integers(0, rng.integers(1, 20), n) / 3.0 if ties
                  else rng.normal(size=n))
        got = average_precision(labels, scores)
        assert abs(got - average_precision_score(labels, scores)) <= 1e-12
    assert average_precision([True, True], [0.5, 0.5]) == 1.0


# -- the homography fit ---------------------------------------------------------


def _match_set(seed):
    """A seeded match set: 20-400 matches of points in a 320×240 image under
    a mild perspective homography, 0-60% outliers anywhere in the image,
    0.5-1 px Gaussian noise on the rest; float64 for even seeds (as
    ``_nn_map`` passes them), float32 for odd ones (``compute_homography``)."""
    rng = np.random.default_rng(seed)
    n, outliers, sigma = int(rng.integers(20, 401)), rng.uniform(0, 0.6), rng.uniform(0.5, 1.0)
    Hm = np.eye(3)
    Hm[:2, :2] += rng.uniform(-0.15, 0.15, (2, 2))
    Hm[:2, 2] = rng.uniform(-20, 20, 2)
    Hm[2, :2] = rng.uniform(-4e-4, 4e-4, 2)
    src = rng.uniform([0, 0], [W, H], (n, 2))
    dst = _warp(src, Hm) + rng.normal(0, sigma, (n, 2))
    bad = rng.uniform(size=n) < outliers
    dst[bad] = rng.uniform([0, 0], [W, H], (int(bad.sum()), 2))
    dtype = np.float32 if seed % 2 else np.float64
    return src.astype(dtype), dst.astype(dtype), Hm


def test_find_homography_against_cv2():
    agree = total = 0
    corner_port, corner_cv2 = [], []
    for seed in range(60):
        src, dst, Hm = _match_set(seed)
        H_port, m_port = find_homography(src, dst)
        H_cv2, m_cv2 = cv2.findHomography(src, dst, cv2.RANSAC)
        assert H_port is not None and H_cv2 is not None, seed
        assert m_port.shape == (len(src),) and m_port.dtype == bool
        assert H_port[2, 2] == 1.0
        m_cv2 = m_cv2.ravel().astype(bool)
        agree += int((m_port == m_cv2).sum())
        total += len(src)
        true = _warp(CORNERS, Hm)
        corner_port.append(np.linalg.norm(_warp(CORNERS, H_port) - true, axis=1).mean())
        corner_cv2.append(np.linalg.norm(_warp(CORNERS, H_cv2) - true, axis=1).mean())
    share = agree / total
    print(f"find_homography vs cv2 on 60 sets ({total} points): masks agree on {share:.6f}; "
          f"mean four-corner error vs the true H {np.mean(corner_port):.4f} px (cv2 "
          f"{np.mean(corner_cv2):.4f} px)")
    assert share >= MASK_AGREEMENT_MIN
    assert np.mean(corner_port) <= np.mean(corner_cv2) + CORNER_SLACK_PX


def test_find_homography_degenerate_cases_and_determinism():
    x = np.linspace(0, 100, 10, dtype=np.float32)
    line = np.stack([x, 2 * x + 1], 1)
    H_cv2, _ = cv2.findHomography(line, line + 5, cv2.RANSAC)
    assert H_cv2 is None
    H_port, mask = find_homography(line, line + 5)
    assert H_port is None and mask.shape == (10,) and not mask.any()
    for n in (0, 3):  # cv2 raises below 4 points; the callers never reach it
        H_port, mask = find_homography(line[:n], line[:n])
        assert H_port is None and mask.shape == (n,)
    src, dst, _ = _match_set(3)
    first, again = find_homography(src, dst), find_homography(src, dst)
    np.testing.assert_array_equal(first[0], again[0])
    np.testing.assert_array_equal(first[1], again[1])
    # four points in general position: exact, all inliers
    quad = np.array([[10, 10], [200, 20], [30, 180], [250, 210]], np.float64)
    Hm = np.array([[1.05, 0.02, 3.0], [-0.01, 0.97, -2.0], [1e-4, -5e-5, 1.0]])
    H_port, mask = find_homography(quad, _warp(quad, Hm))
    assert mask.all()
    np.testing.assert_allclose(H_port, Hm, rtol=0, atol=1e-4)
