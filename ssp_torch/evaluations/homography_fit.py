"""A homography from point matches by RANSAC, without OpenCV: the port's
counterpart of ``cv2.findHomography(src, dst, cv2.RANSAC)``, which the
evaluation protocol calls (``ssp/evaluations/descriptor.py``,
``ssp/cli/evaluate.py``).

It takes OpenCV's defaults and OpenCV's steps:

* the points are read as float32, as OpenCV reads them;
* 4-point minimal sets, drawn from a generator made inside the call (so a
  call is deterministic and depends on no global state); an index already
  in the set is drawn again, and a degenerate set is passed over: three of
  its points collinear in either image, or the orientations of its point
  triples disagreeing between the images;
* each set is solved by a normalised DLT in float64 (the null vector of
  the 9×9 normal matrix of the centred, scaled equations);
* a point is an inlier when its squared forward reprojection error
  ‖dst − π(H·src)‖² is at most 3² px²;
* at most 2000 iterations, confidence 0.995: after each better model the
  count falls to log(1 − 0.995) / log(1 − w⁴), rounded, w the best
  inlier ratio so far;
* the model with the most inliers wins; ``H`` is fitted again to its
  inliers by the DLT, refined by Levenberg-Marquardt on their forward
  reprojection error and scaled to ``H[2, 2] = 1``;
* the mask returned is the inlier set of that refined ``H``.

The generator is OpenCV's ``cv::RNG`` (a multiply-with-carry generator
started from 2⁶⁴ − 1 in each call), and the sets are drawn from it in
OpenCV's order, with OpenCV's float32 error and tests, so a fit draws the
sets OpenCV draws: on the seeded match sets of
``tests/test_torch_evaluations.py`` the masks are OpenCV's, and ``H``
differs by what a converged Levenberg-Marquardt run and OpenCV's ten
iterations leave between them.  (The last step is OpenCV 5.0's: its mask
is the inlier set of its final ``H``, not the winning model's mask that
OpenCV 4 returned.)  Hypotheses are solved and scored in batches, walked in
the order drawn.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import least_squares

THRESHOLD = 3.0  # px, on the forward reprojection error
MAX_ITERS = 2000
CONFIDENCE = 0.995
_BATCH = 64  # sets drawn, then solved and scored together
_MAX_ATTEMPTS = 10000  # degenerate sets in a row before the search gives up
_FLT_EPSILON = float(np.finfo(np.float32).eps)
_DBL_MIN = float(np.finfo(np.float64).tiny)
_DBL_EPSILON = float(np.finfo(np.float64).eps)
# the point triples of a 4-point set, for the orientation test
_TRIPLES = np.array([[0, 1, 2], [1, 2, 3], [0, 2, 3], [0, 1, 3]])


class _Rng:
    """OpenCV's ``cv::RNG``: multiply-with-carry on a 64-bit state, started
    from 2⁶⁴ − 1 as its RANSAC starts it."""

    def __init__(self):
        self.state = (1 << 64) - 1

    def below(self, n: int) -> int:
        """A uniform integer in [0, n), as ``RNG::uniform(0, n)`` draws it."""
        self.state = (self.state & 0xFFFFFFFF) * 4164903690 + (self.state >> 32)
        return (self.state & 0xFFFFFFFF) % n


def _draw(rng: _Rng, n: int, size: int) -> np.ndarray:
    """The next ``size`` sets of 4 distinct indices below ``n``, an index
    that repeats one already in its set drawn again."""
    sets: List[List[int]] = []
    for _ in range(size):
        s: List[int] = []
        while len(s) < 4:
            i = rng.below(n)
            if i not in s:
                s.append(i)
        sets.append(s)
    return np.array(sets)


def _collinear(p: np.ndarray) -> np.ndarray:
    """[B, 4, 2] → [B]: the last point on a line through two of the others
    (``|cross| ≤ FLT_EPSILON`` · the sum of the edge components), the test
    OpenCV makes of each set as its last point joins it."""
    e = p[:, :3].astype(np.float64) - p[:, 3:]  # edges from the last point, [B, 3, 2]
    out = np.zeros(len(p), bool)
    for j, k in ((1, 0), (2, 0), (2, 1)):
        cross = e[:, k, 0] * e[:, j, 1] - e[:, k, 1] * e[:, j, 0]
        out |= np.abs(cross) <= _FLT_EPSILON * (np.abs(e[:, j]).sum(-1) + np.abs(e[:, k]).sum(-1))
    return out


def _orientation_consistent(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """[B]: every triple turns the same way in both images, or every triple
    turns the other way (a homography of a convex set keeps its order)."""
    def det(p):
        a, b, c = np.moveaxis(p[:, _TRIPLES].astype(np.float64), 2, 0)
        return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) \
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])

    negative = (det(src) * det(dst) < 0).sum(-1)
    return (negative == 0) | (negative == 4)


def _dlt(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Normalised DLT, batched: ``src, dst [B, n, 2]`` float64 → (``H [B, 3,
    3]`` with ``H[2, 2] = 1``, ``ok [B]``).  Each image's points are centred
    and scaled per axis by their mean absolute deviation, as OpenCV does."""
    cs, cd = src.mean(1, keepdims=True), dst.mean(1, keepdims=True)
    ss = np.abs(src - cs).mean(1, keepdims=True)
    sd = np.abs(dst - cd).mean(1, keepdims=True)
    ok = (ss > _DBL_EPSILON).all((1, 2)) & (sd > _DBL_EPSILON).all((1, 2))
    ss, sd = np.where(ss > 0, ss, 1.0), np.where(sd > 0, sd, 1.0)
    X, Y = np.moveaxis((src - cs) / ss, -1, 0)
    x, y = np.moveaxis((dst - cd) / sd, -1, 0)
    one, zero = np.ones_like(X), np.zeros_like(X)
    Lx = np.stack([X, Y, one, zero, zero, zero, -x * X, -x * Y, -x], -1)
    Ly = np.stack([zero, zero, zero, X, Y, one, -y * X, -y * Y, -y], -1)
    L = np.concatenate([Lx, Ly], 1)  # [B, 2n, 9]
    _, vecs = np.linalg.eigh(np.einsum("bki,bkj->bij", L, L))
    h = vecs[:, :, 0].reshape(-1, 3, 3)  # eigenvalues ascending: the null vector first
    B = len(src)
    t_src = np.zeros((B, 3, 3))
    t_src[:, 0, 0], t_src[:, 1, 1], t_src[:, 2, 2] = 1 / ss[:, 0, 0], 1 / ss[:, 0, 1], 1.0
    t_src[:, 0, 2], t_src[:, 1, 2] = -cs[:, 0, 0] / ss[:, 0, 0], -cs[:, 0, 1] / ss[:, 0, 1]
    t_dst = np.zeros((B, 3, 3))
    t_dst[:, 0, 0], t_dst[:, 1, 1], t_dst[:, 2, 2] = sd[:, 0, 0], sd[:, 0, 1], 1.0
    t_dst[:, 0, 2], t_dst[:, 1, 2] = cd[:, 0, 0], cd[:, 0, 1]
    H = t_dst @ h @ t_src
    scale = H[:, 2, 2]
    ok &= np.abs(scale) > _DBL_MIN
    H = H / np.where(ok, scale, 1.0)[:, None, None]
    return H, ok


def _inliers(H: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``H [B, 3, 3]`` (``H[2, 2] = 1``), float32 points [n, 2] → [B, n]
    inlier masks, the error computed in float32 as OpenCV computes it."""
    h = H.reshape(-1, 9).astype(np.float32)[:, :, None]
    x, y = src[:, 0], src[:, 1]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = np.float32(1) / (h[:, 6] * x + h[:, 7] * y + np.float32(1))
        dx = (h[:, 0] * x + h[:, 1] * y + h[:, 2]) * w - dst[:, 0]
        dy = (h[:, 3] * x + h[:, 4] * y + h[:, 5]) * w - dst[:, 1]
        return dx * dx + dy * dy <= np.float32(THRESHOLD * THRESHOLD)


def _iterations(inliers: int, count: int, current: int) -> int:
    """OpenCV's update of the iteration count (``RANSACUpdateNumIters``):
    the draws needed to see, with CONFIDENCE, one all-inlier set at the best
    inlier ratio so far, rounded to nearest; never more than ``current``."""
    all_inliers = 1.0 - (inliers / count) ** 4
    if all_inliers < _DBL_MIN:
        return 0
    num, denom = np.log(1.0 - CONFIDENCE), np.log(all_inliers)
    if denom >= 0 or -num >= current * -denom:
        return current
    return int(np.rint(num / denom))


def _refine(H: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Levenberg-Marquardt on the forward reprojection residuals of the
    inliers, over the 8 free entries (``H[2, 2] = 1``)."""
    x, y = src[:, 0], src[:, 1]

    def parts(h):
        u = h[0] * x + h[1] * y + h[2]
        v = h[3] * x + h[4] * y + h[5]
        w = h[6] * x + h[7] * y + 1.0
        return u, v, w

    def residuals(h):
        u, v, w = parts(h)
        return np.concatenate([u / w - dst[:, 0], v / w - dst[:, 1]])

    def jacobian(h):
        u, v, w = parts(h)
        iw, one, zero = 1.0 / w, np.ones_like(x), np.zeros_like(x)
        jx = np.stack([x, y, one, zero, zero, zero, -x * u * iw, -y * u * iw], 1) * iw[:, None]
        jy = np.stack([zero, zero, zero, x, y, one, -x * v * iw, -y * v * iw], 1) * iw[:, None]
        return np.concatenate([jx, jy], 0)

    h0 = H.reshape(-1)[:8]
    fit = least_squares(residuals, h0, jac=jacobian, method="lm")
    if not np.isfinite(fit.x).all() or fit.cost > 0.5 * np.sum(residuals(h0) ** 2):
        return H
    return np.append(fit.x, 1.0).reshape(3, 3)


def find_homography(src: np.ndarray, dst: np.ndarray) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """``src, dst [N, 2]`` (float32 or float64) → (``H [3, 3]`` float64 with
    ``H[2, 2] = 1``, mapping src to dst, or ``None``; ``inliers [N]`` bool).

    ``None`` (with no inlier) for fewer than 4 points, or when no
    non-degenerate set gives a model with 4 inliers or more."""
    src = np.asarray(src, np.float32).reshape(-1, 2)
    dst = np.asarray(dst, np.float32).reshape(-1, 2)
    n = len(src)
    none = (None, np.zeros(n, bool))
    if n < 4:
        return none
    s64, d64 = src.astype(np.float64), dst.astype(np.float64)
    rng = _Rng()
    niters, it, failed = MAX_ITERS, 0, 0
    best, best_H = 3, None  # a model needs 4 inliers or more
    while it < niters and failed < _MAX_ATTEMPTS:
        idx = _draw(rng, n, _BATCH)
        valid = ~_collinear(src[idx]) & ~_collinear(dst[idx]) \
            & _orientation_consistent(src[idx], dst[idx])
        H, ok = _dlt(s64[idx[valid]], d64[idx[valid]])
        counts = np.where(ok, _inliers(H, src, dst).sum(1), 0)
        k = 0
        for v in valid:  # the sets in the order drawn, as the one-at-a-time loop takes them
            if not v:
                failed += 1
                if failed >= _MAX_ATTEMPTS:
                    break
                continue
            failed = 0
            if it >= niters:
                break
            it += 1
            if counts[k] > best:
                best, best_H = int(counts[k]), H[k]
                niters = _iterations(best, n, niters)
            k += 1
    if best_H is None:
        return none
    if n == 4:  # the minimal set itself: no refit, as in OpenCV
        return best_H, np.ones(4, bool)
    mask = _inliers(best_H[None], src, dst)[0]
    H, ok = _dlt(s64[mask][None], d64[mask][None])
    H = _refine(H[0] if ok[0] else best_H, s64[mask], d64[mask])
    H = H / H[2, 2]
    return H, _inliers(H[None], src, dst)[0]
