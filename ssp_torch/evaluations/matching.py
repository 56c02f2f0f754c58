"""The evaluation's matcher and its average precision, without OpenCV or
scikit-learn (the machine with the card has neither).

* :func:`bf_match_cross_check` is what ``cv2.BFMatcher(cv2.NORM_L2,
  crossCheck=True).match`` returns (``ssp/evaluations/descriptor.py``):
  mutual nearest neighbours under L2, in query order, ties to the lowest
  index in both directions, as OpenCV breaks them.
* :func:`average_precision` is ``sklearn.metrics.average_precision_score``
  for binary labels (``ssp/cli/evaluate.py::_nn_map``): one threshold per
  distinct score, AP = Σ (Rₙ − Rₙ₋₁)·Pₙ.

Host numpy in float64, as the rest of the evaluation protocol.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# rows whose Gram-formula distances lie this close (relative to the squared
# norms) to their minimum get their distances again as sums of squared
# differences: far above the float64 Gram formula's rounding, far below any
# gap the float32 descriptors can hold
_NEAR = 1e-9
_CHUNK = 64  # rows of exact differences per block: 64 × N2 × D float64 values


def _nearest(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each row of ``a`` the index of its nearest row of ``b`` (L2).

    The Gram formula ‖a‖² + ‖b‖² − 2a·b in float64 finds each row's
    candidates; where more than one lies near the minimum, the distances are
    summed from the differences, so exact duplicates tie exactly and the
    lowest index wins, as in OpenCV's loop."""
    na, nb = (a * a).sum(1), (b * b).sum(1)
    gram = na[:, None] + nb[None, :] - 2.0 * (a @ b.T)
    lo = gram.min(1)
    near = gram <= (lo + _NEAR * (na + nb.max() + 1.0))[:, None]
    idx = gram.argmin(1)
    rows = np.flatnonzero(near.sum(1) > 1)
    for start in range(0, len(rows), _CHUNK):
        block = rows[start:start + _CHUNK]
        d2 = ((a[block, None, :] - b[None, :, :]) ** 2).sum(-1)
        d2[~near[block]] = np.inf
        idx[block] = d2.argmin(1)
    return idx


def bf_match_cross_check(desc1: np.ndarray, desc2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cross-checked brute-force L2 matches of ``desc1 [N1, D]`` (queries)
    against ``desc2 [N2, D]`` (train): ``(query_idx, train_idx)``, int arrays
    in query order, where ``train_idx[k]`` is the nearest train row of query
    ``query_idx[k]`` and that query is the nearest of that train row.  The
    descriptors are read as float32, as OpenCV's matcher is given them."""
    a = np.asarray(desc1, np.float32).astype(np.float64)
    b = np.asarray(desc2, np.float32).astype(np.float64)
    if len(a) == 0 or len(b) == 0:
        empty = np.zeros((0,), np.int64)
        return empty, empty
    fwd = _nearest(a, b)
    back = _nearest(b, a)
    query = np.flatnonzero(back[fwd] == np.arange(len(a)))
    return query, fwd[query]


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """Average precision of binary ``labels`` ranked by ``scores`` (higher
    first), as scikit-learn computes it: the thresholds are the distinct
    scores in descending order, tied scores share one threshold, and AP is
    the sum over thresholds of the recall step times the precision there.
    At least one label must be positive."""
    y = np.asarray(labels).ravel().astype(bool)
    s = np.asarray(scores, np.float64).ravel()
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order]
    last = np.r_[np.flatnonzero(np.diff(s)), y.size - 1]  # last index of each distinct score
    tps = np.cumsum(y, dtype=np.float64)[last]
    fps = 1.0 + last - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    # scikit-learn sums from the lowest threshold up, with recall falling,
    # and clips the -0.0 that rounding can leave
    steps = np.diff(np.r_[recall[::-1], 0.0])
    return float(max(0.0, -np.sum(steps * precision[::-1])))
