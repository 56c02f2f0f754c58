"""Host-side native ops (port of the ops half of ``ssp/native/__init__.py``):
the exact greedy NMS of the evaluation protocol, a bilinear inverse warp and
two-way nearest-neighbour matching, in C++ (``ssp_torch/csrc/ops_host.cpp``).

The library is built with the system ``g++`` at first use into
``ssp_torch/_build`` (``ssp_torch.kernels._build``, a ``HOST_SOURCES``
entry); its calls go through ``ctypes``, which releases the GIL.  Unlike the
JAX package's module, nothing falls back to numpy: a failed build raises.

Beside each op is its plain version with the same semantics
(:func:`greedy_nms_plain`, :func:`inv_warp_bilinear_plain`,
:func:`nn_match_two_way_plain`), which the tests and ``chip_smoke.py`` hold
the C++ against.  Each reproduces the C++ arithmetic operation for
operation, so they agree exactly.  The greedy NMS visits the points in the
order of ``std::sort``, which is not stable: tied scores (common in real
heatmaps) come out in an order that the algorithm of GCC's libstdc++ sets,
and which decides between tied neighbours.  The plain version therefore
sorts with that algorithm (:func:`std_sort`) in Python, not with numpy's.
"""

from __future__ import annotations

import ctypes

import numpy as np


def _lib() -> ctypes.CDLL:
    from ssp_torch.kernels import _build

    lib = _build.load("ops_host")
    if not getattr(lib, "_ssp_typed", False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.ssp_greedy_nms.restype = i64
        lib.ssp_greedy_nms.argtypes = [ptr, i64, i64, i64, ctypes.c_float, ptr]
        lib.ssp_inv_warp_bilinear.restype = None
        lib.ssp_inv_warp_bilinear.argtypes = [ptr, i64, i64, ptr, ptr]
        lib.ssp_nn_match_two_way.restype = None
        lib.ssp_nn_match_two_way.argtypes = [ptr, i64, ptr, i64, i64, ptr, ptr, ptr]
        lib._ssp_typed = True
    return lib


def _map2d(a, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2:
        raise ValueError(f"{what} must be [H, W], got shape {a.shape}")
    return a


def _homography(H_mat) -> np.ndarray:
    Hm = np.ascontiguousarray(H_mat, np.float64)
    if Hm.shape != (3, 3):
        raise ValueError(f"the homography must be [3, 3], got shape {Hm.shape}")
    return Hm


def _descriptors(desc1, desc2):
    d1 = np.ascontiguousarray(desc1, np.float32)
    d2 = np.ascontiguousarray(desc2, np.float32)
    if d1.ndim != 2 or d2.ndim != 2 or d1.shape[1] != d2.shape[1]:
        raise ValueError(f"descriptors must be [N1, D] and [N2, D], got {d1.shape} and "
                         f"{d2.shape}")
    return d1, d2


def _matches(idx: np.ndarray, dist: np.ndarray, mutual: np.ndarray,
             nn_thresh: float) -> np.ndarray:
    keep = mutual & (dist < nn_thresh)
    rows = np.flatnonzero(keep)
    return np.stack([rows.astype(float), idx[keep].astype(float), dist[keep].astype(float)])


def greedy_nms(scores, dist: int, min_score: float = 0.0) -> np.ndarray:
    """Exact greedy grid NMS of ``scores [H, W]`` → bool keep mask [H, W]:
    points by descending score, each kept iff no kept point lies within
    Chebyshev distance ``dist``; scores below ``min_score`` or not above 0
    are never kept."""
    s = _map2d(scores, "scores")
    H, W = s.shape
    keep = np.zeros((H, W), np.uint8)
    _lib().ssp_greedy_nms(s.ctypes.data, H, W, int(dist), ctypes.c_float(min_score),
                          keep.ctypes.data)
    return keep.astype(bool)


def inv_warp_bilinear(img, H_mat) -> np.ndarray:
    """``img [H, W]`` sampled bilinearly (zeros outside) at ``H_mat``'s image
    of each output pixel, coordinates normalised to [-1, 1] with aligned
    corners, in double; float32 [H, W]."""
    im = _map2d(img, "img")
    Hm = _homography(H_mat)
    H, W = im.shape
    out = np.zeros_like(im)
    _lib().ssp_inv_warp_bilinear(im.ctypes.data, H, W, Hm.ctypes.data, out.ctypes.data)
    return out


def nn_match_two_way_native(desc1, desc2, nn_thresh: float) -> np.ndarray:
    """Mutual nearest neighbours of unit-norm ``desc1 [N1, D]`` and
    ``desc2 [N2, D]`` → matches [3, L] (index 1, index 2, distance
    sqrt(2 − 2·cos)), those with a distance under ``nn_thresh``: the layout of
    ``ssp_torch.postprocess.tracker.nn_match_two_way``."""
    d1, d2 = _descriptors(desc1, desc2)
    n1, D = d1.shape
    n2 = d2.shape[0]
    if n1 == 0 or n2 == 0:
        return np.zeros((3, 0))
    idx = np.zeros(n1, np.int32)
    dist = np.zeros(n1, np.float32)
    mutual = np.zeros(n1, np.uint8)
    _lib().ssp_nn_match_two_way(d1.ctypes.data, n1, d2.ctypes.data, n2, D, idx.ctypes.data,
                                dist.ctypes.data, mutual.ctypes.data)
    return _matches(idx, dist, mutual == 1, nn_thresh)


# ---- the plain versions ----------------------------------------------------------

_THRESHOLD = 16  # libstdc++'s _S_threshold


def std_sort(a: list, before) -> None:
    """Sort the list ``a`` in place as libstdc++'s ``std::sort(first, last,
    comp)`` does with ``comp(x, y) = before(x, y)``: an introsort of depth
    2·⌊log2 n⌋ (the median of three moved to the front, an unguarded
    partition, a heap sort past the depth) over runs longer than 16, then an
    insertion sort.  Elements that compare equal end in the same order as in
    the C++ (``bits/stl_algo.h``, ``bits/stl_heap.h``)."""
    n = len(a)
    if n:
        _introsort_loop(a, 0, n, 2 * (n.bit_length() - 1), before)
        _final_insertion_sort(a, 0, n, before)


def _introsort_loop(a, first, last, depth, before):
    while last - first > _THRESHOLD:
        if depth == 0:
            _make_heap(a, first, last, before)  # __partial_sort(first, last, last)
            while last - first > 1:  # __sort_heap
                last -= 1
                _pop_heap(a, first, last, last, before)
            return
        depth -= 1
        mid = first + (last - first) // 2
        _move_median_to_first(a, first, first + 1, mid, last - 1, before)
        cut = _unguarded_partition(a, first + 1, last, first, before)
        _introsort_loop(a, cut, last, depth, before)
        last = cut


def _move_median_to_first(a, result, i, j, k, before):
    if before(a[i], a[j]):
        m = j if before(a[j], a[k]) else (k if before(a[i], a[k]) else i)
    elif before(a[i], a[k]):
        m = i
    else:
        m = k if before(a[j], a[k]) else j
    a[result], a[m] = a[m], a[result]


def _unguarded_partition(a, first, last, pivot, before):
    while True:
        while before(a[first], a[pivot]):
            first += 1
        last -= 1
        while before(a[pivot], a[last]):
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _final_insertion_sort(a, first, last, before):
    if last - first > _THRESHOLD:
        _insertion_sort(a, first, first + _THRESHOLD, before)
        for i in range(first + _THRESHOLD, last):
            _unguarded_linear_insert(a, i, before)
    else:
        _insertion_sort(a, first, last, before)


def _insertion_sort(a, first, last, before):
    for i in range(first + 1, last):
        if before(a[i], a[first]):
            a[first + 1:i + 1], a[first] = a[first:i], a[i]
        else:
            _unguarded_linear_insert(a, i, before)


def _unguarded_linear_insert(a, last, before):
    val = a[last]
    while before(val, a[last - 1]):
        a[last] = a[last - 1]
        last -= 1
    a[last] = val


def _make_heap(a, first, last, before):
    n = last - first
    if n < 2:
        return
    for parent in range((n - 2) // 2, -1, -1):
        _adjust_heap(a, first, parent, n, a[first + parent], before)


def _pop_heap(a, first, last, result, before):
    value = a[result]
    a[result] = a[first]
    _adjust_heap(a, first, 0, last - first, value, before)


def _adjust_heap(a, first, hole, n, value, before):
    top = child = hole
    while child < (n - 1) // 2:
        child = 2 * (child + 1)
        if before(a[first + child], a[first + child - 1]):
            child -= 1
        a[first + hole] = a[first + child]
        hole = child
    if n % 2 == 0 and child == (n - 2) // 2:
        child = 2 * (child + 1)
        a[first + hole] = a[first + child - 1]
        hole = child - 1
    parent = (hole - 1) // 2  # __push_heap
    while hole > top and before(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def greedy_nms_plain(scores, dist: int, min_score: float = 0.0) -> np.ndarray:
    """:func:`greedy_nms` in Python and numpy, the points visited in
    :func:`std_sort`'s order, tied scores included."""
    s = _map2d(scores, "scores")
    H, W = s.shape
    flat = s.reshape(-1)
    order = np.flatnonzero((flat >= np.float32(min_score)) & (flat > 0)).tolist()
    key = flat.tolist()
    std_sort(order, lambda x, y: key[x] > key[y])
    keep = np.zeros((H, W), bool)
    suppressed = np.zeros((H, W), bool)
    for i in order:
        y, x = divmod(int(i), W)
        if suppressed[y, x]:
            continue
        keep[y, x] = True
        suppressed[max(0, y - dist):y + dist + 1, max(0, x - dist):x + dist + 1] = True
    return keep


def inv_warp_bilinear_plain(img, H_mat) -> np.ndarray:
    """:func:`inv_warp_bilinear` in numpy float64, in the C++ order of
    operations."""
    im = _map2d(img, "img")
    Hm = _homography(H_mat).reshape(-1)
    H, W = im.shape
    sx, sy = (W - 1) / 2.0, (H - 1) / 2.0
    ny = (np.arange(H, dtype=np.float64) / sy - 1.0)[:, None]
    nx = (np.arange(W, dtype=np.float64) / sx - 1.0)[None, :]
    w = Hm[6] * nx + Hm[7] * ny + Hm[8]
    u = (Hm[0] * nx + Hm[1] * ny + Hm[2]) / w
    v = (Hm[3] * nx + Hm[4] * ny + Hm[5]) / w
    fx, fy = (u + 1.0) * sx, (v + 1.0) * sy
    with np.errstate(invalid="ignore"):
        x0, y0 = np.floor(fx).astype(np.int64), np.floor(fy).astype(np.int64)
    wx, wy = fx - x0, fy - y0
    acc = np.zeros((H, W), np.float64)
    for dy in (0, 1):
        for dx in (0, 1):
            xx, yy = x0 + dx, y0 + dy
            inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            wgt = (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy)
            val = im[np.where(inside, yy, 0), np.where(inside, xx, 0)].astype(np.float64)
            acc = np.where(inside, acc + wgt * val, acc)
    return acc.astype(np.float32)


def nn_match_two_way_plain(desc1, desc2, nn_thresh: float) -> np.ndarray:
    """:func:`nn_match_two_way_native` in numpy: the similarities summed in
    float32 in index order (not by a BLAS product, which sums in another
    order), the first index of equal similarities on either side."""
    d1, d2 = _descriptors(desc1, desc2)
    if d1.shape[0] == 0 or d2.shape[0] == 0:
        return np.zeros((3, 0))
    sim = np.zeros((d1.shape[0], d2.shape[0]), np.float32)
    for k in range(d1.shape[1]):
        sim += d1[:, k, None] * d2[None, :, k]
    idx = np.argmax(sim, axis=1)
    best = sim[np.arange(len(idx)), idx]
    back = np.argmax(sim, axis=0)
    clipped = np.minimum(np.maximum(best, np.float32(-1.0)), np.float32(1.0))
    dist = np.sqrt(np.maximum(np.float32(2.0) - np.float32(2.0) * clipped, np.float32(0.0)))
    mutual = back[idx] == np.arange(len(idx))
    return _matches(idx.astype(np.int32), dist, mutual, nn_thresh)
