"""Synthetic geometric shapes with ground-truth interest points (port of
``ssp/data/synthetic_shapes.py``).

Nine named primitives drawn on a blob background, each returning the image
and the (x, y) corner/junction points a keypoint detector should fire on;
``draw_ellipses`` and ``gaussian_noise`` are negatives (no points).
``generate_sample(prim, size, seed)`` is a pure function of its arguments
and gives the JAX package's samples exactly: the same draws from the same
seeded ``np.random.Generator`` (seeded by ``zlib.crc32``), the same numpy
dtypes at every step, and OpenCV's drawing and filtering reproduced byte
for byte by :mod:`ssp_torch.data.raster` (C++, no OpenCV).  Shapes are drawn
at 2x supersampling, blurred, and area-downsampled.  Generation runs on the
host, once per corpus (``synthetic_dataset.py`` caches it); the card never
sees it.
"""

from __future__ import annotations

import math
import zlib
from typing import List, Tuple

import numpy as np

from ssp_torch.data import raster
from ssp_torch.data.base import resize_area

PRIMITIVES: List[str] = [
    "draw_lines",
    "draw_polygon",
    "draw_multiple_polygons",
    "draw_ellipses",
    "draw_star",
    "draw_checkerboard",
    "draw_stripes",
    "draw_cube",
    "gaussian_noise",
]

_EMPTY = np.zeros((0, 2), np.float32)


def _contrast_color(rng: np.random.Generator, background: float, min_dist: int = 30) -> int:
    """A random grayscale value at least ``min_dist`` away from
    ``background`` (shapes must be visible against it)."""
    c = int(rng.integers(0, 256))
    if abs(c - background) < min_dist:
        c = (c + 128) % 256
    return c


def _background(rng: np.random.Generator, shape: Tuple[int, int]) -> np.ndarray:
    """Blurred random-blob background (uint8)."""
    H, W = shape
    img = (rng.uniform(0, 1, (H, W)) > rng.uniform(0.2, 0.8)).astype(np.uint8) * 255
    mean = float(img.mean())
    dim = max(H, W)
    n_blobs = 30
    cx = rng.integers(0, W, n_blobs)
    cy = rng.integers(0, H, n_blobs)
    for i in range(n_blobs):
        rad = int(rng.integers(max(int(dim * 0.01), 1), max(int(dim * 0.05), 2)))
        raster.circle_filled(img, (int(cx[i]), int(cy[i])), rad, _contrast_color(rng, mean))
    k = int(rng.integers(dim // 8 | 1, dim // 3 | 1)) | 1
    return raster.blur(img, k)


def _keep_inside(points: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Drop points outside [0, W-1] × [0, H-1] (points are (x, y))."""
    if len(points) == 0:
        return _EMPTY
    H, W = shape
    ok = (
        (points[:, 0] >= 0)
        & (points[:, 0] <= W - 1)
        & (points[:, 1] >= 0)
        & (points[:, 1] <= H - 1)
    )
    return points[ok].astype(np.float32)


def _rand_thickness(rng, min_dim, lo=0.01, hi=0.02) -> int:
    return max(int(rng.integers(max(int(min_dim * lo), 1), max(int(min_dim * hi), 2))), 1)


# ---------------------------------------------------------------- lines
def _segments_cross(segs: np.ndarray, p1, p2) -> bool:
    """Any existing segment [N, 4] properly intersects (p1, p2)?"""
    if len(segs) == 0:
        return False
    a, b = segs[:, 0:2], segs[:, 2:4]
    c = np.asarray(p1, float)[None]
    d = np.asarray(p2, float)[None]

    def ccw(p, q, r):
        return (r[:, 1] - p[:, 1]) * (q[:, 0] - p[:, 0]) > (
            (q[:, 1] - p[:, 1]) * (r[:, 0] - p[:, 0])
        )

    return bool(
        np.any((ccw(a, c, d) != ccw(b, c, d)) & (ccw(a, b, c) != ccw(a, b, d)))
    )


def draw_lines(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Random pairwise-non-crossing segments; points = the endpoints."""
    H, W = img.shape
    mean = float(img.mean())
    n = int(rng.integers(1, 10))
    segs = np.zeros((0, 4))
    pts = []
    for _ in range(n):
        x1, x2 = rng.integers(0, W, 2)
        y1, y2 = rng.integers(0, H, 2)
        if _segments_cross(segs, (x1, y1), (x2, y2)):
            continue
        segs = np.concatenate([segs, [[x1, y1, x2, y2]]], axis=0)
        raster.line(
            img, (int(x1), int(y1)), (int(x2), int(y2)),
            _contrast_color(rng, mean), _rand_thickness(rng, min(H, W)),
        )
        pts += [[x1, y1], [x2, y2]]
    return np.asarray(pts, np.float32) if pts else _EMPTY


# -------------------------------------------------------------- polygons
def _sample_polygon(rng: np.random.Generator, shape, rad_frac=0.5):
    """Corner points of a random star-convex polygon inside the image.

    Corners are sampled on per-sector angles at radius ≥ 0.4·rad from a
    random center; near-collinear corners (angle ≥ 120°) are dropped so
    every returned corner is a genuine detector target.
    """
    H, W = shape
    min_dim = min(H, W)
    rad = max(rng.uniform() * min_dim * rad_frac, min_dim / 10)
    x = rng.integers(int(rad), int(W - rad))
    y = rng.integers(int(rad), int(H - rad))
    n = int(rng.integers(3, 8))
    sector = 2 * math.pi / n
    angles = np.arange(n) * sector + rng.uniform(0, sector, n)
    r = np.maximum(rng.uniform(0, 1, n), 0.4) * rad
    corners = np.stack(
        [x + r * np.cos(angles), y + r * np.sin(angles)], axis=1
    ).astype(np.int64)
    # drop flat corners: interior angle must be < 2π/3
    keep = []
    for i in range(len(corners)):
        v1 = corners[i - 1] - corners[i]
        v2 = corners[(i + 1) % len(corners)] - corners[i]
        n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
        if n1 < 1e-6 or n2 < 1e-6:
            continue
        ang = math.acos(np.clip(np.dot(v1, v2) / (n1 * n2), -1.0, 1.0))
        if ang < 2 * math.pi / 3:
            keep.append(i)
    corners = corners[keep]
    return (corners, np.array([x, y], float), rad) if len(corners) >= 3 else (None, None, None)


def draw_polygon(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """One filled polygon; points = its corners."""
    for _ in range(16):  # bounded retry replaces the reference's recursion
        corners, _, _ = _sample_polygon(rng, img.shape)
        if corners is not None:
            break
    else:
        return _EMPTY
    raster.fill_poly(img, corners.reshape(-1, 2).astype(np.int32),
                     _contrast_color(rng, float(img.mean())))
    return corners.astype(np.float32)


def draw_multiple_polygons(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Several polygons with disjoint bounding circles; points = all
    corners.  Each face is textured with its own blob background (the
    interior must not be flat, or the detector learns "uniform region ⇒
    no keypoint" instead of cornerness)."""
    H, W = img.shape
    centers: List[np.ndarray] = []
    rads: List[float] = []
    pts = []
    for _ in range(20):
        corners, center, rad = _sample_polygon(rng, img.shape, rad_frac=0.35)
        if corners is None:
            continue
        if any(np.linalg.norm(center - c) < rad + r for c, r in zip(centers, rads)):
            continue
        centers.append(center)
        rads.append(rad)
        mask = np.zeros_like(img)
        raster.fill_poly(mask, corners.reshape(-1, 2).astype(np.int32), 255)
        texture = _background(rng, img.shape)
        img[mask != 0] = texture[mask != 0]
        pts.append(corners)
    return (
        np.concatenate(pts, axis=0).astype(np.float32) if pts else _EMPTY
    )


# ------------------------------------------------------------- negatives
def draw_ellipses(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Filled ellipses — smooth contours, zero interest points."""
    H, W = img.shape
    quarter = min(H, W) / 4
    mean = float(img.mean())
    centers = np.zeros((0, 2))
    rads: List[float] = []
    for _ in range(20):
        ax = int(max(rng.uniform() * quarter, quarter / 5))
        ay = int(max(rng.uniform() * quarter, quarter / 5))
        r = max(ax, ay)
        x = rng.integers(r, W - r)
        y = rng.integers(r, H - r)
        if len(centers) and np.any(
            np.linalg.norm(centers - [x, y], axis=1) < r + np.asarray(rads)
        ):
            continue
        centers = np.concatenate([centers, [[x, y]]], axis=0)
        rads.append(r)
        raster.ellipse_filled(
            img, (int(x), int(y)), (ax, ay), float(rng.uniform(0, 90)),
            _contrast_color(rng, mean),
        )
    return _EMPTY


def gaussian_noise(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Pure noise image — zero interest points."""
    img[:] = rng.integers(0, 256, img.shape, dtype=np.uint8)
    return _EMPTY


# ------------------------------------------------------------------ star
def draw_star(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Lines radiating from a center; points = center + branch tips."""
    H, W = img.shape
    min_dim = min(H, W)
    mean = float(img.mean())
    n = int(rng.integers(3, 6))
    rad = max(rng.uniform() * min_dim / 2, min_dim / 5)
    x = rng.integers(int(rad), int(W - rad))
    y = rng.integers(int(rad), int(H - rad))
    sector = 2 * math.pi / n
    angles = np.arange(n) * sector + rng.uniform(0, sector, n)
    r = np.maximum(rng.uniform(0, 1, n), 0.3) * rad
    tips = np.stack([x + r * np.cos(angles), y + r * np.sin(angles)], 1).astype(int)
    thickness = _rand_thickness(rng, min_dim)
    for tx, ty in tips:
        raster.line(img, (int(x), int(y)), (int(tx), int(ty)),
                    _contrast_color(rng, mean), thickness)
    return np.concatenate([[[x, y]], tips], axis=0).astype(np.float32)


# ------------------------------------------------------ warped grids
def _random_plane_warp(rng: np.random.Generator, shape, strength=(0.05, 0.15)):
    """Random affine ∘ mild-perspective warp of image coordinates, as a
    function points [N, 2] → warped [N, 2]."""
    H, W = shape
    alpha = max(H, W) * (strength[0] + rng.uniform() * strength[1])
    c = np.float32([W, H]) / 2
    s = min(H, W) / 3
    src = np.float32([c + s, [c[0] + s, c[1] - s], c - s, [c[0] - s, c[1] + s]])
    A = raster.affine_transform(
        src[:3], src[:3] + rng.uniform(-alpha, alpha, (3, 2)).astype(np.float32))
    P = raster.perspective_transform(
        src, src + rng.uniform(-alpha / 2, alpha / 2, (4, 2)).astype(np.float32))

    def apply(pts: np.ndarray) -> np.ndarray:
        q = pts @ A[:, :2].T + A[:, 2]
        qh = np.concatenate([q, np.ones((len(q), 1))], axis=1) @ P.T
        return qh[:, :2] / qh[:, 2:]

    return apply


def draw_checkerboard(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Perspective-warped checkerboard; points = the grid nodes."""
    H, W = img.shape
    mean = float(img.mean())
    rows = int(rng.integers(3, 7))
    cols = int(rng.integers(3, 7))
    s = min((W - 1) // cols, (H - 1) // rows)
    gx, gy = np.meshgrid(np.arange(cols + 1), np.arange(rows + 1))
    nodes = np.stack([gx.ravel(), gy.ravel()], axis=1) * s  # row-major (x, y)
    warp = _random_plane_warp(rng, img.shape)
    nodes = warp(nodes.astype(np.float64))
    grid = nodes.reshape(rows + 1, cols + 1, 2)

    colors = np.zeros((rows, cols), np.int32)
    for i in range(rows):
        for j in range(cols):
            # contrast against the already-chosen neighbours
            prev = []
            if i:
                prev.append(colors[i - 1, j])
            if j:
                prev.append(colors[i, j - 1])
            col = int(rng.integers(0, 256))
            for _ in range(20):
                if not prev or np.all(np.abs(np.asarray(prev) - col) >= 50):
                    break
                col = int(rng.integers(0, 256))
            colors[i, j] = col
            quad = np.stack(
                [grid[i, j], grid[i, j + 1], grid[i + 1, j + 1], grid[i + 1, j]]
            ).astype(np.int32)
            raster.fill_convex_poly(img, quad, int(col))

    # random emphasised grid lines (the reference draws a few, :451-474)
    thickness = _rand_thickness(rng, min(H, W), 0.01, 0.015)
    for _ in range(int(rng.integers(2, rows + 2))):
        r = int(rng.integers(0, rows + 1))
        c1, c2 = rng.integers(0, cols + 1, 2)
        raster.line(img, tuple(grid[r, c1].astype(int)), tuple(grid[r, c2].astype(int)),
                    _contrast_color(rng, mean), thickness)
    for _ in range(int(rng.integers(2, cols + 2))):
        c = int(rng.integers(0, cols + 1))
        r1, r2 = rng.integers(0, rows + 1, 2)
        raster.line(img, tuple(grid[r1, c].astype(int)), tuple(grid[r2, c].astype(int)),
                    _contrast_color(rng, mean), thickness)
    return _keep_inside(nodes, img.shape)


def draw_stripes(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Perspective-warped stripes; points = stripe-boundary endpoints."""
    H, W = img.shape
    board_h = int(H * (1 + rng.uniform()))
    board_w = int(W * (1 + rng.uniform()))
    n = int(rng.integers(5, 13))
    xs = np.unique(
        np.concatenate([[0, board_w - 1], rng.uniform(0, board_w, n - 1)]).astype(int)
    )
    min_width = min(H, W) * 0.04
    xs = xs[np.diff(np.concatenate([xs, [board_w + int(min_width)]])) >= min_width]
    if len(xs) < 2:
        return _EMPTY
    top = np.stack([xs, np.zeros_like(xs)], axis=1)
    bot = np.stack([xs, np.full_like(xs, board_h - 1)], axis=1)
    nodes = np.concatenate([top, bot], axis=0).astype(np.float64)
    warp = _random_plane_warp(rng, img.shape)
    nodes = warp(nodes)
    k = len(xs)
    color = int(rng.integers(0, 256))
    for i in range(k - 1):
        color = (color + 128 + int(rng.integers(-30, 30))) % 256
        quad = np.stack(
            [nodes[i], nodes[i + 1], nodes[k + i + 1], nodes[k + i]]
        ).astype(np.int32)
        raster.fill_convex_poly(img, quad, color)
    mean = float(img.mean())
    thickness = _rand_thickness(rng, min(H, W), 0.01, 0.015)
    for _ in range(int(rng.integers(2, 5))):
        row = int(rng.integers(0, 2)) * k
        i1, i2 = rng.integers(0, k, 2)
        raster.line(img, tuple(nodes[row + i1].astype(int)),
                    tuple(nodes[row + i2].astype(int)),
                    _contrast_color(rng, mean), thickness)
    for _ in range(int(rng.integers(2, k + 1))):
        i = int(rng.integers(0, k))
        raster.line(img, tuple(nodes[i].astype(int)), tuple(nodes[k + i].astype(int)),
                    _contrast_color(rng, mean), thickness)
    return _keep_inside(nodes, img.shape)


# ------------------------------------------------------------------ cube
def draw_cube(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """2D projection of a randomly rotated box; points = the 7 visible
    corners.

    Corners are bit-indexed (vertex b ↔ side selection by the bits of
    b), so the three faces adjacent to the all-ones corner are the
    index sets with one bit forced — visibility falls out of the
    construction instead of a face-enumeration table.
    """
    H, W = img.shape
    min_dim = min(H, W)
    sides = min_dim * 0.2 + rng.uniform(0, 1, 3) * 2 * min_dim / 3
    # vertices: bit b_k of the index selects 0 or side_k on axis k
    idx = np.arange(8)
    bits = np.stack([(idx >> k) & 1 for k in range(3)], axis=1)  # [8, 3]
    verts = bits * sides[None, :]

    ax, ay, az = rng.uniform(math.pi / 10, math.pi / 10 + 0.3 * math.pi, 3)

    def rot(a, i, j):
        R = np.eye(3)
        R[i, i] = R[j, j] = math.cos(a)
        R[i, j], R[j, i] = -math.sin(a), math.sin(a)
        return R

    R = rot(ax, 0, 1) @ rot(ay, 1, 2) @ rot(az, 0, 2)
    scale = np.diag(rng.uniform(0.4, 1.0, 3))
    t = np.array([
        W * 0.5 + rng.uniform(-0.2, 0.2) * W,
        H * 0.5 + rng.uniform(-0.2, 0.2) * H,
        0.0,
    ])
    proj = (verts @ R.T @ scale.T + t)[:, :2].astype(int)

    # corner 0 is hidden behind corner 7 by the rotation-range
    # construction; the three visible faces each contain corner 7
    faces = [
        [7, 7 ^ 1, 7 ^ 1 ^ 2, 7 ^ 2],  # z = side_z plane
        [7, 7 ^ 2, 7 ^ 2 ^ 4, 7 ^ 4],  # x = side_x plane
        [7, 7 ^ 4, 7 ^ 4 ^ 1, 7 ^ 1],  # y = side_y plane
    ]
    face_col = _contrast_color(rng, float(img.mean()))
    for f in faces:
        raster.fill_poly(img, proj[f].reshape(-1, 2).astype(np.int32), face_col)
    thickness = _rand_thickness(rng, min_dim, 0.003, 0.015)
    for f in faces:
        for a, b in zip(f, f[1:] + f[:1]):
            edge_col = (face_col + 128 + int(rng.integers(-64, 64))) % 256
            raster.line(img, tuple(proj[a]), tuple(proj[b]), edge_col, thickness)
    return _keep_inside(proj[1:].astype(np.float32), img.shape)


_DRAW_FNS = {
    "draw_lines": draw_lines,
    "draw_polygon": draw_polygon,
    "draw_multiple_polygons": draw_multiple_polygons,
    "draw_ellipses": draw_ellipses,
    "draw_star": draw_star,
    "draw_checkerboard": draw_checkerboard,
    "draw_stripes": draw_stripes,
    "draw_cube": draw_cube,
    "gaussian_noise": gaussian_noise,
}

SUPERSAMPLE = 2


def generate_sample(
    primitive: str,
    size: Tuple[int, int] = (240, 320),
    seed: int = 0,
    blur_size: int = 11,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (image [H, W] float32 ∈ [0, 1], points [N, 2] (x, y)) sample.

    Deterministic in ``(primitive, size, seed)``.  Shapes are drawn at
    ``SUPERSAMPLE``× resolution on a blob background, blurred, and
    area-downsampled; points are scaled to the output grid and clipped
    to it.
    """
    if primitive not in _DRAW_FNS:
        raise KeyError(f"unknown primitive {primitive!r}; known: {PRIMITIVES}")
    H, W = int(size[0]), int(size[1])
    # zlib.crc32, NOT hash(): str hashes are salted per process
    # (PYTHONHASHSEED), which would silently break the documented
    # determinism contract and the seeded npz cache across runs
    rng = np.random.default_rng(
        np.random.SeedSequence(
            [zlib.crc32(primitive.encode()) & 0x7FFFFFFF, H, W, int(seed)]
        )
    )
    big = (H * SUPERSAMPLE, W * SUPERSAMPLE)
    img = _background(rng, big)
    pts = _DRAW_FNS[primitive](rng, img)

    b = max(int(blur_size) | 1, 3)
    img = raster.gaussian_blur(img, b)
    small = resize_area(img, (H, W))
    if len(pts):
        # pixel-center-correct downsample mapping: big-canvas coordinate
        # b lands at (b + 0.5)/S − 0.5 on the output grid (a plain b/S
        # would bias every label by +0.25 px at S=2)
        pts = _keep_inside((pts + 0.5) / SUPERSAMPLE - 0.5, (H, W))
    else:
        pts = _EMPTY
    return small.astype(np.float32) / 255.0, pts
