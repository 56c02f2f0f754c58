"""Visualisation helpers on the host, without OpenCV (port of
``ssp/utils/draw.py``; reference ``utils/draw.py``).

Image grids, keypoint overlays, match drawings, channel-overlap composites
and the tracks of a :class:`~ssp_torch.postprocess.tracker.PointTracker`
(reference ``models/model_wrap.py:617-649``).  The drawings are byte for byte
the JAX package's, which draws with OpenCV 5.0: ``cvtColor(GRAY2BGR)``
replicates the gray channel, ``resize(INTER_NEAREST)`` is
``ssp_torch.data.coco.resize_nearest``, filled circles and ``LINE_AA`` lines
are ``ssp_torch.data.raster``'s (C++).  Colours are BGR tuples and canvases
BGR, as OpenCV's; ``ssp_torch.data.imageio.write_png`` writes them as
``cv2.imwrite`` does.  :func:`plot_imgs` needs matplotlib, imported when
called.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ssp_torch.data import raster
from ssp_torch.data.coco import resize_nearest


def to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def gray_to_bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)`` of a uint8 [H, W] image."""
    return np.repeat(img[..., None], 3, axis=-1)


def img_overlap(img_r: np.ndarray, img_g: np.ndarray, img_gray: np.ndarray) -> np.ndarray:
    """Red/green channel overlay on a gray base (reference semantics)."""
    base = np.stack([img_gray] * 3, axis=-1).astype(np.float32)
    base[..., 0] += img_r
    base[..., 1] += img_g
    return np.clip(base, 0.0, 1.0)


def draw_keypoints(img: np.ndarray, pts: np.ndarray, radius: int = 3, color=(0, 255, 0),
                   scale: int = 1) -> np.ndarray:
    """pts: [N, ≥2] (x, y).  Returns a BGR uint8 image (optionally upscaled
    by ``scale`` like the reference's s=3 rendering)."""
    out = gray_to_bgr(to_u8(img))
    if scale != 1:
        out = resize_nearest(out, (out.shape[0] * scale, out.shape[1] * scale))
    out = np.ascontiguousarray(out)
    for x, y in np.asarray(pts)[:, :2]:
        raster.circle_color(out, (int(round(x * scale)), int(round(y * scale))), radius, color)
    return out


def draw_matches(img1: np.ndarray, pts1: np.ndarray, img2: np.ndarray, pts2: np.ndarray,
                 matches: np.ndarray, max_draw: int = 200) -> np.ndarray:
    """matches: [L, 4] (x1, y1, x2, y2) — side-by-side match lines, each in
    a colour drawn from ``np.random.default_rng(0)``."""
    a = gray_to_bgr(to_u8(img1))
    b = gray_to_bgr(to_u8(img2))
    H = max(a.shape[0], b.shape[0])
    canvas = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    rng = np.random.default_rng(0)
    for x1, y1, x2, y2 in np.asarray(matches)[:max_draw]:
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        raster.line_aa(canvas, (int(x1), int(y1)), (int(x2) + off, int(y2)), color)
    return canvas


def plot_imgs(imgs: Sequence[np.ndarray], titles: Optional[List[str]] = None,
              path: Optional[str] = None, cmap: str = "gray"):
    """Grid plot; saves to ``path`` when given (headless-safe)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_imgs needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(imgs)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    if n == 1:
        axes = [axes]
    titles = list(titles or [])
    titles += [""] * (n - len(titles))  # zip would silently drop images
    for ax, img, title in zip(axes, imgs, titles):
        ax.imshow(img, cmap=cmap)
        ax.set_title(title)
        ax.axis("off")
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig


def draw_tracks(out: np.ndarray, tracker, min_length: int = 2) -> np.ndarray:
    """Overlay the surviving tracks on a BGR uint8 image (C-contiguous, drawn
    in place) from the tracker's stored per-frame points (reference
    ``draw_tracks``)."""
    tracks = tracker.get_tracks(min_length)
    offsets = np.cumsum([0] + [p.shape[1] for p in tracker.all_pts[:-1]])
    for track in tracks:
        for i in range(tracker.maxl - 1):
            id1, id2 = int(track[i + 2]), int(track[i + 3])
            if id1 < 0 or id2 < 0:
                continue
            p1 = tracker.all_pts[i][:2, id1 - int(offsets[i])]
            p2 = tracker.all_pts[i + 1][:2, id2 - int(offsets[i + 1])]
            raster.line_aa(out, (int(round(p1[0])), int(round(p1[1]))),
                           (int(round(p2[0])), int(round(p2[1]))), (0, 255, 0))
            raster.circle_color(out, (int(round(p2[0])), int(round(p2[1]))), 2, (255, 0, 0))
    return out
