"""Sequence-consistency evaluation of the SLAM lane (port of
``scripts/eval_sequence.py``).

Feeds per-frame keypoints and descriptors to what a SLAM front end depends
on: frame-to-frame mutual-match survival and multi-frame track statistics
(``PointTracker.get_tracks``), and, where the motion is known, whether the
matched coordinates follow it (the reprojection error under the relative
homography, every failure of 3 px or more split into a wrong association or
a missing candidate).

Usage::

  # an export_sequence prediction tree (host numpy only)
  python -m ssp_torch.cli.eval_sequence --pred logs/kitti384_seq/predictions \\
      [--rel-h-root datasets/KITTI_synth]

  # self-contained known-motion check on the trained weights
  python -m ssp_torch.cli.eval_sequence --synthetic [--ckpt evidence/wsem_weights.npz] \\
      [--n-classes 133] [--n-frames 8] [--size 240 320] [--device cpu]

``--synthetic`` draws a Synthetic Shapes scene (``ssp_torch.data.
synthetic_shapes``, byte for byte the JAX package's), moves it by a chain
of small seeded motions with OpenCV's ``warpPerspective`` reproduced
(``ssp_torch.data.raster.warp_perspective``), and detects and describes each
frame on ``--device`` (the card unless ``cpu``) with the fp32 module, as the
JAX tool runs fp32 flax.  The metrics are printed as one JSON object with
the JAX tool's keys (and written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ssp_torch.postprocess.tracker import PointTracker, nn_match_two_way

Frames = List[Tuple[np.ndarray, np.ndarray]]


def track_metrics(frames: Frames, *, nn_thresh: float = 0.7, max_length: int = 5,
                  min_pts: int = 4) -> Dict:
    """frames: (pts [N, 3], desc [N, D]) per frame, in order → survival
    rates and the track-length distribution."""
    tracker = PointTracker(max_length=max_length, nn_thresh=nn_thresh)
    survival, pts_per_frame, matches_per_pair = [], [], []
    for pts, desc in frames:
        pts_per_frame.append(len(pts))
        tracker.update(pts.T, desc.T)
        m = tracker.get_matches()
        if len(pts_per_frame) >= 2:
            denom = max(min(pts_per_frame[-2], pts_per_frame[-1]), 1)
            n = 0 if m is None else m.shape[1]
            matches_per_pair.append(n)
            survival.append(n / denom)
    lengths = (tracker.tracks[:, 2:] != -1).sum(axis=1)
    return {
        "n_frames": len(frames),
        "mean_pts_per_frame": float(np.mean(pts_per_frame)),
        "mean_matches_per_pair": float(np.mean(matches_per_pair)) if matches_per_pair else 0.0,
        "survival_mean": float(np.mean(survival)) if survival else 0.0,
        "survival_min": float(np.min(survival)) if survival else 0.0,
        "tracks_ge2": int((lengths >= 2).sum()),
        "tracks_full_window": int((lengths >= max_length).sum()),
        "track_length_hist": {k: int((lengths == k).sum()) for k in range(2, max_length + 1)},
    }


def reprojection_metrics(frames: Frames, rel_H: Sequence[np.ndarray],
                         nn_thresh: float = 0.7) -> Dict:
    """Each consecutive pair's matches moved by the known relative
    homography: the error against their next-frame coordinates, and each
    failure (≥ 3 px) split into ``fail_wrong_assoc`` (a detected point lay
    within 3 px of the projection, the descriptor matched another) and
    ``fail_no_candidate`` (none did); ``inlier_err_*`` the inliers' error."""
    errs, inlier3, inlier_errs = [], [], []
    wrong_assoc = no_candidate = 0
    for t in range(len(frames) - 1):
        (p1, d1), (p2, d2) = frames[t], frames[t + 1]
        if len(p1) < 4 or len(p2) < 4:
            continue
        m = nn_match_two_way(d1.T, d2.T, nn_thresh)
        if m.shape[1] == 0:
            continue
        x1 = p1[m[0].astype(int), :2]
        x2 = p2[m[1].astype(int), :2]
        h = np.concatenate([x1, np.ones((len(x1), 1))], axis=1) @ rel_H[t].T
        proj = h[:, :2] / h[:, 2:3]
        e = np.linalg.norm(proj - x2, axis=1)
        errs.append(e)
        inlier3.append(float((e < 3.0).mean()))
        inlier_errs.append(e[e < 3.0])
        fails = e >= 3.0
        if fails.any():
            nearest = np.linalg.norm(proj[fails][:, None, :] - p2[None, :, :2], axis=-1).min(axis=1)
            wrong_assoc += int((nearest < 3.0).sum())
            no_candidate += int((nearest >= 3.0).sum())
    allg = np.concatenate(errs) if errs else np.zeros((0,))
    inl = np.concatenate(inlier_errs) if inlier_errs else np.zeros((0,))
    n_fail = wrong_assoc + no_candidate
    out = {
        "reproj_pairs": len(errs),
        "reproj_matches": int(len(allg)),
        "reproj_median_px": float(np.median(allg)) if len(allg) else float("nan"),
        "reproj_inlier3_mean": float(np.mean(inlier3)) if inlier3 else 0.0,
        "fail_wrong_assoc": wrong_assoc,
        "fail_no_candidate": no_candidate,
        "fail_wrong_assoc_frac": wrong_assoc / n_fail if n_fail else 0.0,
    }
    if len(allg):
        out["reproj_cdf_px"] = {f"p{p}": float(np.percentile(allg, p)) for p in (50, 75, 90, 95)}
        out["inlier_at_px"] = {str(r): float((allg < r).mean()) for r in (1, 2, 3, 5)}
    if len(inl):
        out["inlier_err_median_px"] = float(np.median(inl))
        out["inlier_err_p90_px"] = float(np.percentile(inl, 90))
    return out


def load_pred_tree(pred: Path) -> Dict[str, Frames]:
    """{sequence directory: [(pts, desc), ...]}: one entry per leaf
    directory, so that tracks never chain across sequences."""
    seqs: Dict[str, Frames] = {}
    for f in sorted(Path(pred).rglob("*.npz")):
        with np.load(f) as z:
            seqs.setdefault(str(f.parent.relative_to(pred)), []).append((z["pts"], z["desc"]))
    return seqs


def synthetic_scene(size: Tuple[int, int], seed: int = 0, n_scenes: int = 1) -> np.ndarray:
    """The base frame: ``n_scenes`` polygon fields side by side (float32
    [h, w]), as the JAX tool draws it."""
    from ssp_torch.data.synthetic_shapes import generate_sample

    h, w = size
    tiles = [generate_sample("draw_multiple_polygons", size=(h, w // n_scenes),
                             seed=seed + 31 * s)[0] for s in range(n_scenes)]
    img = np.concatenate(tiles, axis=1)
    if img.shape != (h, w):  # the remainder of a ragged division
        img = np.pad(img, ((0, 0), (0, w - img.shape[1])))
    return img


def motion_chain(size: Tuple[int, int], n_frames: int, seed: int = 0):
    """(H_abs, rel_H): a smooth chain of small motions about the image
    centre (±2°, ×0.98-1.02, ±4 px), the JAX tool's draws."""
    h, w = size
    rng = np.random.default_rng(seed)

    def small_motion():
        th = np.radians(rng.uniform(-2.0, 2.0))
        s = rng.uniform(0.98, 1.02)
        tx, ty = rng.uniform(-4, 4, 2)
        T = np.array([[1, 0, -(w - 1) / 2], [0, 1, -(h - 1) / 2], [0, 0, 1.0]])
        M = np.array([[s * np.cos(th), -s * np.sin(th), tx], [s * np.sin(th), s * np.cos(th), ty],
                      [0, 0, 1.0]])
        return np.linalg.inv(T) @ M @ T

    H_abs = [np.eye(3)]
    for _ in range(n_frames - 1):
        H_abs.append(small_motion() @ H_abs[-1])
    rel_H = [H_abs[t + 1] @ np.linalg.inv(H_abs[t]) for t in range(n_frames - 1)]
    return H_abs, rel_H


def synthetic_images(size: Tuple[int, int], n_frames: int, seed: int = 0,
                     n_scenes: int = 1):
    """(frames [n, h, w] float32, rel_H): the base scene moved along
    :func:`motion_chain` by ``warpPerspective`` (bilinear)."""
    from ssp_torch.data.raster import warp_perspective

    h, w = size
    img = synthetic_scene(size, seed, n_scenes)
    H_abs, rel_H = motion_chain(size, n_frames, seed)
    return np.stack([warp_perspective(img, H, (w, h)) for H in H_abs]), rel_H


def make_synthetic_frames(ckpt, n_classes: int, *, n_frames: int = 8, size=(240, 320),
                          seed: int = 0, subpixel: bool = False, n_scenes: int = 1,
                          device="cuda"):
    """(frames: [(pts, desc)] per frame, rel_H): each frame of
    :func:`synthetic_images` detected and described by the fp32 module with
    the weights at ``ckpt`` (top 600, threshold 0.015, NMS 4)."""
    from ssp_torch._device import resolve_device
    from ssp_torch.export.descriptors_export import make_detect_describe_fn
    from ssp_torch.models.weights import load_weights

    dev = resolve_device(device)
    name = "SuperPointNet_gauss2_ssmall" if n_classes else "SuperPointNet_gauss2"
    model = load_weights(ckpt, name, {"n_classes": n_classes} if n_classes else {}, device=dev)
    dd = make_detect_describe_fn(model, device=dev, top_k=600, conf_thresh=0.015,
                                 nms_radius=4, subpixel=subpixel)
    images, rel_H = synthetic_images(tuple(size), n_frames, seed, n_scenes)
    frames = []
    for img in images:
        pts, valid, desc = (t.cpu().numpy() for t in dd(img))
        frames.append((pts[valid], desc[valid]))
    return frames, rel_H


def pred_metrics(pred: Path, nn_thresh: float = 0.7, rel_h_root: str = "") -> Dict:
    """The metrics of an ``export_sequence`` tree: per sequence, and their
    mean; with ``rel_h_root``, each ``<root>/<drive>/rel_H.json`` adds the
    reprojection metrics of its sequence."""
    seqs = load_pred_tree(Path(pred))
    if not seqs:
        raise FileNotFoundError(f"no frame npz under {pred}")
    per_seq = {name: track_metrics(frames, nn_thresh=nn_thresh) for name, frames in seqs.items()}
    if rel_h_root:
        for name, frames in seqs.items():
            rel_file = Path(rel_h_root) / Path(name).name / "rel_H.json"
            if rel_file.is_file():
                rel_H = [np.asarray(h) for h in json.loads(rel_file.read_text())]
                per_seq[name].update(reprojection_metrics(frames, rel_H, nn_thresh))
    keys = ("mean_pts_per_frame", "mean_matches_per_pair", "survival_mean", "survival_min")
    metrics = {k: float(np.mean([m[k] for m in per_seq.values()])) for k in keys}
    rep = [m["reproj_inlier3_mean"] for m in per_seq.values() if "reproj_inlier3_mean" in m]
    if rep:
        metrics["reproj_inlier3_mean"] = float(np.mean(rep))
        metrics["reproj_median_px"] = float(np.mean(
            [m["reproj_median_px"] for m in per_seq.values() if "reproj_median_px" in m]))
    metrics["n_sequences"] = len(per_seq)
    metrics["n_frames"] = int(sum(m["n_frames"] for m in per_seq.values()))
    metrics["per_sequence"] = per_seq
    metrics["mode"] = f"pred:{pred}"
    return metrics


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pred", help="export_sequence predictions dir")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--ckpt", default="evidence/wsem_weights.npz")
    ap.add_argument("--n-classes", type=int, default=133)
    ap.add_argument("--n-frames", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--n-scenes", type=int, default=1,
                    help="polygon fields tiled along W (about 4 at KITTI width, so that the "
                         "corner density matches the 240x320 case)")
    ap.add_argument("--subpixel", action="store_true",
                    help="soft-argmax refinement: against the default run it isolates the "
                         "NMS integer-grid quantization")
    ap.add_argument("--nn-thresh", type=float, default=0.7)
    ap.add_argument("--rel-h-root", default="",
                    help="dataset root holding <drive>/rel_H.json ground-truth motion for "
                         "--pred trees (make_kitti_tree --motion)")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.synthetic:
        frames, rel_H = make_synthetic_frames(
            args.ckpt, args.n_classes, n_frames=args.n_frames, size=tuple(args.size),
            subpixel=args.subpixel, n_scenes=args.n_scenes, device=args.device)
        metrics = track_metrics(frames, nn_thresh=args.nn_thresh)
        metrics.update(reprojection_metrics(frames, rel_H, args.nn_thresh))
        metrics["mode"] = "synthetic_known_motion"
        metrics["size"] = list(args.size)
        metrics["subpixel"] = bool(args.subpixel)
        metrics["ckpt"] = str(args.ckpt)
    elif args.pred:
        metrics = pred_metrics(Path(args.pred), args.nn_thresh, args.rel_h_root)
    else:
        ap.error("need --pred or --synthetic")

    print(json.dumps(metrics, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(metrics, indent=1))
    return metrics


if __name__ == "__main__":
    main()
