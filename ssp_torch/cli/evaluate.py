"""Evaluation CLI (port of ``ssp/cli/evaluate.py``; reference
``evaluation.py``).

Usage::

  python -m ssp_torch.cli.evaluate <predictions_dir> [-r] [-homo] [-o]

Reads the exported ``<i>.npz`` pair files, computes repeatability /
localization error (top-1000, dist 3), homography-estimation correctness
at ε ∈ [1, 3, 5, 10, 20, 50], matching score and NN mAP, then writes
``result.txt`` and ``result.npz`` into the predictions directory
(reference ``evaluation.py:86-499``).  The arithmetic is host numpy, as in
the JAX package; OpenCV's matcher and RANSAC and scikit-learn's average
precision are the port's own (``ssp_torch/evaluations``), and the RANSAC
fit is called through its module, so a test can put OpenCV's in its place.

``-o/--outputImg`` also draws each pair (``ssp_torch.utils.draw``, OpenCV's
drawing reproduced) into ``repeatibility3/<i>_{1,2}.png`` (the keypoints of
each image) and ``matching/<i>.png`` (the match lines, where the file has
``matches``) beside the files, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict, List

import numpy as np

from ssp_torch.data.imageio import write_png
from ssp_torch.evaluations import homography_fit
from ssp_torch.evaluations.descriptor import compute_homography
from ssp_torch.evaluations.detector import compute_repeatability, warp_keypoints_np
from ssp_torch.evaluations.matching import average_precision
from ssp_torch.postprocess.tracker import PointTracker

log = logging.getLogger(__name__)

HOMOGRAPHY_THRESH = [1, 3, 5, 10, 20, 50]
TOP_K = 1000
REP_THRESH = 3
MAP_NN_THRESH = 1.2


def _unwarp_count(warped_keypoints: np.ndarray, H: np.ndarray, shape_hw) -> int:
    """#image-2 keypoints whose unwarp lands inside image 1 — the N2'
    of the matching score (``evaluation.py:194-219``)."""
    if len(warped_keypoints) == 0:
        return 0
    un = warp_keypoints_np(warped_keypoints[:, :2], np.linalg.inv(H))
    ok = (
        (un[:, 0] >= 0) & (un[:, 0] <= shape_hw[1] - 1)
        & (un[:, 1] >= 0) & (un[:, 1] <= shape_hw[0] - 1)
    )
    return int(ok.sum())


def _nn_map(data: Dict[str, np.ndarray]) -> float:
    """NN mAP: mutual-NN matches (thresh 1.2) → RANSAC inliers as labels,
    flipped distances as scores → average precision
    (``evaluation.py:224-330``)."""
    kp1, kp2 = data["prob"], data["warped_prob"]
    d1, d2 = data["desc"], data["warped_desc"]
    if len(kp1) < 4 or len(kp2) < 4:
        return 0.0
    tracker = PointTracker(max_length=2, nn_thresh=MAP_NN_THRESH)
    tracker.update(kp1.T, d1.T)
    tracker.update(kp2.T, d2.T)
    matches = tracker.get_matches()
    mscores = tracker.get_mscores()
    if matches is None or matches.shape[1] < 4:
        return 0.0
    m = matches.T  # [L, 4]
    _, inliers = homography_fit.find_homography(m[:, :2], m[:, 2:4])
    if inliers is None:
        return 0.0
    inliers = np.asarray(inliers).ravel().astype(bool)
    if inliers.sum() == 0:
        return 0.0
    dist = mscores[2]
    scores = dist.max() - dist
    return average_precision(inliers, scores)


def _save_visuals(path: Path, stem: str, data: Dict[str, np.ndarray]) -> None:
    """Keypoint overlays and the match drawing of one pair (reference
    ``evaluation.py`` --outputImg: the repeatibility and matching dirs)."""
    from ssp_torch.utils.draw import draw_keypoints, draw_matches

    rep_dir = path / "repeatibility3"
    match_dir = path / "matching"
    rep_dir.mkdir(exist_ok=True)
    match_dir.mkdir(exist_ok=True)
    img1 = data["image"][..., 0] if data["image"].ndim == 3 else data["image"]
    img2 = (
        data["warped_image"][..., 0]
        if data["warped_image"].ndim == 3
        else data["warped_image"]
    )
    write_png(rep_dir / f"{stem}_1.png", draw_keypoints(img1, data["prob"]))
    write_png(rep_dir / f"{stem}_2.png", draw_keypoints(img2, data["warped_prob"]))
    if "matches" in data and len(data["matches"]):
        canvas = draw_matches(img1, data["prob"], img2, data["warped_prob"], data["matches"])
        write_png(match_dir / f"{stem}.png", canvas)


def evaluate(
    path: Path, do_rep: bool = True, do_homo: bool = True, output_img: bool = False
) -> Dict[str, float]:
    """Score every pair file under ``path``; write ``result.txt`` and
    ``result.npz`` there (and, with ``output_img``, the drawings) and return
    the summary.  The JAX package's ``np.random.seed(0)`` is left out:
    nothing here draws from numpy's global generator (the RANSAC fit seeds
    its own)."""
    # exported pairs use digit stems (sorted numerically, as the reference
    # does); any other .npz is still evaluated, appended in name order
    all_npz = [p for p in Path(path).glob("*.npz") if p.name != "result.npz"]
    numbered = sorted((p for p in all_npz if p.stem.isdigit()),
                      key=lambda p: int(p.stem))
    named = sorted((p for p in all_npz if not p.stem.isdigit()),
                   key=lambda p: p.name)
    files = numbered + named
    if not files:
        raise FileNotFoundError(f"no .npz predictions under {path}")

    rep: List[float] = []
    loc: List[float] = []
    correctness: List[List[float]] = []
    mscore: List[float] = []
    maps: List[float] = []
    names: List[str] = []

    skipped = 0
    for f in files:
        with np.load(f) as z:
            data = {k: z[k] for k in z.files}
        if "prob" not in data or "homography" not in data:
            log.warning("skipping %s: not an exported pair file", f.name)
            skipped += 1
            continue
        names.append(f.name)
        shape_hw = data["image"].shape[:2]
        shape2_hw = data["warped_image"].shape[:2] if "warped_image" in data else shape_hw
        H = data["homography"]
        if output_img:
            _save_visuals(Path(path), f.stem, data)
        if do_rep:
            r = compute_repeatability(
                data["prob"], data["warped_prob"], H, shape_hw,
                keep_k_points=TOP_K, distance_thresh=REP_THRESH,
                shape2_hw=shape2_hw,
            )
            rep.append(r["repeatability"])
            loc.append(r["localization_err"])
        if do_homo:
            res = compute_homography(
                data["prob"], data["desc"], data["warped_prob"], data["warped_desc"],
                H, shape_hw, correctness_thresh=HOMOGRAPHY_THRESH,
            )
            correctness.append(res["correctness"])
            n2p = _unwarp_count(data["warped_prob"], H, shape_hw)
            denom = len(data["prob"]) + n2p
            mscore.append(2.0 * res["inliers"].sum() / denom if denom else 0.0)
            maps.append(_nn_map(data))

    summary: Dict[str, float] = {"n_files": len(files) - skipped}
    if do_rep:
        summary["repeatability"] = float(np.mean(rep))
        summary["localization_err"] = float(np.mean(loc))
    if do_homo:
        corr = np.mean(np.array(correctness), axis=0)
        for eps, c in zip(HOMOGRAPHY_THRESH, corr):
            summary[f"correctness_{eps}"] = float(c)
        summary["matching_score"] = float(np.mean(mscore))
        summary["nn_map"] = float(np.mean(maps))

    with open(Path(path) / "result.txt", "w") as f:
        for k, v in summary.items():
            f.write(f"{k}: {v}\n")
        # per-file detail block — reference ``evaluation.py:468-482``
        # (verbose section of result.txt: one line per pair)
        f.write("====== details =====\n")
        for i, name in enumerate(names):
            line = f"file: {name}"
            if do_rep:
                line += f"; rep: {rep[i]}"
            if do_homo:
                line += f"; correct: {np.asarray(correctness[i])}"
                line += f"; mscore: {mscore[i]}"
                line += f":, mean AP: {maps[i]}"
            f.write(line + "\n")
        f.write("======== end ========\n")
    payload = dict(summary)
    if do_rep:
        payload["repeatability_per_file"] = np.asarray(rep)
        payload["localization_err_per_file"] = np.asarray(loc)
    if do_homo:
        payload["correctness_per_file"] = np.asarray(correctness)
        payload["mscore_per_file"] = np.asarray(mscore)
        payload["mAP_per_file"] = np.asarray(maps)
    payload["files"] = np.asarray(names)
    np.savez(Path(path) / "result.npz", **payload)
    return summary


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="ssp_torch evaluation")
    ap.add_argument("path", help="predictions directory of <i>.npz files")
    ap.add_argument("-r", "--repeatibility", action="store_true")
    ap.add_argument("-homo", "--homography", action="store_true")
    ap.add_argument("-o", "--outputImg", action="store_true")
    args = ap.parse_args(argv)
    do_rep = args.repeatibility or not args.homography
    do_homo = args.homography or not args.repeatibility
    summary = evaluate(Path(args.path), do_rep, do_homo, output_img=args.outputImg)
    for k, v in summary.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
