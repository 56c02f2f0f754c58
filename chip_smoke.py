"""Smoke run of the PyTorch port (``ssp_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA card, the
CUDA toolkit and PyTorch built for CUDA.  It imports nothing of JAX and
nothing of the JAX package ``ssp``.  Phases, each of which raises on
failure (nothing is caught):

1. the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from ``ssp_torch/csrc`` (one ``nvcc`` per
   source) and the host image decoder (``imageio_host.cpp``, ``g++``), all
   started together, and prints the build seconds of each;
3. the main path: the trained weights of ``evidence/wsem_weights.npz``
   loaded as ``SuperPointNet_gauss2``, detect+describe at 480×640, B=16,
   K=1000 through ``ssp_torch.bench.build_pipeline``.  Every kernel's
   launch count is set to 0 just before the run and read just after; each
   must have launched.  Keypoints and descriptors are held against the
   same pipeline on the kernels' plain PyTorch versions; img/s is timed
   with CUDA events after warm-up;
4. each kernel against its plain version on the main path's own inputs
   (stem: the images; down1: the stem's output; NMS: the heatmap) and at
   an odd size, 120×168: stem and down1 within
   ``ssp_torch.kernels.stem.assert_bf16_close``, NMS exactly;
5. ``SuperPointNet_gauss2_ssmall`` (semantic head) at 2×480×640: the
   folded bf16 forward against the port's fp32 ``nn.Module`` with TF32
   off;
6. the folded convs of down2, down3 and the heads: each accumulator
   against an fp32 conv with TF32 off, within 2⁻¹⁴·max|want|;
7. the homography-adaptation (HA) export path at its reference setting: 8
   structured images at 240×320, 100 warps each, top-600, NMS 4, subpixel,
   through ``make_ha_fn(best_apply_fn(...))`` with a seeded generator.
   The two-pass warp runs on its default route, the coef route (the
   resample kernel rebuilds its coordinates from 20 scalars per warp).
   Every launch count is set to 0 before and read after; the coef resample,
   stem, down1 and NMS kernels must each have launched.  The keypoints are
   held against the same path on the kernels' plain versions; img/s by
   CUDA events and by the host clock; the folded forward is timed against
   the fp32 module at 100×240×320;
8. ``run_ha_export``: 16 images in groups of 8 written, a second call
   writes none, and a directory with half the files removed is refilled
   with byte-identical points;
9. the rows route (``COEF_GRIDS`` off: coordinate grids built with tensor
   ops) at 2 images × 20 warps: the rows kernel launches and the coef kernel
   does not, keypoints against the coef route, and both routes' times for
   the full 800-warp stack;
10. the resample kernels against their plain versions on the HA path's own
    inputs (the 800-warp stack over 8 shared images, one chunk's 100
    heatmaps, both axes), with planted coordinates of −10, ±1e9, ±inf, NaN
    and exactly S−1, and through the whole two-pass warp at 120×168;
11. each kernel's time at its path's shapes beside its plain version's,
    one library call of the same function (a cuDNN composition for the
    convs, ``F.grid_sample`` for the resamples) and its bound on this card;
    the stem and down1 also at the HA path's chunk (100×240×320 into the
    stem, 100×120×160×64 into down1), each held against its plain version
    there within the bf16 bars before it is timed, and NMS at the HA
    group's 8×240×320, held exactly first;
12. ``[hpatches]``, the stage-4 HPatches descriptor export: a synthetic
    HPatches tree (16 sequences, two views each, binary P6 at 600×800, so
    the 240×320 resize takes the 2.5× area path), exported by
    ``ssp_torch.cli.export.export_descriptor`` with ``HPATCHES_CONFIG``
    (``configs/pipeline240_sweep_wsem.yaml`` with the trained weights):
    ``SuperPointNet_gauss2_ssmall``, 133 classes, K=1000, NMS 4, subpixel,
    two-way matching.  Launch counts are set to 0 before the export and read
    after: the stem, down1 and NMS twice per pair (one image per call); a
    second call writes nothing.  The same export on the kernels' plain
    versions: each pair's written (refined) points within SAME_PX of the
    plain ones, and the detections of every image (subpixel off, all K
    points) with the main path's bars; pairs/s by the host clock with the
    share of host work (decode and resize, matching and npz writes),
    detect+describe ms per image at 1×240×320 and at the sequence export's
    1×384×1248 by CUDA events, and the three kernels' times at 1×240×320
    beside their bounds;
13. ``[evaluate]``, the stage-4 evaluation and checkpoint sweep on phase
    12's corpus: both of its exports through ``ssp_torch.cli.evaluate.
    evaluate`` (every column side by side, host seconds per pair and the
    RANSAC fit's share), the kernels' export a second time (an equal
    ``result.npz``: the fit is deterministic), and the kernels against the
    plain versions within ``EVAL_BARS`` (repeatability, matching score and
    NN mAP within 0.03 absolute, localization error within 0.05 px, each
    ``correctness_ε`` within 3 of the 32 pairs).  Then
    ``ssp_torch.cli.export_eval.sweep`` over a folder of
    ``superPointNet_1000.npz`` and ``superPointNet_2000.npz`` (the trained
    weights) and ``superPointNet_1500_checkpoint.pth.tar`` (a state dict
    without ``convDb.bias``): launch counts set to 0 before and read after,
    the stem, down1 and NMS 2 × 32 pairs × 2 readable checkpoints each and
    no resample kernel; rows 1000 and 2000 equal to each other and to the
    evaluation of phase 12's export, row 1500 zeros, both CSV headers the
    JAX package's; seconds per checkpoint by part.  Last, MagicLeap
    SuperPoint (``SuperPointNet_pretrained``, seeded weights): its forward
    at 1×240×320 on the card with TF32 off within ``ML_ATOL`` of the CPU,
    an ``export_descriptor`` of 4 pairs (NMS twice per pair, no stem or
    down1), detect+describe ms/image by CUDA events;
14. ``[imageio]``, the host decoder on a machine without OpenCV: every
    fixture of ``tests/data/torch_imageio`` decodes to the hash of OpenCV's
    decode in its ``manifest.json``; seeded 375×1242 RGB and 240×320 gray
    frames written by :func:`write_png` (each row's filter cycling through
    0-4) read back exactly; ms per image of decoding by the host clock;
15. ``[sequence]``, the SLAM sequence export: a KITTI tree under
    ``SSP_DATA_PATH`` (2 drives × 16 structured 375×1242 color PNG frames)
    through ``ssp_torch.cli.export.export_sequence`` with
    ``SEQUENCE_CONFIG`` (``configs/kitti384_sequence_r5.yaml``: ssmall-133,
    the trained weights, 384×1248, the enlarging resize, K=1000, NMS 4).
    Launch counts from 0: the stem, down1 and NMS once per frame; a second
    call writes nothing.  The same export on the kernels' plain versions,
    each frame held with the main path's bars (``agreement``); frames/s by
    the host clock with ms/frame by part (decode and resize, detect+describe,
    npz write); the stem, down1 and NMS at 1×384×1248 beside their bounds,
    each held against its plain version first;
16. ``[ha_cli]``, stage-2 pseudo-labels: the JPEG fixtures under 16
    twelve-digit names in ``SSP_DATA_PATH/COCO/train2017`` through
    ``export_detector_homoAdapt`` with ``HA_CLI_CONFIG``
    (``configs/magicpoint_coco_export.yaml`` with the trained weights:
    ``SuperPointNet_gauss2``, 100 warps, ``sum``, top-600, NMS 4, subpixel),
    one image per call.  Launch counts from 0, per image: the stem, down1
    and NMS once, ``vresample_coef`` 4 times.  The layout
    (``predictions/train2017/<stem>.npz``, ``export.txt``), a second call
    that writes nothing, the points against the same export on the plain
    versions (≥ SHARED_MIN within SAME_PX), img/s by the host clock with the
    decode's share.

Prints a ``{"kernels": [...]}`` line (each row also with the launches of
phase 12's export, ``launches_export``, of phase 13's sweep,
``launches_sweep``, of phases 15 and 16, ``launches_sequence`` and
``launches_ha_cli``, and for the stem, down1 and NMS their times at
1×240×320, ``export_1x240x320``, and at 1×384×1248,
``sequence_1x384x1248``), then the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ssp_torch.bench import (BATCH, BORDER, NMS_RADIUS, TOP_K, H, W, build_pipeline,
                             structured_images)
from ssp_torch import bench_ha
from ssp_torch.cli.export import export_descriptor, export_detector_homoAdapt, export_sequence
from ssp_torch.core.grid import flatten_detection
from ssp_torch.core.homography import inv3, sample_homographies
from ssp_torch.core.warp import inv_warp_image
from ssp_torch.data import imageio
from ssp_torch.data.base import write_pnm
from ssp_torch.data.coco import CocoDataset
from ssp_torch.data.hpatches import PatchesDataset
from ssp_torch.data.kitti import KittiDataset
from ssp_torch.export.descriptors_export import (make_detect_describe_fn, run_descriptor_export,
                                                 run_sequence_export)
from ssp_torch.export.homography_adaptation import DEFAULT_HA, make_ha_fn, run_ha_export
from ssp_torch.kernels import _build
from ssp_torch.kernels import down1 as down1_mod
from ssp_torch.kernels import nms as nms_mod
from ssp_torch.kernels import stem as stem_mod
from ssp_torch.kernels import vresample as vres_mod
from ssp_torch.kernels import warp_twopass
from ssp_torch.models.fast_infer import (accumulator_errors, best_apply_fn, fold_variables,
                                         make_fast_apply)
from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import load_flax_npz, read_state_dict

ROOT = Path(__file__).resolve().parent
NPZ = ROOT / "evidence" / "wsem_weights.npz"
ODD_HW = (120, 168)
SEED = 0

# the stage-4 export: configs/pipeline240_sweep_wsem.yaml with the trained
# weights (as configs/kitti384_sequence_r5.yaml names them), a dict so that
# the smoke needs no PyYAML; tests/test_torch_config.py holds it to the file
HPATCHES_CONFIG = {
    "data": {"name": "patches_dataset", "dataset": "hpatches", "alteration": "all",
             "preprocessing": {"resize": [240, 320]}},
    "front_end_model": "Val_model_heatmap",
    "model": {"name": "SuperPointNet_gauss2_ssmall", "params": {"n_classes": 133},
              "folder": "logs/pipeline240_wsem/checkpoints", "detection_threshold": 0.015,
              "batch_size": 1, "eval_batch_size": 1, "nms": 4, "top_k": 1000, "nn_thresh": 1.0,
              "subpixel": {"enable": True, "patch_size": 5}},
    "pretrained": "evidence/wsem_weights.npz",
}
# the SLAM sequence export: configs/kitti384_sequence_r5.yaml (its root and
# split list are pointed at the smoke's tree); the stage-2 HA export:
# configs/magicpoint_coco_export.yaml with the trained weights
SEQUENCE_CONFIG = {
    "data": {"dataset": "Kitti_inh", "export_folder": "train", "root": "datasets/KITTI_synth",
             "root_split_txt": "datasets/KITTI_synth", "preprocessing": {"resize": [384, 1248]},
             "augmentation": {"photometric": {"enable": False}}},
    "front_end_model": "Val_model_heatmap",
    "model": {"name": "SuperPointNet_gauss2_ssmall", "params": {"n_classes": 133},
              "batch_size": 1, "detection_threshold": 0.015, "nms": 4, "top_k": 1000},
    "pretrained": "evidence/wsem_weights.npz",
}
HA_CLI_CONFIG = {
    "data": {"dataset": "Coco", "export_folder": "train", "preprocessing": {"resize": [240, 320]},
             "augmentation": {"photometric": {"enable": False}},
             "homography_adaptation": {
                 "enable": True, "num": 100, "aggregation": "sum", "filter_counts": 0,
                 "homographies": {"params": {
                     "translation": True, "rotation": True, "scaling": True, "perspective": True,
                     "scaling_amplitude": 0.2, "perspective_amplitude_x": 0.2,
                     "perspective_amplitude_y": 0.2, "allow_artifacts": True,
                     "patch_ratio": 0.85}}}},
    "model": {"name": "SuperPointNet_gauss2", "params": {}, "batch_size": 1, "eval_batch_size": 1,
              "detection_threshold": 0.015, "nms": 4, "top_k": 600,
              "subpixel": {"enable": True, "patch_size": 5}},
    "pretrained": "evidence/wsem_weights.npz",
}
HP_SEQ, HP_VIEWS, HP_RAW = 16, (2, 3), (600, 800)
# the decoder's fixtures, made with OpenCV, each with the hash of its decode
FIXTURES = ROOT / "tests" / "data" / "torch_imageio"
KITTI_RAW = (375, 1242)  # a KITTI color frame
SEQ_DRIVES, SEQ_FRAMES = 2, 16  # the sequence corpus: 2 drives of 16 frames
HA_CLI_IMAGES = 16  # the stage-2 corpus: the JPEG fixtures under 16 COCO names  # the corpus: 32 pairs at HPatches' size
SLAM_HW = (384, 1248)  # the SLAM sequence export's shape (configs/kitti384_sequence_r5.yaml)

# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 outside the tensor cores, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# main-path agreement with the plain path on the card: the kernels differ
# from their plain versions only by flipped bf16 roundings (NMS is exact),
# which reorder near-tied scores; the bars of the JAX package's own
# keypoint-agreement test (90% shared) and descriptor test (cosine 0.999)
SHARED_MIN = 0.9
COS_MIN = 0.999
STRONG = 0.015  # reference confidence threshold ...
STRONG_RECALL_MIN = 0.95  # ... of whose points this share is found at the same pixel
# bf16 folded forward against the fp32 module: max error over max |value|
# of semi and sem (the JAX package's sem bar: ten layers of bf16 rounding),
# and the descriptor cosine bar above
REL_MAX = 0.05
# a folded conv's accumulator against an fp32 conv with TF32 off: exact
# products summed in fp32 in another order differ by a few 2⁻²⁴ of the sum of
# magnitudes; an accumulator rounded to bf16 is off by 2⁻⁹ of the value
ACC_MAX = 2.0 ** -14
# phase 13: the evaluation of the export on the kernels against that of the
# export on their plain versions, 32 pairs.  The two exports share ~94% of
# their refined points (phase 12 prints the share), so the columns move by a
# few points or matches: repeatability, matching score and NN mAP within 0.03 absolute,
# localization error within 0.05 px, each correctness_ε within 3 of the 32
# pairs.  A bar that fails is a finding, not a bar to widen.
EVAL_BARS = {"repeatability": 0.03, "matching_score": 0.03, "nn_map": 0.03,
             "localization_err": 0.05, "correctness_pairs": 3}
# MagicLeap SuperPoint on the card against the CPU, TF32 off: fp32 sums in
# another order, the fp32 forward bar of the port's parity tests
ML_ATOL = 2e-4
# resample kernels against their plain versions, as a share of max|img|:
# both are fp32 blends of the same two taps, (1−f)·v0 + f·v1; the kernel may
# contract the sum to one FMA (one rounding fewer, half an ulp of the result)
VRES_TOL = 1e-6
# HA keypoints, kernels against plain versions with the same homographies: a
# refined point counts as the same when a plain-path point lies within half a
# pixel; the share bar is SHARED_MIN, for the reason given there
SAME_PX = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, flop_peak: float, nbytes: float):
    """(least ms for the work on this card, what bounds it)."""
    t_ops, t_bytes = flops / flop_peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def agreement(pts, desc, ref_pts, ref_desc) -> dict:
    """Keypoint agreement and descriptor cosine of two [B, K, 3] / [B, K, D]
    results, the worst image of each; raises if below the bars."""
    worst = {"shared": 1.0, "strong_recall": 1.0, "cos": 1.0}
    for b in range(pts.shape[0]):
        got = {(int(x), int(y)): i for i, (x, y, s) in enumerate(pts[b].tolist()) if s > 0}
        want = {(int(x), int(y)): i for i, (x, y, s) in enumerate(ref_pts[b].tolist()) if s > 0}
        strong = [xy for xy, i in want.items() if ref_pts[b, i, 2] >= STRONG]
        recall = sum(xy in got for xy in strong) / max(len(strong), 1)
        shared = set(got) & set(want)
        frac = len(shared) / max(len(got), len(want), 1)
        if not strong or recall < STRONG_RECALL_MIN or frac < SHARED_MIN:
            raise AssertionError(f"image {b}: {len(strong)} plain-path points over {STRONG}, "
                                 f"{recall:.4f} of them found; {frac:.4f} of all shared")
        gi = torch.tensor([got[xy] for xy in shared], device=desc.device)
        wi = torch.tensor([want[xy] for xy in shared], device=desc.device)
        cos = float((desc[b, gi] * ref_desc[b, wi]).sum(-1).min())
        worst = {"shared": min(worst["shared"], frac),
                 "strong_recall": min(worst["strong_recall"], recall),
                 "cos": min(worst["cos"], cos)}
    if worst["cos"] < COS_MIN:
        raise AssertionError(f"descriptor cosine {worst['cos']} < {COS_MIN}")
    return worst


def cudnn_pair(x_nhwc: torch.Tensor, w1, b1, w2, b2, pool: bool = True) -> torch.Tensor:
    """The same function as one cuDNN composition: conv (BN scale folded
    into the weights, bias in the conv) → ReLU → conv → ReLU (→ 2×2 max),
    bf16 channels-last.  Timed beside the kernel, used nowhere in the port."""
    x = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2)
    y = F.relu(F.conv2d(x, w1, b1, padding=1))
    y = F.relu(F.conv2d(y, w2, b2, padding=1))
    return F.max_pool2d(y, 2) if pool else y


def grid_sample_1d(src: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The resample as one library call: ``F.grid_sample`` (bilinear, zero
    padding, align_corners) of ``src [N, 1, R, C]`` (one image per warp,
    expanded beforehand) with the other coordinate set to the identity.
    ``grid`` comes from :func:`resample_grid`.  Timed beside the kernels,
    used nowhere in the port."""
    return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def resample_grid(coords: torch.Tensor, axis: int, L: int) -> torch.Tensor:
    """Pixel coordinates along ``axis`` → the normalised [N, R, C, 2] (x, y)
    grid of :func:`grid_sample_1d`."""
    N, R, C = coords.shape
    moving = coords.clamp(-2.0, L + 1.0) * (2.0 / (L - 1)) - 1.0
    ys = torch.linspace(-1, 1, R, device=coords.device)[None, :, None].expand(N, R, C)
    xs = torch.linspace(-1, 1, C, device=coords.device)[None, None, :].expand(N, R, C)
    return torch.stack([xs, moving] if axis == 0 else [moving, ys], dim=-1)


def same_points(pts, valid, ref_pts, ref_valid) -> float:
    """The worst image's share of valid keypoints with a valid reference
    point within SAME_PX, over the larger of the two counts."""
    worst = 1.0
    for b in range(pts.shape[0]):
        a, r = pts[b][valid[b]], ref_pts[b][ref_valid[b]]
        if not len(a) or not len(r):
            raise AssertionError(f"image {b}: {len(a)} and {len(r)} valid keypoints")
        near = (torch.cdist(a[:, :2], r[:, :2], p=float("inf")).min(dim=1).values <= SAME_PX)
        worst = min(worst, float(near.sum()) / max(len(a), len(r)))
    return worst


def check_resample(name: str, got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > VRES_TOL * scale:
        raise AssertionError(f"{name}: max abs err {err} > {VRES_TOL}·{scale}")
    return err


def conv_nms_bounds(images: torch.Tensor, stem_out: torch.Tensor, heat: torch.Tensor) -> dict:
    """``{kernel: (bound ms, bound_by)}`` of the stem (pooled, and unpooled as
    ``stem_v1``), down1 and NMS (radius 4, 3 iterations) at these inputs:
    each input read once, each output written once, every multiply-add of
    the convs at the bf16 peak."""
    affine_bytes = 4 * 64 * 4
    px = images[..., 0].numel()  # stem pixels
    stem_flops = 2.0 * px * 64 * 9 * (1 + 64)
    stem_w_bytes = 9 * 64 * 65 * 2 + affine_bytes
    px2 = stem_out[..., 0].numel()  # down1 pixels
    # NMS: per cell, 2·iterations − 1 = 5 separable window maxes of 4r max
    # operations, plus ~10 compares and selects; fp32 outside the tensor cores
    return {
        "stem": bound(stem_flops, PEAK_BF16,
                      images.numel() * 4 + stem_out.numel() * 2 + stem_w_bytes),
        "stem_v1": bound(stem_flops, PEAK_BF16, images.numel() * 4 + px * 64 * 2 + stem_w_bytes),
        "down1": bound(2.0 * px2 * 64 * 9 * 64 * 2, PEAK_BF16,
                       stem_out.numel() * 2 * 5 // 4 + 2 * 9 * 64 * 64 * 2 + affine_bytes),
        "nms": bound(heat.numel() * (5 * 4 * NMS_RADIUS + 10.0), PEAK_FP32,
                     2 * heat.numel() * 4),
    }


def write_hpatches_tree(root: Path, dev: torch.device, seed: int) -> None:
    """An HPatches-layout tree of HP_SEQ sequences at HP_RAW: ``1.ppm`` with
    rectangles on noise in color (binary P6, as HPatches ships), views warped
    by mild seeded homographies with ``inv_warp_image`` on the card, and
    ``H_1_<i>`` (pixel coordinates, reference → view)."""
    rng = np.random.default_rng(seed)
    h, w = HP_RAW
    # pixel → the normalised coordinates of ``inv_warp_image``
    T = np.array([[2.0 / (w - 1), 0, -1.0], [0, 2.0 / (h - 1), -1.0], [0, 0, 1.0]])
    C = np.array([[1, 0, -(w - 1) / 2], [0, 1, -(h - 1) / 2], [0, 0, 1.0]])
    for s in range(HP_SEQ):
        seq = root / f"{'iv'[s % 2]}_synth{s:02d}"
        seq.mkdir(parents=True)
        gray = structured_images(1, h, w, seed + s)[0, ..., 0]
        rgb = np.stack([gray, gray, rng.uniform(0.0, 1.0, (h, w))], axis=-1)
        write_pnm(seq / "1.ppm", (rgb * 255).astype(np.uint8))
        for i in HP_VIEWS:
            th, sc = np.radians(rng.uniform(-8, 8)), rng.uniform(0.9, 1.1)
            Hm = np.array([[sc * np.cos(th), -sc * np.sin(th), rng.uniform(-15, 15)],
                           [sc * np.sin(th), sc * np.cos(th), rng.uniform(-15, 15)],
                           [rng.uniform(-5e-5, 5e-5), rng.uniform(-5e-5, 5e-5), 1.0]])
            Hm = np.linalg.inv(C) @ Hm @ C  # about the image centre
            H_inv = torch.from_numpy((T @ np.linalg.inv(Hm) @ np.linalg.inv(T)).astype(np.float32))
            with torch.inference_mode():
                view = inv_warp_image(torch.from_numpy(rgb.astype(np.float32)).to(dev),
                                      H_inv.to(dev)).cpu().numpy()
            write_pnm(seq / f"{i}.ppm", np.rint(view.clip(0, 1) * 255).astype(np.uint8))
            np.savetxt(seq / f"H_1_{i}", Hm)


def write_png(path: Path, img: np.ndarray) -> None:
    """uint8 [H, W] gray or [H, W, 3] RGB → an 8-bit PNG written with
    ``zlib`` and ``struct`` alone, row y filtered with type y % 5 (None, Sub,
    Up, Average, Paeth), so that reading it back takes every filter."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    px = img.reshape(h, w * ch).astype(np.int16)
    pad = np.zeros(ch, np.int16)
    prev = np.zeros(w * ch, np.int16)
    rows = []
    for y in range(h):
        cur = px[y]
        a = np.concatenate([pad, cur[:-ch]])  # left
        c = np.concatenate([pad, prev[:-ch]])  # up-left
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        pred = (0, a, prev, (a + prev) >> 1,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c)))[y % 5]
        rows.append(bytes([y % 5]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(b"".join(rows), 6)) + chunk(b"IEND", b""))


def conv_nms_times(model, img: torch.Tensor, dev: torch.device) -> dict:
    """The stem, down1 and NMS (radius 4) at one image ``img [H, W]`` on the
    card, each against its plain version first (stem and down1 within the
    bf16 bars, NMS exactly), then timed beside its plain version, its cuDNN
    composition (none for NMS) and its bound: ``{kernel: {ms, plain_ms,
    bound_ms, bound_by, library_ms, max_abs_err}}``."""
    hh, hw = img.shape
    folded = {k: tuple(t.to(dev) for t in v) for k, v in fold_variables(model).items()}
    stem_p, down1_p = (*folded["inc0"], *folded["inc1"]), (*folded["d1a"], *folded["d1b"])
    stem_prep, down1_prep = stem_mod.prepare_stem(*stem_p), down1_mod.prepare_down1(*down1_p)
    x = img[None, ..., None].contiguous()
    times = {}
    with torch.inference_mode():
        x_stem = stem_mod.stem_plain(x, *stem_p)
        heat = flatten_detection(make_fast_apply(model, device=dev, reference=True)(x)["semi"])
        heat = heat[..., 0].contiguous()
        err = {"stem": stem_mod.assert_bf16_close(stem_mod.stem_prepared(x, stem_prep), x_stem),
               "down1": stem_mod.assert_bf16_close(down1_mod.down1_prepared(x_stem, down1_prep),
                                                   down1_mod.down1_plain(x_stem, *down1_p))}
        if not torch.equal(nms_mod.nms(heat, radius=4, border=4),
                           nms_mod.nms_plain(heat, radius=4, border=4)):
            raise AssertionError(f"nms 1x{hh}x{hw} not exact")
        err["nms"] = 0.0
        bounds = conv_nms_bounds(x, x_stem, heat)
        stem_lib = (cudnn_weights(*folded["inc0"]), cudnn_weights(*folded["inc1"]))
        d1_lib = (cudnn_weights(*folded["d1a"]), cudnn_weights(*folded["d1b"]))
        for name, kern, plain_fn, lib in (
                ("stem", lambda: stem_mod.stem_prepared(x, stem_prep),
                 lambda: stem_mod.stem_plain(x, *stem_p),
                 lambda: cudnn_pair(x, *stem_lib[0], *stem_lib[1])),
                ("down1", lambda: down1_mod.down1_prepared(x_stem, down1_prep),
                 lambda: down1_mod.down1_plain(x_stem, *down1_p),
                 lambda: cudnn_pair(x_stem, *d1_lib[0], *d1_lib[1])),
                ("nms", lambda: nms_mod.nms(heat, radius=4, border=4),
                 lambda: nms_mod.nms_plain(heat, radius=4, border=4), None)):
            t = {"ms": time_ms(kern, iters=50), "plain_ms": time_ms(plain_fn, iters=10),
                 "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                 "library_ms": time_ms(lib, iters=50) if lib is not None else None,
                 "max_abs_err": err[name]}
            times[name] = t
            lib_text = "n/a" if lib is None else f"{t['library_ms']:.4f} ms"
            log(f"[time] {name} at 1x{hh}x{hw}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms "
                f"by {t['bound_by']}), plain {t['plain_ms']:.4f} ms, library {lib_text}")
    torch.cuda.synchronize()
    return times


def reset_launches() -> None:
    stem_mod.launches = down1_mod.launches = nms_mod.launches = 0
    vres_mod.launches = vres_mod.coef_launches = 0


def read_launches() -> dict:
    return {"stem": stem_mod.launches, "down1": down1_mod.launches, "nms": nms_mod.launches,
            "vresample": vres_mod.launches, "vresample_coef": vres_mod.coef_launches}


def cudnn_weights(w, s, b):
    """HWIO bf16 kernel and folded scale/bias → (OIHW channels-last bf16
    with the scale folded in, bf16 bias)."""
    wf = (w.float() * s).permute(3, 2, 0, 1).to(torch.bfloat16)
    return wf.contiguous(memory_format=torch.channels_last), b.to(torch.bfloat16)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")

    # ---- 1. the card -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    dev = torch.device("cuda")

    # ---- 2. build ----------------------------------------------------------
    seconds = _build.build_all()
    log(f"[build] {', '.join(_build.SOURCES)} built with nvcc in "
        f"{max(seconds[n] for n in _build.SOURCES):.1f} s; the host image decoder "
        f"({', '.join(_build.HOST_SOURCES)}.cpp) with g++ in "
        f"{max(seconds[n] for n in _build.HOST_SOURCES):.1f} s, all started together")

    # ---- 3. main path ------------------------------------------------------
    model = load_flax_npz(NPZ, "SuperPointNet_gauss2", device=dev)
    detect_describe = build_pipeline(model, dev, k=TOP_K)
    plain_pipeline = build_pipeline(model, dev, k=TOP_K, reference=True)
    images = torch.from_numpy(structured_images(BATCH, H, W, SEED)).to(dev)

    reset_launches()
    pts, desc = detect_describe(images)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[main] detect+describe {BATCH}x{H}x{W}, K={TOP_K}: launches {launches}")
    idle = [k for k in ("stem", "down1", "nms") if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    if pts.shape != (BATCH, TOP_K, 3) or desc.shape != (BATCH, TOP_K, 256):
        raise AssertionError(f"shapes {tuple(pts.shape)}, {tuple(desc.shape)}")
    if not (torch.isfinite(pts).all() and torch.isfinite(desc).all()):
        raise AssertionError("non-finite keypoints or descriptors")
    ref_pts, ref_desc = plain_pipeline(images)
    agree = agreement(pts, desc, ref_pts, ref_desc)
    log(f"[main] vs plain path, worst image: {agree['shared']:.4f} of the K keypoints shared, "
        f"{agree['strong_recall']:.4f} of the points over {STRONG} found, descriptor cosine "
        f">= {agree['cos']:.6f}")

    main_ms = time_ms(lambda: detect_describe(images), iters=20, warmup=3)
    t0 = time.perf_counter()
    for _ in range(10):
        detect_describe(images)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    log(f"[main] {BATCH * 1e3 / main_ms:.1f} img/s (CUDA events, {main_ms:.3f} ms/batch); "
        f"host clock {host_ms:.3f} ms/batch; plain path "
        f"{time_ms(lambda: plain_pipeline(images), iters=5):.3f} ms/batch")

    # ---- 4. each kernel against its plain version --------------------------
    folded = {k: tuple(t.to(dev) for t in v) for k, v in fold_variables(model).items()}
    stem_p = (*folded["inc0"], *folded["inc1"])
    down1_p = (*folded["d1a"], *folded["d1b"])
    with torch.inference_mode():
        stem_out = stem_mod.stem_plain(images, *stem_p)
        heat_main = flatten_detection(
            make_fast_apply(model, device=dev, reference=True)(images)["semi"])[..., 0].contiguous()
    odd = torch.from_numpy(structured_images(2, *ODD_HW, SEED + 1)).to(dev)
    odd_heat = torch.from_numpy(
        np.random.default_rng(SEED).uniform(size=(2, *ODD_HW)).astype(np.float32) ** 4).to(dev)

    err = {"stem": 0.0, "stem_v1": 0.0, "down1": 0.0, "nms": 0.0}
    for pool in (True, False):
        for x in (images, odd):
            e = stem_mod.assert_bf16_close(stem_mod.stem(x, *stem_p, pool=pool),
                                           stem_mod.stem_plain(x, *stem_p, pool=pool))
            which = "stem" if pool else "stem_v1"  # unpooled: the first TPU stem's function
            err[which] = max(err[which], e)
        for x in (stem_out, stem_mod.stem_plain(odd, *stem_p)):
            e = stem_mod.assert_bf16_close(down1_mod.down1(x, *down1_p, pool=pool),
                                           down1_mod.down1_plain(x, *down1_p, pool=pool))
            err["down1"] = max(err["down1"], e)
    for h in (heat_main, odd_heat):
        for radius, border in ((NMS_RADIUS, BORDER), (2, 0)):
            got = nms_mod.nms(h, radius=radius, border=border)
            want = nms_mod.nms_plain(h, radius=radius, border=border)
            if not torch.equal(got, want):
                raise AssertionError(f"nms r={radius} border={border} {tuple(h.shape)} not exact: "
                                     f"{int((got != want).sum())} cells differ")
    torch.cuda.synchronize()
    log(f"[kernels] vs plain at {BATCH}x{H}x{W} and 2x{ODD_HW[0]}x{ODD_HW[1]}: "
        f"max abs err {err} (stem/down1 within the bf16 bars, nms exact)")

    # ---- 5. semantic model: folded bf16 forward vs the fp32 module ---------
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ss = load_flax_npz(NPZ, "SuperPointNet_gauss2_ssmall", device=dev)
    # uniform noise, as the JAX package's fast-forward test feeds: on the
    # structured images some descriptor cells are near zero before the
    # normalisation, and their direction is arbitrary in either precision
    x2 = torch.from_numpy(
        np.random.default_rng(SEED).uniform(size=(2, H, W, 1)).astype(np.float32)).to(dev)
    fast = make_fast_apply(ss, device=dev)(x2)
    with torch.inference_mode():
        ref = ss(x2)
    for k in ("semi", "desc", "sem"):
        if fast[k].shape != ref[k].shape or not torch.isfinite(fast[k]).all():
            raise AssertionError(f"{k}: shape {tuple(fast[k].shape)} vs {tuple(ref[k].shape)}")
    semi_rel = float((fast["semi"] - ref["semi"]).abs().max() / ref["semi"].abs().max())
    cos = float((fast["desc"] * ref["desc"]).sum(-1).min())
    sem_rel = float((fast["sem"] - ref["sem"]).abs().max() / ref["sem"].abs().max())
    log(f"[ssmall] 2x{H}x{W} bf16 folded vs fp32 module: semi rel err {semi_rel:.4f} (< "
        f"{REL_MAX}), desc cosine {cos:.6f} (> {COS_MIN}), sem rel err {sem_rel:.4f} (< {REL_MAX})")
    if semi_rel >= REL_MAX or cos <= COS_MIN or sem_rel >= REL_MAX:
        raise AssertionError("semantic model outside the bf16-vs-fp32 bars")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # ---- 6. the folded convs keep the fp32 accumulator ----------------------
    G, NH, HH, HW = bench_ha.GROUP, bench_ha.NUM_H, bench_ha.H, bench_ha.W
    for shape in ((BATCH, H, W), (NH, HH, HW)):
        acc = accumulator_errors(ss, shape, device=dev)
        log(f"[conv] {shape}: accumulator vs fp32 conv with TF32 off, max err / max|want| "
            f"{ {k: f'{v:.2e}' for k, v in acc.items()} } (bar {ACC_MAX:.2e})")
        if len(acc) != 9 or max(acc.values()) > ACC_MAX:
            raise AssertionError(f"folded conv accumulators outside 2^-14 at {shape}: {acc}")

    # ---- 7. the HA export path ----------------------------------------------
    ha_kw = dict(device=dev, num_h=NH, top_k=bench_ha.TOP_K, nms_radius=4, subpixel=True)
    fast = best_apply_fn(model, input_hw=(HH, HW), device=dev)
    ha = make_ha_fn(fast, **ha_kw)
    ha_plain = make_ha_fn(make_fast_apply(model, device=dev, reference=True), reference=True,
                          **ha_kw)
    ha_images = torch.from_numpy(structured_images(G, HH, HW, SEED + 2)[..., 0]).to(dev)

    def gen():
        return torch.Generator().manual_seed(SEED + 3)

    ha(ha_images, generator=gen())  # warm-up: cuDNN autotuning at the chunk's shapes
    torch.cuda.synchronize()
    reset_launches()
    ha_pts, ha_valid = ha(ha_images, generator=gen())
    torch.cuda.synchronize()
    ha_launches = read_launches()
    log(f"[ha] {G}x{HH}x{HW}, {NH} warps each, top-{bench_ha.TOP_K}: launches {ha_launches} "
        f"(from the code: vresample_coef {2 + 2 * G}, vresample 0, stem {G}, down1 {G}, nms 1)")
    idle = [k for k in ("vresample_coef", "stem", "down1", "nms") if ha_launches[k] == 0]
    if idle or ha_launches["vresample"] != 0:
        raise AssertionError(f"HA path launches {ha_launches}: not launched {idle}")
    if ha_pts.shape != (G, bench_ha.TOP_K, 3) or ha_valid.shape != (G, bench_ha.TOP_K):
        raise AssertionError(f"shapes {tuple(ha_pts.shape)}, {tuple(ha_valid.shape)}")
    if not torch.isfinite(ha_pts).all() or int(ha_valid.sum(dim=1).min()) < 1:
        raise AssertionError(f"non-finite points or an image without a valid point: "
                             f"{ha_valid.sum(dim=1).tolist()}")
    ref_pts, ref_valid = ha_plain(ha_images, generator=gen())
    share = same_points(ha_pts, ha_valid, ref_pts, ref_valid)
    log(f"[ha] valid points per image {ha_valid.sum(dim=1).tolist()}; vs the plain path with the "
        f"same homographies, worst image: {share:.4f} of the valid keypoints within {SAME_PX} px")
    if share < SHARED_MIN:
        raise AssertionError(f"HA keypoints: {share:.4f} shared with the plain path < {SHARED_MIN}")

    ha_ms = time_ms(lambda: ha(ha_images, generator=gen()), iters=3, warmup=1)
    t0 = time.perf_counter()
    for _ in range(3):
        ha(ha_images, generator=gen())
    torch.cuda.synchronize()
    ha_host_ms = (time.perf_counter() - t0) / 3 * 1e3
    log(f"[ha] {G * 1e3 / ha_ms:.2f} img/s by CUDA events ({ha_ms:.2f} ms/group); "
        f"{G * 1e3 / ha_host_ms:.2f} img/s by the host clock ({ha_host_ms:.2f} ms/group)")

    # the forward best_apply_fn picks, against the fp32 module it passes over
    module = best_apply_fn(model, enable=False, device=dev)
    with torch.inference_mode():
        for label, x in ((f"{NH}x{HH}x{HW}",
                          torch.from_numpy(structured_images(NH, HH, HW, SEED + 4)).to(dev)),
                         (f"{BATCH}x{H}x{W}", images)):
            fast_ms, module_ms = time_ms(lambda: fast(x), iters=5), time_ms(lambda: module(x), iters=5)
            log(f"[forward] {label}: folded bf16 forward {fast_ms:.3f} ms, fp32 module "
                f"{module_ms:.3f} ms")
            if fast_ms >= module_ms:
                raise AssertionError(f"best_apply_fn returns the folded forward, which lost at {label}")

    # ---- 8. run_ha_export: write, resume, refill -----------------------------
    export_images = [(f"img_{i:04d}", structured_images(1, HH, HW, 100 + i)[0, ..., 0])
                     for i in range(2 * G)]
    with tempfile.TemporaryDirectory() as td:
        out_dir = Path(td) / "labels"
        t0 = time.perf_counter()
        written = run_ha_export(ha, export_images, out_dir, seed=SEED, group=G)
        export_s = time.perf_counter() - t0
        again = run_ha_export(ha, export_images, out_dir, seed=SEED, group=G)
        first = {}
        for name, _ in export_images:
            with np.load(out_dir / f"{name}.npz") as z:
                first[name] = z["pts"]
            if first[name].ndim != 2 or first[name].shape[1] != 3 or not len(first[name]):
                raise AssertionError(f"{name}.npz: pts {first[name].shape}")
        removed = [name for name, _ in export_images[1::2]]
        for name in removed:
            (out_dir / f"{name}.npz").unlink()
        refilled = run_ha_export(ha, export_images, out_dir, seed=SEED, group=G)
        for name in removed:
            with np.load(out_dir / f"{name}.npz") as z:
                if z["pts"].tobytes() != first[name].tobytes():
                    raise AssertionError(f"{name}.npz differs after the refill")
    log(f"[export] run_ha_export: {written} npz written ({len(export_images) / export_s:.2f} "
        f"img/s by the host clock), {again} on the second call, {refilled} refilled "
        f"byte-identically after {len(removed)} were removed")
    if (written, again, refilled) != (2 * G, 0, G):
        raise AssertionError(f"run_ha_export counts {(written, again, refilled)}")

    # ---- 9. the rows route ---------------------------------------------------
    ha20 = make_ha_fn(fast, **{**ha_kw, "num_h": 20})

    def gen20():
        return torch.Generator().manual_seed(SEED + 5)

    coef_pts, coef_valid = ha20(ha_images[:2], generator=gen20())
    # the group's own homographies, as ``ha`` samples them from one generator
    g = gen()
    Hs = torch.stack([sample_homographies(NH - 1, generator=g, shift=-1.0,
                                          **DEFAULT_HA["homographies"]["params"])
                      for _ in range(G)])
    Hs = torch.cat([torch.eye(3).expand(G, 1, 3, 3), Hs], dim=1).reshape(-1, 3, 3)
    with torch.inference_mode():
        stack_coef_ms = time_ms(lambda: warp_twopass.inv_warp_image_twopass(ha_images, Hs),
                                iters=3, warmup=1)
        warp_twopass.COEF_GRIDS = False
        reset_launches()
        rows_pts, rows_valid = ha20(ha_images[:2], generator=gen20())
        torch.cuda.synchronize()
        rows_launches = read_launches()
        stack_rows_ms = time_ms(lambda: warp_twopass.inv_warp_image_twopass(ha_images, Hs),
                                iters=3, warmup=1)
        warp_twopass.COEF_GRIDS = True
    share = same_points(rows_pts, rows_valid, coef_pts, coef_valid)
    log(f"[rows] 2x{HH}x{HW}, 20 warps each, COEF_GRIDS off: launches {rows_launches}; "
        f"{share:.4f} of the valid keypoints shared with the coef route; the {G * NH}-warp "
        f"stack: rows route {stack_rows_ms:.3f} ms, coef route {stack_coef_ms:.3f} ms")
    if rows_launches["vresample"] == 0 or rows_launches["vresample_coef"] != 0:
        raise AssertionError(f"rows route launches {rows_launches}")
    if share < SHARED_MIN:
        raise AssertionError(f"rows route keypoints: {share:.4f} shared < {SHARED_MIN}")

    # ---- 10. the resample kernels against their plain versions ----------------
    planted = [-10.0, 1e9, -1e9, None, float("inf"), float("-inf"), float("nan"), -1.0]
    res = {}  # the path's inputs, kept for the timing below

    def path_inputs(tag, imgs, Hm):
        """The two passes' inputs for ``imgs`` warped by ``Hm``, as
        ``inv_warp_image_twopass`` builds them, with the planted cases."""
        canvas, Hres, bounds, _ = warp_twopass._canvas_and_residual(imgs, Hm)
        S = canvas.shape[-1]
        rows, cols = warp_twopass._twopass_grids(Hres.to(dev), S,
                                                 *warp_twopass._keep_masks(bounds, S, dev))
        vals = torch.tensor([S - 1.0 if v is None else v for v in planted], device=dev)
        rows[0, 1, :8] = vals
        cols[0, 1, :8] = vals
        coef1, coef2 = (c.to(dev) for c in warp_twopass._pass_coefs(Hres, *bounds, S))
        res[tag] = dict(canvas=canvas, rows=rows, cols=cols, coef1=coef1, coef2=coef2)

    with torch.inference_mode():
        path_inputs("stack", ha_images, Hs)
        stack = warp_twopass.inv_warp_image_twopass(ha_images, Hs)
        heat = flatten_detection(fast(stack[:NH, ..., None])["semi"])[..., 0].contiguous()
        path_inputs("heat", heat, inv3(Hs[:NH]))
        del stack
        err["vresample"] = err["vresample_coef"] = 0.0
        for tag, d in res.items():
            scale = float(d["canvas"].abs().max())
            shape = f"{tuple(d['rows'].shape)} over {d['canvas'].shape[0]} images"
            d["tmp"] = vres_mod.vresample(d["canvas"], d["rows"], axis=0)
            e0 = check_resample(f"vresample axis 0 {shape}", d["tmp"],
                                vres_mod.vresample_plain(d["canvas"], d["rows"], axis=0), scale)
            e1 = check_resample(f"vresample axis 1 {shape}",
                                vres_mod.vresample(d["tmp"], d["cols"], axis=1),
                                vres_mod.vresample_plain(d["tmp"], d["cols"], axis=1), scale)
            c0 = check_resample(f"vresample_coef axis 0 {shape}",
                                vres_mod.vresample_coef(d["canvas"], d["coef1"], axis=0),
                                vres_mod.vresample_coef_plain(d["canvas"], d["coef1"], axis=0), scale)
            c1 = check_resample(f"vresample_coef axis 1 {shape}",
                                vres_mod.vresample_coef(d["tmp"], d["coef2"], axis=1),
                                vres_mod.vresample_coef_plain(d["tmp"], d["coef2"], axis=1), scale)
            err["vresample"] = max(err["vresample"], e0, e1)
            err["vresample_coef"] = max(err["vresample_coef"], c0, c1)
            torch.cuda.synchronize()
            log(f"[kernels] resample on the HA path's {tag}, {shape}: max abs err rows "
                f"{max(e0, e1):.2e}, coef {max(c0, c1):.2e} (bar {VRES_TOL}·{scale:.3f})")
        # the whole warp at an odd rectangular size, every rotation bucket
        odd_Hs = []
        for ang in (-170.0, -95.0, 10.0, 80.0) * 2:
            a = np.radians(ang + len(odd_Hs))
            odd_Hs.append([[np.cos(a), -np.sin(a), 0.03], [np.sin(a), np.cos(a), -0.05],
                           [0.02, -0.03, 1.0]])
        odd_Hs = torch.tensor(odd_Hs, dtype=torch.float32)
        buckets = set(warp_twopass._canvas_and_residual(odd[..., 0], odd_Hs)[3].tolist())
        if buckets != {0, 1, 2, 3}:
            raise AssertionError(f"rotation buckets {buckets}")
        for coef in (False, True):
            warp_twopass.COEF_GRIDS = coef
            got = warp_twopass.inv_warp_image_twopass(odd[..., 0].contiguous(), odd_Hs)
            want = warp_twopass.inv_warp_image_twopass(odd[..., 0].contiguous(), odd_Hs,
                                                       reference=True)
            warp_twopass.COEF_GRIDS = True
            name = "vresample_coef" if coef else "vresample"
            e = check_resample(f"two-pass warp 2x{ODD_HW[0]}x{ODD_HW[1]}, 8 warps ({name})",
                               got, want, float(odd.abs().max()))
            if float(want.abs().mean()) < 0.01:
                raise AssertionError("the odd-size warp is empty")
            err[name] = max(err[name], e)
    torch.cuda.synchronize()
    log(f"[kernels] resample vs plain incl. 2x{ODD_HW[0]}x{ODD_HW[1]} through the two-pass "
        f"warp: max abs err {{'vresample': {err['vresample']:.2e}, 'vresample_coef': "
        f"{err['vresample_coef']:.2e}}}")

    # ---- 11. kernel times at their paths' shapes -----------------------------
    main_bounds = conv_nms_bounds(images, stem_out, heat_main)
    stem_lib = (cudnn_weights(*folded["inc0"]), cudnn_weights(*folded["inc1"]))
    d1_lib = (cudnn_weights(*folded["d1a"]), cudnn_weights(*folded["d1b"]))
    # the kernels' weights laid out once, as the forward holds them
    stem_prep, down1_prep = stem_mod.prepare_stem(*stem_p), down1_mod.prepare_down1(*down1_p)

    # The resample kernels' time is the mean over the launches of one HA
    # group: two passes over the 800-warp stack and, for each of the G chunks,
    # two passes over 100 heatmaps.  Per output pixel a launch reads 4 B of
    # coordinate (the coef kernel 80 B per warp instead), writes 4 B, and
    # reads its images once; ~12 fp32 operations for the blend and the
    # tests, ~50 more where the coordinate is rebuilt.
    def group_mean(per_launch):
        t = [per_launch(tag, axis) for tag in ("stack", "heat") for axis in (0, 1)]
        return (t[0] + t[1] + G * (t[2] + t[3])) / (2 + 2 * G)

    def resample_bound(coef: bool):
        def one(tag, axis):
            d = res[tag]
            n_out = d["rows"].numel()
            img = (d["canvas"] if axis == 0 else d["tmp"]).numel()
            coords = d["coef1"].numel() if coef else n_out
            return bound(n_out * (62.0 if coef else 12.0), PEAK_FP32, 4.0 * (coords + n_out + img))
        ms = group_mean(lambda tag, axis: one(tag, axis)[0])
        kinds = {one(tag, axis)[1] for tag in res for axis in (0, 1)}
        return ms, kinds.pop() if len(kinds) == 1 else "bytes"

    with torch.inference_mode():
        for d in res.values():  # the library call's inputs, made outside the timing
            N, S = d["rows"].shape[0], d["rows"].shape[-1]
            M = d["canvas"].shape[0]
            d["src0"] = d["canvas"][:, None].expand(M, N // M, S, S).reshape(N, 1, S, S)
            d["src1"] = d["tmp"][:, None]
            d["grid0"] = resample_grid(d["rows"], 0, S)
            d["grid1"] = resample_grid(d["cols"], 1, S)
        # the library call computes the same function (away from the planted cases)
        lib_out = grid_sample_1d(res["heat"]["src0"], res["heat"]["grid0"])[:, 0]
        lib_err = float((lib_out - res["heat"]["tmp"])[1:].abs().max())
        if lib_err > 1e-3 * float(res["heat"]["canvas"].abs().max()):
            raise AssertionError(f"grid_sample disagrees with the resample kernel: {lib_err}")

        def src(d, axis):
            return d["canvas"] if axis == 0 else d["tmp"]

        def coords(d, axis):
            return d["rows"] if axis == 0 else d["cols"]

        def t_res(fn, iters):
            return group_mean(lambda tag, axis: time_ms(
                lambda: fn(src(res[tag], axis), coords(res[tag], axis), axis), iters=iters))

        def t_coef(fn, iters):
            return group_mean(lambda tag, axis: time_ms(
                lambda: fn(src(res[tag], axis), res[tag][f"coef{axis + 1}"], axis), iters=iters))

        lib_ms = group_mean(lambda tag, axis: time_ms(
            lambda: grid_sample_1d(res[tag][f"src{axis}"], res[tag][f"grid{axis}"]), iters=5))
        resample_times = {
            "vresample": (t_res(vres_mod.vresample, 10), t_res(vres_mod.vresample_plain, 3)),
            "vresample_coef": (t_coef(vres_mod.vresample_coef, 10),
                               t_coef(vres_mod.vresample_coef_plain, 3)),
        }
        for name, axis in (("vresample", 0), ("vresample", 1)):
            d = res["stack"]
            log(f"[time] {name} axis {axis} at {tuple(d['rows'].shape)}: "
                f"{time_ms(lambda: vres_mod.vresample(src(d, axis), coords(d, axis), axis)):.4f} ms")

        # the stem and down1 at the HA path's chunk of 100 warped images, each
        # against its plain version before it is timed below
        ha_chunk = torch.from_numpy(structured_images(NH, HH, HW, SEED + 4)).to(dev)
        chunk_out = stem_mod.stem_prepared(ha_chunk, stem_prep)
        e = stem_mod.assert_bf16_close(chunk_out, stem_mod.stem_plain(ha_chunk, *stem_p))
        e1 = stem_mod.assert_bf16_close(down1_mod.down1_prepared(chunk_out, down1_prep),
                                        down1_mod.down1_plain(chunk_out, *down1_p))
        err["down1"] = max(err["down1"], e1)
        ha_heat = torch.from_numpy(np.random.default_rng(SEED + 6).uniform(
            size=(G, HH, HW)).astype(np.float32) ** 4).to(dev)
        if not torch.equal(nms_mod.nms(ha_heat, radius=4, border=4),
                           nms_mod.nms_plain(ha_heat, radius=4, border=4)):
            raise AssertionError(f"nms {G}x{HH}x{HW} not exact")

        rows = [
            ("stem", "ssp/kernels/stem_pallas_v2.py:182", "ssp_torch/csrc/stem.cu",
             lambda: stem_mod.stem_prepared(images, stem_prep),
             lambda: stem_mod.stem_plain(images, *stem_p),
             lambda: cudnn_pair(images, *stem_lib[0], *stem_lib[1]),
             main_bounds["stem"]),
            ("down1", "ssp/kernels/down1_pallas.py:107", "ssp_torch/csrc/down1.cu",
             lambda: down1_mod.down1_prepared(stem_out, down1_prep),
             lambda: down1_mod.down1_plain(stem_out, *down1_p),
             lambda: cudnn_pair(stem_out, *d1_lib[0], *d1_lib[1]),
             main_bounds["down1"]),
            ("nms", "ssp/kernels/nms_pallas.py:124", "ssp_torch/csrc/nms.cu",
             lambda: nms_mod.nms(heat_main, radius=NMS_RADIUS, border=BORDER),
             lambda: nms_mod.nms_plain(heat_main, radius=NMS_RADIUS, border=BORDER),
             None,
             main_bounds["nms"]),
            ("vresample", "ssp/kernels/vresample_pallas.py:176", "ssp_torch/csrc/vresample.cu",
             None, None, None, resample_bound(coef=False)),
            ("vresample_coef", "ssp/kernels/vresample_pallas.py:141",
             "ssp_torch/csrc/vresample.cu", None, None, None, resample_bound(coef=True)),
            # the first TPU stem's function, the stem without the pool: on no
            # path in either package, so it is never launched by one
            ("stem_v1", "ssp/kernels/stem_pallas.py:134", "ssp_torch/csrc/stem.cu",
             lambda: stem_mod.stem_prepared(images, stem_prep, pool=False),
             lambda: stem_mod.stem_plain(images, *stem_p, pool=False),
             lambda: cudnn_pair(images, *stem_lib[0], *stem_lib[1], pool=False),
             main_bounds["stem_v1"]),
        ]
        on_main = {**launches, "stem_v1": 0}
        on_ha = {**ha_launches, "stem_v1": 0}
        # the rows kernel is off the default route: its launches are those of phase 9's run
        on_rows_run = {"vresample": rows_launches["vresample"]}
        kernels = []
        for name, replaces, source, kern, plain, lib, (bound_ms, bound_by) in rows:
            if name in resample_times:
                (ms, plain_ms), lib_ms_k = resample_times[name], lib_ms
            else:
                ms, plain_ms = time_ms(kern), time_ms(plain, iters=5)
                lib_ms_k = time_ms(lib) if lib is not None else None
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": on_main[name] + on_ha[name] + on_rows_run.get(name, 0),
                "launches_main": on_main[name], "launches_ha": on_ha[name],
                "launches_rows_route_run": on_rows_run.get(name, 0),
                "max_abs_err": err[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms_k,
            })
            log(f"[time] {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by {bound_by}), plain "
                f"{plain_ms:.4f} ms, library "
                f"{'n/a' if lib_ms_k is None else f'{lib_ms_k:.4f} ms'}; launches main path "
                f"{on_main[name]}, HA group {on_ha[name]}"
                + (f", rows-route run {on_rows_run[name]}" if name in on_rows_run else ""))
        # the same two kernels at the HA path's chunk of 100 warped images
        stem_ha_ms = time_ms(lambda: stem_mod.stem_prepared(ha_chunk, stem_prep))
        down1_ha_ms = time_ms(lambda: down1_mod.down1_prepared(chunk_out, down1_prep))
        nms_ha_ms = time_ms(lambda: nms_mod.nms(ha_heat, radius=4, border=4))
        log(f"[time] at the HA chunk's {NH}x{HH}x{HW}: stem {stem_ha_ms:.4f} ms (max abs err "
            f"{e:.3g} vs plain), down1 {down1_ha_ms:.4f} ms (max abs err {e1:.3g} vs plain); "
            f"nms at the group's {G}x{HH}x{HW} {nms_ha_ms:.4f} ms (exact)")
    torch.cuda.synchronize()

    # ---- 12. [hpatches] the stage-4 descriptor export; 13. [evaluate] ---------
    # ---- 14. [imageio]; 15. [sequence]; 16. [ha_cli] -------------------------
    with hpatches_workdir() as td:
        export_launches, export_times = hpatches_phase(dev, td)
        sweep_launches = evaluate_phase(dev, td)
        imageio_phase(td)
        sequence_launches, sequence_times = sequence_phase(dev, td)
        ha_cli_launches = ha_cli_phase(dev, td)
    for row in kernels:
        row["launches_export"] = export_launches.get(row["name"], 0)
        row["launches_sweep"] = sweep_launches.get(row["name"], 0)
        row["launches_sequence"] = sequence_launches.get(row["name"], 0)
        row["launches_ha_cli"] = ha_cli_launches.get(row["name"], 0)
        if row["name"] in export_times:
            row["export_1x240x320"] = export_times[row["name"]]
        if row["name"] in sequence_times:
            row["sequence_1x384x1248"] = sequence_times[row["name"]]

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


@contextlib.contextmanager
def hpatches_workdir():
    """A temporary directory for phases 12 to 16, with ``SSP_DATA_PATH`` set
    to it and ``SSP_EXPER_PATH`` to its ``logs``; both restored after."""
    saved_env = {k: os.environ.get(k) for k in ("SSP_DATA_PATH", "SSP_EXPER_PATH")}
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        os.environ["SSP_DATA_PATH"], os.environ["SSP_EXPER_PATH"] = str(td), str(td / "logs")
        try:
            yield td
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def hpatches_phase(dev: torch.device, td: Path):
    """Phase 12: the stage-4 HPatches export through the CLI on a synthetic
    corpus written under ``td``, against the same export on the kernels'
    plain versions; its throughput and where a pair's time goes; the kernels
    at 1×240×320.  Leaves the corpus in ``td/HPatches``, the CLI's export in
    ``td/logs/smoke/predictions`` and the plain one in ``td/plain``.
    Returns (launches of the CLI's export per kernel, {kernel: times at
    1×240×320})."""
    hh, hw = HPATCHES_CONFIG["data"]["preprocessing"]["resize"]
    m = HPATCHES_CONFIG["model"]
    dd_kw = dict(top_k=m["top_k"], conf_thresh=m["detection_threshold"], nms_radius=m["nms"],
                 subpixel=m["subpixel"]["enable"], patch_size=m["subpixel"]["patch_size"])
    config = {**HPATCHES_CONFIG, "pretrained": str(ROOT / HPATCHES_CONFIG["pretrained"])}
    t0 = time.perf_counter()
    write_hpatches_tree(td / "HPatches", dev, SEED + 7)
    log(f"[hpatches] corpus: {HP_SEQ} sequences x {len(HP_VIEWS)} views at "
        f"{HP_RAW[0]}x{HP_RAW[1]}, binary P6, written in {time.perf_counter() - t0:.1f} s")
    dataset = PatchesDataset(preprocessing={"resize": [hh, hw]})
    n_pairs = len(dataset)
    ss = load_flax_npz(NPZ, m["name"], device=dev)
    fast = best_apply_fn(ss, input_hw=(hh, hw), device=dev)
    dd = make_detect_describe_fn(fast, device=dev, **dd_kw)
    dd(torch.from_numpy(dataset[0]["image"]))  # warm-up: cuDNN autotuning at 240×320
    torch.cuda.synchronize()

    # the main path of this phase: the CLI, counted
    reset_launches()
    t0 = time.perf_counter()
    written = export_descriptor(config, "smoke", device=dev)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[hpatches] export_descriptor: {written} pairs in {cli_s:.2f} s with the model "
        f"load; launches {launches} (one image per call: stem, down1 and nms "
        f"{2 * n_pairs} each = 2 per pair)")
    if written != n_pairs or any(launches[k] != 2 * n_pairs
                                 for k in ("stem", "down1", "nms")):
        raise AssertionError(f"export: {written} pairs, launches {launches}")
    if launches["vresample"] or launches["vresample_coef"]:
        raise AssertionError(f"resample kernels launched by the export: {launches}")
    again = export_descriptor(config, "smoke", device=dev)
    if again != 0:
        raise AssertionError(f"the second export wrote {again} files")

    # the same export on the kernels' plain versions.  The files hold
    # subpixel-refined points, where two different detections can land
    # within SAME_PX of each other: they are held to the share of
    # shared points; the detections themselves (subpixel off, all K
    # points) to the main path's bars, as ``agreement`` holds them
    plain = make_detect_describe_fn(make_fast_apply(ss, device=dev, reference=True),
                                    device=dev, reference=True, **dd_kw)
    run_descriptor_export(plain, iter(dataset), td / "plain", nn_thresh=m["nn_thresh"])
    files_shared, counts, images = 1.0, [], []
    for i in range(n_pairs):
        with np.load(td / "logs" / "smoke" / "predictions" / f"{i}.npz") as a, \
                np.load(td / "plain" / f"{i}.npz") as b:
            a, b = dict(a), dict(b)
        for key in ("image", "warped_image", "homography"):
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"pair {i}: {key} differs")
        if a["matches"].ndim != 2 or a["matches"].shape[1] != 4 or \
                not np.isfinite(a["desc"]).all():
            raise AssertionError(f"pair {i}: matches {a['matches'].shape}")
        for side in ("prob", "warped_prob"):
            p, q = torch.from_numpy(a[side])[None], torch.from_numpy(b[side])[None]
            files_shared = min(files_shared, same_points(
                p, torch.ones(p.shape[:2], dtype=torch.bool), q,
                torch.ones(q.shape[:2], dtype=torch.bool)))
        counts.append((len(a["prob"]), len(b["prob"]), len(a["matches"]),
                       len(b["matches"])))
        images += [a["image"], a["warped_image"]]
    log("[hpatches] per pair (points ref, kernels/plain; matches, kernels/plain): "
        + " ".join(f"{p}/{q},{u}/{v}" for p, q, u, v in counts))
    log(f"[hpatches] written files vs the plain versions, worst image of {n_pairs} "
        f"pairs: {files_shared:.4f} of the valid refined points within {SAME_PX} px")
    if files_shared < SHARED_MIN:
        raise AssertionError(f"export files: {files_shared:.4f} shared < {SHARED_MIN}")
    unrefined = {**dd_kw, "subpixel": False}
    det = make_detect_describe_fn(fast, device=dev, **unrefined)
    det_plain = make_detect_describe_fn(make_fast_apply(ss, device=dev, reference=True),
                                        device=dev, reference=True, **unrefined)
    worst = {"shared": 1.0, "strong_recall": 1.0, "cos": 1.0}
    stack = torch.from_numpy(np.stack(images)).to(dev)
    for c in range(0, len(stack), 16):
        pts, _, desc = det(stack[c:c + 16])
        ref_pts, _, ref_desc = det_plain(stack[c:c + 16])
        w = agreement(pts, desc, ref_pts, ref_desc)
        worst = {k: min(worst[k], w[k]) for k in worst}
    log(f"[hpatches] detections vs the plain versions (subpixel off), worst of "
        f"{len(stack)} images: {worst['shared']:.4f} of the K keypoints shared, "
        f"{worst['strong_recall']:.4f} of the points over {STRONG} found, descriptor "
        f"cosine >= {worst['cos']:.6f}")

    # throughput by the host clock, and where a pair's time goes
    recorded = []

    def recording(image):
        out = dd(image)
        recorded.append(out)
        return out

    t0 = time.perf_counter()
    run_descriptor_export(recording, iter(dataset), td / "timed", nn_thresh=m["nn_thresh"])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pairs = list(dataset)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for pair in pairs:  # the calls as the export makes them: host arrays in, copies back
        for key in ("image", "warped_image"):
            [t.cpu() for t in dd(pair[key])]
    device_s = time.perf_counter() - t0
    replay = iter(recorded)
    t0 = time.perf_counter()
    run_descriptor_export(lambda image: next(replay), pairs, td / "replay",
                          nn_thresh=m["nn_thresh"])
    host_s = time.perf_counter() - t0
    img = torch.from_numpy(pairs[0]["image"]).to(dev)
    dd_ms = time_ms(lambda: dd(img), iters=20)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            dd(img)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in on_card) / 10 / 1e3
    per_pair = {k: v * 1e3 / n_pairs for k, v in (
        ("export", export_s), ("decode", decode_s), ("calls", device_s), ("host", host_s))}
    per_pair["rest"] = per_pair["export"] - per_pair["decode"] - per_pair["calls"] \
        - per_pair["host"]
    log(f"[hpatches] {n_pairs / export_s:.2f} pairs/s by the host clock over the whole "
        f"export ({per_pair['export']:.2f} ms/pair): decode and resize "
        f"{per_pair['decode']:.2f}, two detect+describe calls with the copies "
        f"{per_pair['calls']:.2f}, matching and npz writes {per_pair['host']:.2f}, the "
        f"rest {per_pair['rest']:.2f} ms/pair; host work (decode, matching, writes) "
        f"{(decode_s + host_s) / export_s:.4f} of the time")
    log(f"[hpatches] detect+describe at 1x{hh}x{hw}: {dd_ms:.3f} ms/image by CUDA events; "
        f"{len(on_card) / 10:.0f} device operations and {busy_ms:.3f} ms of device time "
        f"per image (torch.profiler), so the card idles "
        f"{max(0.0, 1 - busy_ms / dd_ms):.3f} of the call")
    slam = torch.from_numpy(structured_images(1, *SLAM_HW, SEED + 8)[0, ..., 0]).to(dev)
    slam_fn = make_detect_describe_fn(best_apply_fn(ss, input_hw=SLAM_HW, device=dev),
                                      device=dev, **{**dd_kw, "subpixel": False})
    slam_ms = time_ms(lambda: slam_fn(slam), iters=20)
    log(f"[hpatches] detect+describe at 1x{SLAM_HW[0]}x{SLAM_HW[1]} (the sequence "
        f"export's shape, K={m['top_k']}, no subpixel): {slam_ms:.3f} ms/image by CUDA "
        f"events")

    # the three kernels at the export's 1×240×320, each against its plain
    # version first
    times = conv_nms_times(ss, img, dev)
    torch.cuda.synchronize()
    return launches, times


def evaluate_phase(dev: torch.device, td: Path) -> dict:
    """Phase 13: the stage-4 evaluation and the checkpoint sweep, on phase
    12's corpus and exports under ``td``; MagicLeap SuperPoint on the card.
    Returns the sweep's launches per kernel."""
    from ssp_torch.cli import export_eval
    from ssp_torch.cli.evaluate import evaluate
    from ssp_torch.evaluations import homography_fit

    n_pairs = HP_SEQ * len(HP_VIEWS)
    fit_s = [0.0]
    fit = homography_fit.find_homography

    def timed_fit(src, dst):  # the host seconds of the RANSAC fit, read beside the total
        t0 = time.perf_counter()
        try:
            return fit(src, dst)
        finally:
            fit_s[0] += time.perf_counter() - t0

    homography_fit.find_homography = timed_fit
    try:
        # both exports of phase 12 through the evaluation, the kernels' twice
        summaries, host_s, fit_share = {}, {}, {}
        kernel_dir = td / "logs" / "smoke" / "predictions"
        for name, out in (("kernels", kernel_dir), ("plain", td / "plain")):
            fit_s[0] = 0.0
            t0 = time.perf_counter()
            summaries[name] = evaluate(out)
            host_s[name] = (time.perf_counter() - t0) / n_pairs
            fit_share[name] = fit_s[0] / n_pairs / host_s[name]
        with np.load(kernel_dir / "result.npz") as z:
            first = {k: z[k] for k in z.files}
        again = evaluate(kernel_dir)
        with np.load(kernel_dir / "result.npz") as z:
            if set(z.files) != set(first) or \
                    not all(np.array_equal(z[k], first[k]) for k in z.files):
                raise AssertionError("a second evaluation of the same files differs")
        if again != summaries["kernels"]:
            raise AssertionError(f"evaluation not deterministic: {again} vs {summaries['kernels']}")
        log(f"[evaluate] column: kernels / plain versions ({n_pairs} pairs, phase 12's exports)")
        for k, v in summaries["kernels"].items():
            log(f"[evaluate]   {k}: {v} / {summaries['plain'][k]}")
        log(f"[evaluate] host seconds per pair: kernels' export {host_s['kernels']:.4f} (fit "
            f"{fit_share['kernels']:.4f} of it), plain {host_s['plain']:.4f} (fit "
            f"{fit_share['plain']:.4f}); a second evaluation gives an equal result.npz")
        got, want = summaries["kernels"], summaries["plain"]
        worst = {k: abs(got[k] - want[k]) for k in got if k != "n_files"}
        bars = {**{k: EVAL_BARS[k] for k in ("repeatability", "matching_score", "nn_map",
                                             "localization_err")},
                **{k: EVAL_BARS["correctness_pairs"] / n_pairs for k in got
                   if k.startswith("correctness_")}}
        over = {k: (worst[k], bars[k]) for k in bars if worst[k] > bars[k] + 1e-12}
        if got["n_files"] != n_pairs or over:
            raise AssertionError(f"kernels against plain versions over the bars: {over}")

        # the sweep through the CLI's function, counted
        folder = td / "ckpts"
        folder.mkdir()
        for it in (1000, 2000):
            shutil.copy(NPZ, folder / f"superPointNet_{it}.npz")
        broken = read_state_dict(NPZ, HPATCHES_CONFIG["model"]["name"])
        del broken["convDb.bias"]
        torch.save({"model_state_dict": broken, "n_iter": 1500},
                   folder / "superPointNet_1500_checkpoint.pth.tar")
        config = {**HPATCHES_CONFIG, "model": {**HPATCHES_CONFIG["model"], "folder": str(folder)}}
        eval_s = [0.0]
        evaluate_fn = export_eval.evaluate

        def timed_evaluate(path):
            t0 = time.perf_counter()
            try:
                return evaluate_fn(path)
            finally:
                eval_s[0] += time.perf_counter() - t0

        export_eval.evaluate = timed_evaluate
        fit_s[0] = 0.0
        reset_launches()
        t0 = time.perf_counter()
        try:
            csv_path = export_eval.sweep(config, "sweep", device=dev)
        finally:
            export_eval.evaluate = evaluate_fn
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        homography_fit.find_homography = fit
    want_launches = 2 * n_pairs * 2
    log(f"[evaluate] sweep of 2 readable checkpoints and a broken one: {sweep_s:.2f} s, "
        f"{sweep_s / 2:.2f} s per readable checkpoint (export {(sweep_s - eval_s[0]) / 2:.2f}, "
        f"evaluation {eval_s[0] / 2:.2f}, of which the fit {fit_s[0] / 2:.2f}); launches "
        f"{launches} (stem, down1 and nms {want_launches} each = 2 per pair per checkpoint)")
    if any(launches[k] != want_launches for k in ("stem", "down1", "nms")) or \
            launches["vresample"] or launches["vresample_coef"]:
        raise AssertionError(f"sweep launches {launches}")
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        header, rows = reader.fieldnames, list(reader)
    with open(csv_path.with_name("results_ref.csv"), newline="") as f:
        ref_header = next(csv.reader(f))
    if header != export_eval.CSV_FIELDS or ref_header != export_eval.REF_CSV_FIELDS:
        raise AssertionError(f"CSV headers {header}, {ref_header}")
    by_iter = {r["iter"]: {k: float(v) for k, v in r.items() if k != "iter"} for r in rows}
    if sorted(by_iter) != ["1000", "1500", "2000"] or any(by_iter["1500"].values()):
        raise AssertionError(f"sweep rows {rows}")
    export_row = {k: float(summaries["kernels"][k]) for k in export_eval.CSV_FIELDS[1:]}
    if not by_iter["1000"] == by_iter["2000"] == export_row:
        raise AssertionError(f"rows 1000 {by_iter['1000']} and 2000 {by_iter['2000']} against "
                             f"phase 12's export {export_row}")
    log("[evaluate] rows 1000 and 2000 equal each other and the evaluation of phase 12's "
        "export; row 1500 (a state dict without convDb.bias) is zeros; both headers are "
        "the JAX package's")

    # MagicLeap SuperPoint, seeded weights: the card against the CPU, then an export
    ml_cpu = build_model("SuperPointNet_pretrained", device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    hh, hw = HPATCHES_CONFIG["data"]["preprocessing"]["resize"]
    x = torch.from_numpy(structured_images(1, hh, hw, SEED + 9))
    ml = copy.deepcopy(ml_cpu).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want_ml, got_ml = ml_cpu(x), ml(x.to(dev))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ml_err = {k: float((got_ml[k].cpu() - want_ml[k]).abs().max()) for k in ("semi", "desc")}
    if max(ml_err.values()) > ML_ATOL:
        raise AssertionError(f"MagicLeap on the card against the CPU: {ml_err}")
    pth = td / "superpoint_v1.pth"
    torch.save(ml_cpu.state_dict(), pth)
    four = td / "HPatches4"
    four.mkdir()
    for seq in sorted((td / "HPatches").iterdir())[:2]:
        (four / seq.name).symlink_to(seq, target_is_directory=True)
    ml_config = {"data": {**HPATCHES_CONFIG["data"], "root": str(four)},
                 "model": {**{k: v for k, v in HPATCHES_CONFIG["model"].items()
                              if k not in ("params", "folder")},
                           "name": "SuperPointNet_pretrained"},
                 "pretrained": str(pth)}
    reset_launches()
    written = export_descriptor(ml_config, "magicleap", device=dev)
    torch.cuda.synchronize()
    ml_launches = read_launches()
    if written != 4 or ml_launches != {"stem": 0, "down1": 0, "nms": 8, "vresample": 0,
                                       "vresample_coef": 0}:
        raise AssertionError(f"MagicLeap export: {written} pairs, launches {ml_launches}")
    m = HPATCHES_CONFIG["model"]
    ml_dd = make_detect_describe_fn(best_apply_fn(ml, input_hw=(hh, hw), device=dev), device=dev,
                                    top_k=m["top_k"], conf_thresh=m["detection_threshold"],
                                    nms_radius=m["nms"], subpixel=m["subpixel"]["enable"],
                                    patch_size=m["subpixel"]["patch_size"])
    img = x[0, ..., 0].to(dev)
    ml_ms = time_ms(lambda: ml_dd(img), iters=20)
    log(f"[evaluate] MagicLeap (seeded weights) at 1x{hh}x{hw}: card vs CPU with TF32 off, "
        f"max abs err semi {ml_err['semi']:.3g}, desc {ml_err['desc']:.3g} (bar {ML_ATOL}); "
        f"export_descriptor of 4 pairs: launches {ml_launches}; detect+describe "
        f"{ml_ms:.3f} ms/image by CUDA events")
    return launches


def imageio_phase(td: Path) -> None:
    """Phase 14 [imageio]: the host decoder on the card's machine, which has
    no OpenCV.  Every committed fixture decodes to the hash of OpenCV's
    decode in its manifest; seeded RGB and gray frames written by
    :func:`write_png` read back exactly (RGB as libpng's luma of them); ms
    per image of decoding, by the host clock."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    for name, entry in sorted(manifest.items()):
        img = imageio.decode_gray(FIXTURES / name)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        if list(img.shape) != entry["shape"] or digest != entry["sha256"]:
            raise AssertionError(f"{name}: decoded {img.shape} {digest}, manifest {entry}")
    log(f"[imageio] {len(manifest)} fixtures decode to their manifest's hashes: "
        f"{', '.join(sorted(manifest))}")
    rng = np.random.default_rng(SEED + 10)
    for shape in ((*KITTI_RAW, 3), (240, 320)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        write_png(td / "roundtrip.png", img)
        got = imageio.decode_gray(td / "roundtrip.png")
        if img.ndim == 3:
            r, g, b = (img[..., c].astype(np.int64) for c in range(3))
            img = ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
        if not np.array_equal(got, img):
            raise AssertionError(f"PNG round trip of a {shape} frame: "
                                 f"{int((got != img).sum())} pixels differ")
    log(f"[imageio] seeded {KITTI_RAW[0]}x{KITTI_RAW[1]} RGB and 240x320 gray frames, "
        f"written with every row filter, read back exactly")
    for name in ("ycc420_480x640_q90.jpg", "rgb_375x1242.png", "gray_240x320_q96.jpg"):
        imageio.decode_gray(FIXTURES / name)
        t0 = time.perf_counter()
        for _ in range(20):
            imageio.decode_gray(FIXTURES / name)
        log(f"[imageio] decode {name}: {(time.perf_counter() - t0) / 20 * 1e3:.3f} ms per "
            f"image by the host clock (one thread)")
    # the decoder's calls release the GIL (ctypes, zlib): threads scale it
    from concurrent.futures import ThreadPoolExecutor

    paths = [FIXTURES / "ycc420_480x640_q90.jpg", FIXTURES / "rgb_375x1242.png"] * 16
    rates = {}
    for threads in (1, 4):
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            list(pool.map(imageio.decode_gray, paths))
            rates[threads] = len(paths) / (time.perf_counter() - t0)
    log(f"[imageio] {len(paths)} decodes (the JPEG and the PNG, alternating): "
        f"{rates[1]:.1f} img/s on 1 thread, {rates[4]:.1f} img/s on 4 threads "
        f"({rates[4] / rates[1]:.2f}x)")


def sequence_phase(dev: torch.device, td: Path):
    """Phase 15 [sequence]: the SLAM sequence export through the CLI on a
    KITTI tree written under ``td`` (SEQ_DRIVES drives of SEQ_FRAMES color
    PNG frames at KITTI_RAW), against the same export on the kernels' plain
    versions; its throughput and where a frame's time goes; the kernels at
    1×384×1248.  Returns (launches of the CLI's export, {kernel: times})."""
    root = td / "kitti"
    t0 = time.perf_counter()
    drives = [f"2011_09_26_drive_{d + 1:04d}_sync" for d in range(SEQ_DRIVES)]
    for d, drive in enumerate(drives):
        out = root / drive / "image_02" / "data"
        out.mkdir(parents=True)
        frames = structured_images(SEQ_FRAMES, *KITTI_RAW, SEED + 20 + d)[..., 0]
        for i, frame in enumerate(frames):
            gray = (frame * 255).astype(np.uint8)
            write_png(out / f"{i:010d}.png",
                      np.stack([gray, np.roll(gray, 3, axis=1), gray // 2 + 64], axis=-1))
    (root / "train.txt").write_text("".join(f"{d}\n" for d in drives))
    log(f"[sequence] corpus: {SEQ_DRIVES} drives x {SEQ_FRAMES} frames, {KITTI_RAW[0]}x"
        f"{KITTI_RAW[1]} RGB PNG, written in {time.perf_counter() - t0:.1f} s")
    config = copy.deepcopy(SEQUENCE_CONFIG)
    config["data"]["root"] = config["data"]["root_split_txt"] = str(root)
    config["pretrained"] = str(ROOT / config["pretrained"])
    m, hw = config["model"], tuple(config["data"]["preprocessing"]["resize"])
    dataset = KittiDataset(task="train", root=root, root_split_txt=root,
                           preprocessing={"resize": list(hw)})
    n = len(dataset)
    ss = load_flax_npz(NPZ, m["name"], device=dev)
    dd_kw = dict(top_k=m["top_k"], conf_thresh=m["detection_threshold"], nms_radius=m["nms"],
                 subpixel=False)
    dd = make_detect_describe_fn(best_apply_fn(ss, input_hw=hw, device=dev), device=dev, **dd_kw)
    dd(torch.from_numpy(dataset[0]["image"]))  # warm-up: cuDNN autotuning at 384×1248
    torch.cuda.synchronize()

    reset_launches()
    written = export_sequence(config, "sequence", device=dev)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[sequence] export_sequence: {written} frames; launches {launches} (stem, down1 and "
        f"nms {n} each = 1 per frame)")
    if written != n or any(launches[k] != n for k in ("stem", "down1", "nms")) or \
            launches["vresample"] or launches["vresample_coef"]:
        raise AssertionError(f"sequence export: {written} frames, launches {launches}")
    again = export_sequence(config, "sequence", device=dev)
    if again != 0:
        raise AssertionError(f"the second sequence export wrote {again} files")

    # the same export on the kernels' plain versions, frame by frame with
    # the main path's bars
    plain = make_detect_describe_fn(make_fast_apply(ss, device=dev, reference=True), device=dev,
                                    reference=True, **dd_kw)
    run_sequence_export(plain, dataset.images(), td / "sequence_plain")
    out_root = td / "logs" / "sequence" / "predictions" / "train"
    worst, counts = {"shared": 1.0, "strong_recall": 1.0, "cos": 1.0}, []
    for rec in dataset.frames:
        with np.load(out_root / f"{rec['name']}.npz") as a, \
                np.load(td / "sequence_plain" / f"{rec['name']}.npz") as b:
            got = [torch.from_numpy(a[k])[None].to(dev) for k in ("pts", "desc")]
            want = [torch.from_numpy(b[k])[None].to(dev) for k in ("pts", "desc")]
        if got[0].shape[1] == 0 or got[1].shape[2] != 256 or not torch.isfinite(got[1]).all():
            raise AssertionError(f"{rec['name']}: pts {tuple(got[0].shape)}, desc "
                                 f"{tuple(got[1].shape)}")
        w = agreement(got[0], got[1], want[0], want[1])
        worst = {k: min(worst[k], w[k]) for k in worst}
        counts.append(f"{got[0].shape[1]}/{want[0].shape[1]}")
    log(f"[sequence] points per frame, kernels/plain: {' '.join(counts)}")
    log(f"[sequence] vs the plain versions, worst of {n} frames: {worst['shared']:.4f} of the "
        f"points shared, {worst['strong_recall']:.4f} of the points over {STRONG} found, "
        f"descriptor cosine >= {worst['cos']:.6f}")

    # throughput by the host clock, and where a frame's time goes
    recorded = []

    def recording(image):
        out = dd(image)
        recorded.append(out)
        return out

    t0 = time.perf_counter()
    run_sequence_export(recording, dataset.images(), td / "sequence_timed")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = list(dataset.images())
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _, image in frames:  # the calls as the export makes them: host arrays in, copies back
        [t.cpu() for t in dd(image)]
    device_s = time.perf_counter() - t0
    replay = iter(recorded)
    t0 = time.perf_counter()
    run_sequence_export(lambda image: next(replay), frames, td / "sequence_replay")
    write_s = time.perf_counter() - t0
    ms = {k: v * 1e3 / n for k, v in (("export", export_s), ("decode", decode_s),
                                      ("calls", device_s), ("write", write_s))}
    log(f"[sequence] {n / export_s:.2f} frames/s by the host clock ({ms['export']:.2f} ms/frame): "
        f"decode and resize {ms['decode']:.2f}, detect+describe with the copies "
        f"{ms['calls']:.2f}, npz write {ms['write']:.2f}, the rest "
        f"{ms['export'] - ms['decode'] - ms['calls'] - ms['write']:.2f} ms/frame")
    times = conv_nms_times(ss, torch.from_numpy(frames[0][1]).to(dev), dev)
    return launches, times


def ha_cli_phase(dev: torch.device, td: Path) -> dict:
    """Phase 16 [ha_cli]: stage-2 pseudo-labels through
    ``export_detector_homoAdapt`` on a COCO tree under ``td`` (the JPEG
    fixtures under HA_CLI_IMAGES twelve-digit names), against the same
    export on the kernels' plain versions; img/s with the decode's share.
    Returns the CLI's launches per kernel."""
    folder = td / "COCO" / "train2017"
    folder.mkdir(parents=True)
    jpegs = sorted(FIXTURES.glob("*.jpg"))
    stems = [f"{139 + 4099 * i:012d}" for i in range(HA_CLI_IMAGES)]
    for i, stem in enumerate(stems):
        shutil.copy(jpegs[i % len(jpegs)], folder / f"{stem}.jpg")
    config = {**HA_CLI_CONFIG, "pretrained": str(ROOT / HA_CLI_CONFIG["pretrained"])}
    m, ha_cfg = config["model"], config["data"]["homography_adaptation"]
    hw = tuple(config["data"]["preprocessing"]["resize"])
    n = len(stems)

    reset_launches()
    t0 = time.perf_counter()
    written = export_detector_homoAdapt(config, "ha_cli", device=dev)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    # from the code, per image (group 1, one chunk of 100 warps): two coef
    # passes for the warp stack and two for the heatmaps' back-warp, one
    # forward, one NMS
    per_image = {"stem": 1, "down1": 1, "nms": 1, "vresample": 0, "vresample_coef": 4}
    log(f"[ha_cli] export_detector_homoAdapt: {written} images in {cli_s:.2f} s with the model "
        f"load; launches {launches}, per image {({k: v / n for k, v in launches.items()})}")
    if written != n or launches != {k: v * n for k, v in per_image.items()}:
        raise AssertionError(f"HA CLI: {written} images, launches {launches}")
    exper = td / "logs" / "ha_cli"
    files = sorted(p.relative_to(exper / "predictions").as_posix()
                   for p in (exper / "predictions").rglob("*.npz"))
    audit = f"load model: {config['pretrained']}\nhomography adaptation: {ha_cfg['num']}\n"
    if files != [f"train2017/{s}.npz" for s in stems] or \
            (exper / "export.txt").read_text() != audit:
        raise AssertionError(f"HA CLI layout: {files}, {(exper / 'export.txt').read_text()!r}")
    again = export_detector_homoAdapt(config, "ha_cli", device=dev)
    if again != 0 or (exper / "export.txt").read_text() != audit * 2:
        raise AssertionError(f"the second HA export wrote {again} files")

    # the same export on the kernels' plain versions, the same homographies
    model = load_flax_npz(NPZ, m["name"], device=dev)
    ha_plain = make_ha_fn(make_fast_apply(model, device=dev, reference=True), reference=True,
                          device=dev, num_h=ha_cfg["num"],
                          homography_params=ha_cfg["homographies"]["params"],
                          aggregation=ha_cfg["aggregation"], filter_counts=ha_cfg["filter_counts"],
                          top_k=m["top_k"], conf_thresh=m["detection_threshold"],
                          nms_radius=m["nms"], subpixel=m["subpixel"]["enable"],
                          patch_size=m["subpixel"]["patch_size"])
    dataset = CocoDataset(task="train", preprocessing={"resize": list(hw)})
    run_ha_export(ha_plain, dataset.images(), td / "ha_plain", seed=config.get("seed", 0),
                  group=1)
    worst, counts = 1.0, []
    for stem in stems:
        with np.load(exper / "predictions" / "train2017" / f"{stem}.npz") as a, \
                np.load(td / "ha_plain" / f"{stem}.npz") as b:
            p, q = torch.from_numpy(a["pts"])[None], torch.from_numpy(b["pts"])[None]
        if not torch.isfinite(p).all():
            raise AssertionError(f"{stem}: non-finite points")
        worst = min(worst, same_points(p, torch.ones(p.shape[:2], dtype=torch.bool), q,
                                       torch.ones(q.shape[:2], dtype=torch.bool)))
        counts.append(f"{p.shape[1]}/{q.shape[1]}")
    log(f"[ha_cli] points per image, kernels/plain: {' '.join(counts)}; worst image: "
        f"{worst:.4f} of the valid keypoints within {SAME_PX} px of the plain export's")
    if worst < SHARED_MIN:
        raise AssertionError(f"HA CLI points: {worst:.4f} shared < {SHARED_MIN}")

    t0 = time.perf_counter()
    export_detector_homoAdapt(config, "ha_cli_timed", device=dev)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    list(dataset.images())
    decode_s = time.perf_counter() - t0
    log(f"[ha_cli] {n / timed_s:.2f} img/s by the host clock over a second export with the "
        f"model load ({timed_s * 1e3 / n:.2f} ms/image); decode and resize "
        f"{decode_s * 1e3 / n:.2f} ms/image, {decode_s / timed_s:.4f} of the time")
    return launches


if __name__ == "__main__":
    sys.exit(main())
