"""Smoke run of the PyTorch port (``ssp_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA card, the
CUDA toolkit and PyTorch built for CUDA.  It imports nothing of JAX and
nothing of the JAX package ``ssp``.  Phases, each of which raises on
failure (nothing is caught):

1. the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from ``ssp_torch/csrc`` (one ``nvcc`` per
   source) and the host libraries (the image decoder, the JPEG encoder, the
   rasteriser, the host ops, SIFT and ORB: ``*_host.cpp``, ``g++``), all
   started together,
   and prints the build seconds of each;
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
    fixture of ``tests/data/torch_imageio`` (arithmetic-coded, lossless and
    cut JPEG and a PNG with a bad ancillary CRC among them) decodes to the
    hash of OpenCV's decode in its ``manifest.json``; seeded 375×1242 RGB
    and 240×320 gray frames written by :func:`write_png` (each row's filter
    cycling through 0-4) read back exactly; ms per image of decoding by the
    host clock (``scripts/bench_imageio.py``'s ``decode_ms``), each new form
    beside its baseline with the card's name and power limit;
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
16. ``[ha_cli]``, stage-2 pseudo-labels: ``HA_CLI_FIXTURES`` under 16
    twelve-digit names in ``SSP_DATA_PATH/COCO/train2017`` through
    ``export_detector_homoAdapt`` with ``HA_CLI_CONFIG``
    (``configs/magicpoint_coco_export.yaml`` with the trained weights:
    ``SuperPointNet_gauss2``, 100 warps, ``sum``, top-600, NMS 4, subpixel),
    one image per call.  Launch counts from 0, per image: the stem, down1
    and NMS once, ``vresample_coef`` 4 times.  The layout
    (``predictions/train2017/<stem>.npz``, ``export.txt``), a second call
    that writes nothing, the points against the same export on the plain
    versions (≥ SHARED_MIN within SAME_PX), img/s by the host clock with the
    decode's share;
17. ``[train]``, stage-3 joint training: a ``Coco_sem`` tree of phase 16's
    JPEGs and pseudo-labels (8 of them again as the val split) with seeded
    panoptic PNGs (rectangles of the 133 classes on the ignore id, written
    by :func:`write_png`), and ``python -m ssp_torch.cli.train train_joint``
    on ``TRAIN_CONFIG`` (the flagship: ``Coco_sem`` at 240×320, B=16,
    ssmall-133, photometric, warped pair, sparse 1000×100, fused CE,
    Kendall, Adam, the corpus on the card) in the smoke's own copy with
    ``TRAIN_RUN``'s schedule, the trained weights and one step per dispatch.
    Launch counts from 0: ``vresample_coef`` 4 per prepared batch (training
    and validation), NMS twice per validation (its heatmap images of the
    base and the warped view), the ordered scatter-add
    (``csrc/ordered_scatter.cu``, the backward of the sparse loss's gathers)
    SCATTER_PER_STEP times per training step, no other kernel; every other
    phase counts the ordered scatter too.  Every logged loss finite, the rows
    and checkpoint names at their boundaries.  A step on the kernel against
    one on the plain versions from the same state, batch and draws (warped
    images within VRES_TOL, class ids within TRAIN_LABEL_FLIPS, metrics
    within TRAIN_REL); steps/s and img/s over TRAIN_TIMED steps by CUDA
    events and by the host clock, the shares of ``prepare_batch``,
    forward+backward and Adam, device time by operation and the idle share
    under ``torch.profiler``, host syncs per step by call site, peak
    memory; ``vresample_coef`` against its plain version and timed at the
    training shapes; the last npz reloaded through ``load_weights`` and
    detect+describe run on it.  Two eager steps from one state equal bit for bit with ``torch.use_deterministic_algorithms``
    off (metrics, parameters, BatchNorm statistics, ηs, Adam's moments); the
    ordered scatter on that step's own inputs (the descriptor taps, 16×4000×256
    into 1200 cells, and the match rows, 16×1000×256) equal to its plain
    version run on the host bit for bit, and (``sorted`` and ``reversed``)
    on the same indices sorted and reversed along k; its device ms (a CUDA
    graph of 50 captured calls, replayed) and its eager ms (50 eager calls)
    beside ``scatter_add``'s read the same two ways, the plain version's
    and its bound.
18. ``[synth]``, stage 1, MagicPoint pretraining on Synthetic Shapes: the
    generator (``ssp_torch.data.synthetic_shapes``, drawn by the C++
    rasteriser) against the SHA-256 of ``SYNTH_MANIFEST``, which OpenCV's
    drawing gave the JAX package, with ms per sample by primitive; the
    ``SYNTH_CONFIG`` corpus (``configs/pipeline240_magicpoint.yaml``) cut to
    ``SYNTH_SPLITS`` samples per primitive and generated into
    ``SSP_DATA_PATH``; ``python -m ssp_torch.cli.train train_base`` on the
    config (gauss2 from scratch, 32×240×320, homographic and photometric,
    the detector loss alone, Adam, the corpus on the card as uint8) with
    ``SYNTH_RUN``'s schedule and one step per dispatch.  Launch counts from
    0: ``vresample_coef`` twice per prepared training batch (as counted on
    the CPU route), NMS once per validation (its image), no other kernel.
    Every logged loss finite, the detector loss at the last step below the
    first, the rows and checkpoint names.  A step on the kernel against one on the plain
    versions (images within VRES_TOL, metrics within TRAIN_REL); the
    steady-state rates by part, idle share and peak memory over
    SYNTH_TIMED steps (``steady_state``, as phase 17); the last npz
    reloaded through ``load_weights``, where detect+describe launches the
    stem, down1 and NMS once each; then ``SYNTH_JOINT_CONFIG``'s gauss2
    joint training (``superpoint_synth_joint_v4_240.yaml``: warped pair,
    sparse, Kendall) for a few steps on the same cache files, every loss
    finite and only ``vresample_coef`` and the validation images' NMS
    launched.

19. ``[train2]``, the rest of training, each path at full width and
    launch counts from 0 around its run: (a) ``train_joint`` on
    ``TRAIN_CONFIG`` with ``model.dense_loss`` on (``lambda_d`` 800,
    ``descriptor_dist`` 4), ``val_residual_diagnostic`` and ``profile`` on,
    ``TRAIN2_RUN``'s schedule on phase 17's tree (``vresample_coef`` 4 per
    prepared batch, NMS twice per validation for its images), every loss and
    ``val_subpix_residual_err`` finite, the trace file written, a step on the
    kernel against the plain versions (as phase 17), TRAIN2_TIMED
    steady-state steps; (b) the same with ``real_batch_size`` 32 and
    ``exact_accumulation`` (r = 2; the real batch prepared once per optimizer
    step: 4 ``vresample_coef``), ms per optimizer step over ACCUM_TIMED
    steps; (c) ``train_base`` on ``SYNTH_CONFIG`` as ``Train_model_subpixel``
    on ``SubpixelNet`` (32×240×320, bf16) on phase 18's cache, the mean of
    the last three ``loss_subpix`` below that of the first three, SUBPIX_TIMED
    steady-state steps, ``Val_model_subpixel.refine_points`` on the last
    checkpoint; (d) ``Val_model_heatmap`` on the trained weights over phase
    12's 64 images at 240×320 (the stem, down1 and NMS once each per image),
    held against itself on the plain versions with ``agreement``'s bars on
    all K points (subpixel off, as phase 12 holds its detections);
    (e) ``evaluate -o`` over a copy of phase 12's export, every PNG decoded by
    the port's decoder to the luma of the canvas drawn again.
20. ``[rest]``, deployment, data parallelism and the host ops: (a) the host
    ops of ``ssp_torch.native`` (C++ ``ops_host.cpp``, built by g++ in phase
    2): the greedy NMS on phase 12's heatmap of its first image at 240×320 and
    at twice that size, the two-way matcher on the main path's 1000×1000×256
    descriptors and the bilinear warp at 240×320, each held against its
    plain numpy version (the warp within VRES_TOL, the others exactly) and
    timed by the host clock; (b) ``python -m ssp_torch.cli.import_torch`` of
    the trained weights written as a reference ``.pth.tar``, then phase 12's
    ``export_descriptor`` on REST_PAIRS of its pairs from the imported
    checkpoint: the same files (points, descriptors, matches); (c)
    ``convert2script`` of ssmall-133 at 1×240×320 at fp32 and bf16, each
    program loaded back and held against the eager module (ART_ATOL at fp32
    with TF32 off, phase 5's bars at bf16), ms per image of the programs, the
    eager modules and ``best_apply_fn``'s kernel path; (d) the flagship step
    on REST_WORLD ranks of the one card over gloo (this script with
    ``--rest-rank``) against one process on the same prepared batch and draws
    (loss and Σ|p| within TRAIN_REL, the ηs equal on the ranks), one rank
    over NCCL at world size 1 against the same, ms per step of each over
    REST_TIMED steps with ``vresample_coef`` 4 per rank per step, and
    ``train_joint`` on the ranks for REST_RUN's schedule (rank 0 alone
    writes; NMS only on rank 0's validation images), then the mesh shrink:
    ``train_joint`` on SHRINK_WORLD ranks, which do not divide the global
    batch of 16, trains on the largest count that does (REST_WORLD), with
    those ranks' launches and metric rows equal to the REST_WORLD-rank run's
    (within TRAIN_REL), the other ranks idle with no launch, every rank
    exiting 0; (e)
    ``export_detector_homoAdapt`` on REST_WORLD ranks of the one card over
    phase 16's images: the same files as phase 16's one process, each written
    once, the points within HA_MULTI_MAX, every rank launching the stem,
    down1, NMS and ``vresample_coef``, img/s.

21. ``[classical]``, the classical SIFT/ORB baselines: (a) the port's SIFT
    and ORB (C++ ``features_host.cpp``, built by g++ in phase 2) on the four
    fixture images of ``tests/data/torch_classical``: every keypoint and
    descriptor byte equal to OpenCV's portable-path SIFT and its ORB,
    host ms per image; (b) the cross-checked matcher kernel
    (``csrc/bfmatch.cu``) against its plain version, exactly, on the
    fixtures' descriptors and on 1000×1000 SIFT (128 B) and ORB (32 B) rows
    with shared and duplicate rows (ties), on two rows whose squared
    distances share a float root, on rows of 4 and 124 bytes, an empty
    side; its device ms (a CUDA graph of 50 captured calls) and eager ms
    beside the plain version's and its bound, its device operations per
    call under ``torch.profiler`` (one kernel, no memset), and the count of
    tensor-core opcodes (``IMMA``, ``BMMA``) in its library where
    ``cuobjdump`` is present; (c) ``export_classical`` for ``sift`` and
    ``orb`` (``configs/classical_descriptors.yaml``) over phase 12's corpus:
    the launch counts set to 0 before each export and read after (the
    matcher once per pair with keypoints on both sides, the six kernels of
    the TPU package never), a second call writes nothing, the files equal
    those of the same export on the CPU, the port's ``evaluate`` of each,
    pairs/s by the host clock split into decode and resize, detection,
    match and npz write.

22. ``[dispatch]``, the JAX package's single-program dispatches as CUDA
    graphs (``ssp_torch.graphs``), on the trained weights: (a) bench_ha's
    group (8×240×320, 100 warps, ``configs/magicpoint_coco_export.yaml``'s
    settings) through ``make_ha_fn(..., one_dispatch=True)``, one graph per
    group, against the staged group on the same homographies (valid flags
    equal, points within HA_ONE_DISPATCH_MAX), two replays and the same
    chain run eagerly equal bit for bit; ms per group both ways by CUDA
    events and the host clock, in the order staged, graph, graph, staged,
    the host's queueing and its prologue alone, the capture's ms and the
    graph pool; (b) ``export_detector_homoAdapt`` with ``one_dispatch`` over
    phase 16's images: the same files; (c) the flagship on phase 17's tree
    and (d) stage 1 on phase 18's corpus, each with the device corpus, and
    (e) the flagship on phase 17's tree through the host loader (the train
    CLI's ``Prefetcher`` of ``batches``: the JAX trainer's
    ``multi_train_step``, each batch copied into the graph's static inputs),
    each with DISPATCH_SPD steps per dispatch, the graphed loop against the
    eager one (``eager=True``) from the same state and seeds: one untimed
    turn, then DISPATCH_TIMED timed steps and one profiled turn, ms/step,
    the host's wait for the loader per step, the idle share and peak memory
    of each; equal (largest absolute difference 0) in every turn's metrics,
    the parameters, the BatchNorm statistics and the ηs, both as they run
    (``torch.use_deterministic_algorithms`` off) and under it.  The kernel
    wrappers' counters do not see a replay: the graphs' launches are those
    counted at the capture times the replays.

23. ``[tools]``, the port's evaluation tools, each with launch counts from
    0: ``python -m ssp_torch.cli.eval_sequence --pred`` over phase 15's
    export, ``eval_sequence --synthetic`` (TOOLS_SYNTH_FRAMES frames at
    240×320 on the trained weights, the fp32 module: NMS once per frame),
    ``eval_semantic`` over phase 17's val split with the weights it trained
    (the folded bf16 forward: the stem and down1 once per batch), and
    ``run_export`` (``export_descriptor`` then ``evaluate -r -homo``) over
    phase 12's tree with the trained weights; each tool's metrics (finite,
    the expected counts) and seconds.
24. ``[corpus]``, the corpus tools and the stand-in pipeline on their
    trees (``corpus_phase``): ``ssp_torch.cli.make_coco_tree`` and
    ``make_gt_labels`` at the split sizes of
    ``tests/data/torch_corpus/manifest.json`` (28 + 15 images),
    ``make_coco_sem_labels``, ``make_synth_hpatches`` (40 × 2) and
    ``make_kitti_tree`` (2 + 1 drives × 10 frames at 384×1248, static and
    ``--motion``) at their defaults, each tree equal to the manifest's
    digests of the JAX scripts' trees (JPEG, PPM and text files by their
    bytes, PNG by its pixels, npz by its arrays); then
    ``export_detector_homoAdapt`` on ``configs/pipeline240_export.yaml`` and
    ``_val.yaml`` (every image of each split, 100 warps), ``train_joint`` on
    ``configs/pipeline240_joint_wsem.yaml`` cut by CORPUS_TRAIN, on the HA
    labels and on the oracle labels, ``export_eval`` on
    ``configs/pipeline240_sweep.yaml`` over the 80 synthetic pairs (one CSV
    row per checkpoint, each exported), ``export_sequence`` and
    ``eval_sequence --pred`` on the ``--motion`` tree against its
    ``rel_H.json``; each stage's seconds, the phase's, and its launches
    (stem, down1, NMS and ``vresample_coef`` must each launch).

Prints a ``{"kernels": [...]}`` line (each row also with the launches of
phase 12's export, ``launches_export``, of phase 13's sweep,
``launches_sweep``, of phases 15, 16, 17 and 18, ``launches_sequence``,
``launches_ha_cli``, ``launches_train`` and ``launches_synth``, of
phase 18's reload, ``launches_synth_reload``, of phase 19's four runs,
``launches_dense``, ``launches_accum``, ``launches_subpixel`` and
``launches_val_agent``, and of phase 20, ``launches_rest``: (b)'s export,
(d)'s timed steps and train CLI on every rank and (e)'s export on every
rank, and of phase 21, ``launches_classical``, all 0, and of phase 22,
``launches_dispatch_ha``, ``launches_dispatch_ha_cli``,
``launches_dispatch_train``, ``launches_dispatch_synth`` and
``launches_dispatch_loader``, of phase 23,
``launches_tools``, and of phase 24, ``launches_corpus``; then the ordered scatter's entry (the same keys; its
``launches`` those of phase 17's CLI run, its times at the descriptor taps'
shape, every shape's beside them) and the matcher's, which replace no TPU
kernel; for the stem, down1 and NMS
their times at 1×240×320, ``export_1x240x320``, and at 1×384×1248,
``sequence_1x384x1248``; for ``vresample_coef`` its time at the training
shapes, ``train_16x320x320``), then the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import gc
import hashlib
import importlib.util
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import yaml
from torch.profiler import ProfilerActivity, profile

from ssp_torch.bench import (BATCH, BORDER, NMS_RADIUS, PEAK_BF16, PEAK_FP32, TOP_K, H, W,
                             bound, build_pipeline, structured_images)
from ssp_torch import bench_ha
from ssp_torch.bench_own_kernels import (MATCHER_ROWS, check_matcher, matcher_cases,
                                         matcher_rows, scatter_rows)
from ssp_torch.cli import train as train_cli
from ssp_torch.cli.export import export_descriptor, export_detector_homoAdapt, export_sequence
from ssp_torch.core.grid import flatten_detection
from ssp_torch.core.homography import inv3, sample_homographies
from ssp_torch.core.warp import inv_warp_image
from ssp_torch.data import imageio
from ssp_torch.data.base import write_pnm
from ssp_torch.data.coco import CocoDataset
from ssp_torch.data.coco_labels import PANOPTIC_IDS
from ssp_torch.data.hpatches import PatchesDataset
from ssp_torch.data.kitti import KittiDataset
from ssp_torch.data.photometric import draw_photometric
from ssp_torch.data.prefetch import Prefetcher
from ssp_torch.data.pipeline import prepare_batch
from ssp_torch.data.synthetic_shapes import generate_sample
from ssp_torch.export.descriptors_export import (make_detect_describe_fn, run_descriptor_export,
                                                 run_sequence_export)
from ssp_torch.export.homography_adaptation import DEFAULT_HA, make_ha_fn, run_ha_export
from ssp_torch.kernels import _build
from ssp_torch.kernels import bfmatch as bfmatch_mod
from ssp_torch.losses.descriptor_sparse import SparseDraws, cell_matches, sample_draws
from ssp_torch.kernels import down1 as down1_mod
from ssp_torch.kernels import nms as nms_mod
from ssp_torch.kernels import ordered_scatter as osc_mod
from ssp_torch.kernels import stem as stem_mod
from ssp_torch.kernels import vresample as vres_mod
from ssp_torch.kernels import warp_twopass
from ssp_torch.models.fast_infer import (accumulator_errors, best_apply_fn, fold_variables,
                                         make_fast_apply)
from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import load_flax_npz, load_weights, read_state_dict
from ssp_torch import graphs, registry
from ssp_torch.train import train_step
from ssp_torch.train.subpixel_agent import SubpixelValAgent, subpixel_losses
from ssp_torch.train.val_agent import ValAgent
from ssp_torch.utils.draw import draw_keypoints, draw_matches
from ssp_torch.cli.evaluate import evaluate
from ssp_torch.cli import eval_semantic, eval_sequence
from ssp_torch.cli import run_export as run_export_cli

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
HA_CLI_IMAGES = 16  # the stage-2 corpus: HA_CLI_FIXTURES (each at least once) under 16 COCO names
# the JPEG fixtures of the forms a COCO download holds (not the arithmetic,
# lossless and cut files): phases 16, 17, 20 and 22 train and export on them
HA_CLI_FIXTURES = ("cmyk_120x160_q90.jpg", "exif6_120x160_q90.jpg", "gray_240x320_q96.jpg",
                   "prog420_rst5_240x320_q85.jpg", "prog_gray_120x160_q90.jpg",
                   "rgbcoded_120x160_q90.jpg", "ycc420_480x640_q90.jpg",
                   "ycc420_odd_239x321_q90.jpg", "ycc420_optimized_240x320_q85.jpg",
                   "ycc444_rst4_120x160_q90.jpg")
SLAM_HW = (384, 1248)  # the SLAM sequence export's shape (configs/kitti384_sequence_r5.yaml)
# phase 21: OpenCV's SIFT and ORB on four images, written by
# scripts/make_classical_fixtures.py (the matcher's cases: bench_own_kernels)
CLASSICAL_FIXTURES = ROOT / "tests" / "data" / "torch_classical"

# phase 17: the flagship training configuration, run for TRAIN_RUN's schedule,
# then TRAIN_TIMED steady-state steps
TRAIN_CONFIG = ROOT / "configs" / "pipeline240_wsem_200k.yaml"
TRAIN_RUN = {"train_iter": 40, "validation_interval": 20, "save_interval": 20,
             "tensorboard_interval": 10}
TRAIN_TIMED = 20
# the ordered scatter (csrc/ordered_scatter.cu) per training step of the
# sparse loss: the backward of its bilinear taps of each view and of its
# match rows
SCATTER_PER_STEP = 3
# phase 18: stage 1 (configs/pipeline240_magicpoint.yaml) on a corpus cut to
# SYNTH_SPLITS samples per primitive, SYNTH_RUN's schedule, then SYNTH_TIMED
# steady-state steps; the generator against the manifest made with OpenCV
SYNTH_CONFIG = ROOT / "configs" / "pipeline240_magicpoint.yaml"
SYNTH_MANIFEST = ROOT / "tests" / "data" / "torch_synth" / "manifest.json"
SYNTH_SPLITS = {"training": 64, "validation": 8, "test": 8}
SYNTH_RUN = {"train_iter": 40, "validation_interval": 20, "save_interval": 20,
             "tensorboard_interval": 1}
SYNTH_TIMED = 20
# ... and SYNTH_JOINT_CONFIG's gauss2 joint training (warped pair, sparse,
# Kendall) on the same cut corpus (the same cache files) for a few steps
SYNTH_JOINT_CONFIG = ROOT / "configs" / "superpoint_synth_joint_v4_240.yaml"
SYNTH_JOINT_RUN = {"train_iter": 5, "validation_interval": 5, "save_interval": 5,
                   "tensorboard_interval": 1}
# phase 19: the rest of training.  (a) the flagship with the dense loss for
# TRAIN2_RUN's schedule (its validation with the residual diagnostic and the
# images, a profile of TRAIN2_PROFILE steps), then TRAIN2_TIMED steady-state
# steps; (b) the same with exact accumulation over r = 2 micro-batches,
# ACCUM_RUN then ACCUM_TIMED steps; (c) SubpixelNet on the stage-1 config,
# SUBPIX_RUN then SUBPIX_TIMED steps; (d) Val_model_heatmap over phase 12's
# images; (e) evaluate -o over phase 12's export
TRAIN2_RUN = {"train_iter": 10, "validation_interval": 10, "save_interval": 10,
              "tensorboard_interval": 5}
TRAIN2_PROFILE = 3
TRAIN2_TIMED = 20
ACCUM_RUN = {"train_iter": 5, "validation_interval": 5, "save_interval": 5,
             "tensorboard_interval": 1, "validation_size": 0}
ACCUM_TIMED = 10
SUBPIX_RUN = {"train_iter": 10, "validation_interval": 10, "save_interval": 10,
              "tensorboard_interval": 1}
SUBPIX_TIMED = 20
# a train step on the kernel against one on the kernels' plain versions, same
# state, batch and draws: the warped images within VRES_TOL of max|img|; at
# most this share of the warped class ids inside the mask changed (a bilinear
# float within an ulp of an integer truncates either way) ...
TRAIN_LABEL_FLIPS = 1e-3
# ... and every metric within this relative difference (bf16 forwards of
# inputs that differ by an ulp here and there: a few roundings flip)
TRAIN_REL = 5e-3

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
# phase 20 [rest]: (b) phase 12's export from the imported checkpoint on
# REST_PAIRS of its pairs; (d) the flagship step on REST_WORLD ranks of the one
# card against one process, REST_TIMED timed steps each, and the train CLI on
# the ranks for REST_RUN's schedule; (e) the HA CLI on REST_WORLD ranks
REST_PAIRS = 4
REST_WORLD = 2
# ... and the train CLI on SHRINK_WORLD ranks, which do not divide the
# flagship's global batch of 16: REST_WORLD of them train
SHRINK_WORLD = 3
REST_TIMED = 10
REST_RUN = {"train_iter": 4, "validation_interval": 4, "save_interval": 4,
            "tensorboard_interval": 1, "validation_size": 0}
# (c) the deployment program against the eager module at fp32, TF32 off: the
# fp32 forward bar of the port's parity tests (the same ops, algorithms may
# differ); at bf16 phase 5's REL_MAX and COS_MIN
ART_ATOL = 2e-4
# (e) the points of the multi-rank HA export against the one-process export:
# the bar of the JAX package's multi-process test (tests/test_multiproc.py)
HA_MULTI_MAX = 1e-5
# phase 22 [dispatch]: the HA group as one CUDA graph against the staged
# group on the same homographies, valid flags equal and points within the bar
# of the JAX package's own one_dispatch test (tests/test_export_eval.py: the
# chunks are summed in another order); the training loops with
# DISPATCH_SPD steps per dispatch, one untimed turn (its first WARMUP steps
# eager, then the capture), DISPATCH_TIMED timed steps and one profiled turn,
# the graphed loop against the eager one
HA_ONE_DISPATCH_MAX = 1e-4
DISPATCH_SPD = 10
DISPATCH_TIMED = 20
# phase 23 [tools]: the frames of eval_sequence --synthetic (the JAX tool's default)
TOOLS_SYNTH_FRAMES = 8
# phase 24 [corpus]: the corpus tools' trees against the manifest the JAX
# scripts wrote (the COCO tree and its oracle labels at the manifest's split
# sizes, the other tools at their defaults), then the stand-in chain of
# docs/REAL_DATA_RUNBOOK.md on them, each stage cut as these say
CORPUS_MANIFEST = ROOT / "tests" / "data" / "torch_corpus" / "manifest.json"
CORPUS_TRAIN = {"train_iter": 4, "save_interval": 2, "validation_interval": 4,
                "validation_size": 1, "tensorboard_interval": 1, "steps_per_dispatch": 1}


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


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # (x0, y0, dx, dy) of each interlace pass


def write_png(path: Path, img: np.ndarray, adam7: bool = False, srgb: bool = False) -> None:
    """uint8 [H, W] gray or [H, W, 3] RGB → an 8-bit PNG of those pixels, row
    y filtered with type y % 5, so that reading it back takes every filter:
    through the port's writer (which takes BGR, as ``cv2.imwrite``), or with
    ``adam7`` interlaced (each pass a sub-image filtered on its own) and with
    ``srgb`` an sRGB chunk (libpng then converts color to gray through the
    sRGB gamma)."""
    if not (adam7 or srgb):
        imageio.write_png(path, img if img.ndim == 2 else img[..., ::-1])
        return
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    passes = [img[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if adam7 else [img]
    raw = b"".join(imageio.filter_rows(p.reshape(p.shape[0], -1), ch) for p in passes if p.size)
    chunk = imageio.png_chunk
    path.write_bytes(
        imageio.PNG_MAGIC
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, int(adam7)))
        + (chunk(b"sRGB", b"\0") if srgb else b"")
        + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


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
    bfmatch_mod.launches = osc_mod.launches = 0


def read_launches() -> dict:
    """The launches of the five kernels that replace the TPU kernels and of
    the ordered scatter (phase 21 reads the matcher's beside them)."""
    return {"stem": stem_mod.launches, "down1": down1_mod.launches, "nms": nms_mod.launches,
            "vresample": vres_mod.launches, "vresample_coef": vres_mod.coef_launches,
            "ordered_scatter": osc_mod.launches}


def cudnn_weights(w, s, b):
    """HWIO bf16 kernel and folded scale/bias → (OIHW channels-last bf16
    with the scale folded in, bf16 bias)."""
    wf = (w.float() * s).permute(3, 2, 0, 1).to(torch.bfloat16)
    return wf.contiguous(memory_format=torch.channels_last), b.to(torch.bfloat16)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    # cuBLAS reads this when it starts: phase 22 runs its comparisons under
    # torch.use_deterministic_algorithms, which refuses cuBLAS without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    # ---- 1. the card -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    dev = torch.device("cuda")

    # ---- 2. build ----------------------------------------------------------
    seconds = _build.build_all()
    log(f"[build] {', '.join(_build.SOURCES)} built with nvcc in "
        f"{max(seconds[n] for n in _build.SOURCES):.1f} s; the host libraries "
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
                                                 *warp_twopass._keep_masks(torch.stack(bounds),
                                                                           S, dev))
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
        imageio_phase(td, smi)
        sequence_launches, sequence_times = sequence_phase(dev, td)
        ha_cli_launches = ha_cli_phase(dev, td)
        train = train_phase(dev, td, smi)
        synth = synth_phase(dev, td, smi)
        train2 = train2_phase(dev, td, smi)
        rest = rest_phase(dev, td, smi, desc)
        classical = classical_phase(dev, td, smi)
        dispatch = dispatch_phase(dev, td, smi)
        tools = tools_phase(dev, td, smi)
        corpus = corpus_phase(dev, td, smi)
    sc = train["scatter"]
    kernels.append({
        "name": "ordered_scatter", "route": "cuda", "source": "ssp_torch/csrc/ordered_scatter.cu",
        "replaces": "no TPU kernel: the backward of the sparse loss's gathers "
                    "(ssp/losses/descriptor_sparse.py, one-hot products and XLA scatters)",
        "tpu_counterpart": False, "launches": train["launches"]["ordered_scatter"],
        "max_abs_err": max(r["max_abs_err"] for r in sc["shapes"].values()),
        "ms": sc["ms"], "plain_ms": sc["plain_ms"], "bound_ms": sc["bound_ms"],
        "bound_by": sc["bound_by"], "library_ms": sc["library_ms"], "eager_ms": sc["eager_ms"],
        "library_eager_ms": sc["library_eager_ms"], "shape": sc["shape"],
        "shapes": sc["shapes"]})
    for row in kernels:
        row["launches_export"] = export_launches.get(row["name"], 0)
        row["launches_sweep"] = sweep_launches.get(row["name"], 0)
        row["launches_sequence"] = sequence_launches.get(row["name"], 0)
        row["launches_ha_cli"] = ha_cli_launches.get(row["name"], 0)
        row["launches_train"] = train["launches"].get(row["name"], 0)
        row["launches_synth"] = synth["launches"].get(row["name"], 0)
        row["launches_synth_reload"] = synth["reload_launches"].get(row["name"], 0)
        for path in ("dense", "accum", "subpixel", "val_agent"):
            row[f"launches_{path}"] = train2[path].get(row["name"], 0)
        row["launches_rest"] = rest.get(row["name"], 0)
        row["launches_classical"] = classical["launches"].get(row["name"], 0)
        for path, counts in dispatch.items():
            row[f"launches_dispatch_{path}"] = counts.get(row["name"], 0)
        row["launches_tools"] = tools.get(row["name"], 0)
        row["launches_corpus"] = corpus.get(row["name"], 0)
        if row["name"] in export_times:
            row["export_1x240x320"] = export_times[row["name"]]
        if row["name"] in sequence_times:
            row["sequence_1x384x1248"] = sequence_times[row["name"]]
        if row["name"] == "vresample_coef":
            row["train_16x320x320"] = train["coef"]

    kernels.append(classical["row"])
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            dd(img)
        torch.cuda.synchronize()
    # the program's spans (``ssp_torch.trace``) lie on the card's timeline too,
    # as ranges over kernels that are counted already
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
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
                                       "vresample_coef": 0, "ordered_scatter": 0}:
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


def imageio_phase(td: Path, smi: str) -> None:
    """Phase 14 [imageio]: the host decoder on the card's machine, which has
    no OpenCV.  Every committed fixture (progressive, CMYK and RGB-coded
    JPEG, arithmetic-coded, lossless and cut JPEG, Adam7, gamma-tagged PNG
    and a PNG whose tEXt chunk has a bad CRC among them) decodes to the
    hash of OpenCV's decode in its manifest; seeded RGB and gray frames
    written by :func:`write_png` read back exactly (RGB as libpng's luma of
    them), and the same RGB frame as Adam7 with an sRGB chunk decodes as the
    non-interlaced sRGB file does and unlike the untagged one; ms per image
    of decoding, by the host clock (``decode_ms`` of
    ``scripts/bench_imageio.py``), each new form beside its baseline."""
    spec = importlib.util.spec_from_file_location("bench_imageio",
                                                  ROOT / "scripts" / "bench_imageio.py")
    bench_imageio = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_imageio)
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
    rgb = rng.integers(0, 256, (*KITTI_RAW, 3), dtype=np.uint8)
    decoded, frame_ms = {}, {}
    for adam7, srgb in ((True, True), (False, True), (False, False)):
        path = td / f"tagged_{int(adam7)}{int(srgb)}.png"
        write_png(path, rgb, adam7=adam7, srgb=srgb)
        decoded[adam7, srgb] = imageio.decode_gray(path)
        frame_ms[adam7, srgb] = bench_imageio.decode_ms(imageio.decode_gray, path)
    if not np.array_equal(decoded[True, True], decoded[False, True]) or \
            np.array_equal(decoded[False, True], decoded[False, False]):
        raise AssertionError("an Adam7 sRGB frame does not decode as the non-interlaced sRGB "
                             "one, or the sRGB gamma changed nothing")
    log(f"[imageio] the seeded RGB frame as Adam7 with sRGB decodes as the non-interlaced sRGB "
        f"file; {int((decoded[False, True] != decoded[False, False]).sum())} of its pixels "
        f"differ from the untagged file's (the sRGB gamma); decode at {KITTI_RAW[0]}x"
        f"{KITTI_RAW[1]}, ms per frame by the host clock: Adam7 with sRGB "
        f"{frame_ms[True, True]:.3f}, sRGB {frame_ms[False, True]:.3f}, plain "
        f"{frame_ms[False, False]:.3f}")
    ms = {}
    for name in ("ycc420_480x640_q90.jpg", "rgb_375x1242.png", "gray_240x320_q96.jpg",
                 "ycc420_optimized_240x320_q85.jpg", "prog420_rst5_240x320_q85.jpg",
                 "prog_gray_120x160_q90.jpg", "cmyk_120x160_q90.jpg", "rgbcoded_120x160_q90.jpg",
                 "ycc444_rst4_120x160_q90.jpg", "rgba_120x160.png", "adam7_rgb_120x160.png",
                 "srgb_rgb_120x160.png", "palette_120x160.png", "palette_gama45455_120x160.png"):
        ms[name] = bench_imageio.decode_ms(imageio.decode_gray, FIXTURES / name)
        log(f"[imageio] decode {name}: {ms[name]:.3f} ms per image by the host clock "
            f"(one thread)")
    pairs = (("prog420_rst5_240x320_q85.jpg", "ycc420_optimized_240x320_q85.jpg"),
             ("adam7_rgb_120x160.png", "rgba_120x160.png"),
             ("srgb_rgb_120x160.png", "rgba_120x160.png"),
             ("palette_gama45455_120x160.png", "palette_120x160.png"))
    mpx = {name: np.prod(manifest[name]["shape"]) / 1e6 for name in ms}
    rate = {name: mpx[name] / ms[name] * 1e3 for name in ms}  # Mpixel/s
    log("[imageio] side by side, ms per image (Mpixel/s): " + "; ".join(
        f"{a} {ms[a]:.3f} ({rate[a]:.1f}) vs {b} {ms[b]:.3f} ({rate[b]:.1f})" for a, b in pairs)
        + f"; rgb_375x1242.png {rate['rgb_375x1242.png']:.1f} Mpixel/s")
    # the forms read since the decoder follows libjpeg past damage: each
    # beside the file it is measured against (the same scene, or the whole
    # file of a cut one), one thread, with the card's name and power limit
    new_pairs = (("arith_ycc420_480x640_q90.jpg", "ycc420_480x640_q90.jpg"),
                 ("arith_gray_240x320_q96.jpg", "gray_240x320_q96.jpg"),
                 ("arith_prog420_rst4_240x320_q85.jpg", "prog420_rst5_240x320_q85.jpg"),
                 ("lossless_gray_p1_240x320.jpg", "gray_240x320_q96.jpg"),
                 ("lossless_gray_p7_pt1_rst8_120x160.jpg", "prog_gray_120x160_q90.jpg"),
                 ("lossless_cmyk_120x160.jpg", "cmyk_120x160_q90.jpg"),
                 ("cut_ycc420_480x640_q90.jpg", "ycc420_480x640_q90.jpg"),
                 ("cut_prog420_rst5_240x320_q85.jpg", "prog420_rst5_240x320_q85.jpg"),
                 ("cut_arith_ycc420_480x640_q90.jpg", "arith_ycc420_480x640_q90.jpg"),
                 ("bad_text_crc_120x160.png", "rgba_120x160.png"))
    for a, b in new_pairs:
        for name in (a, b):
            if name not in ms:
                ms[name] = bench_imageio.decode_ms(imageio.decode_gray, FIXTURES / name)
        ra, rb = (np.prod(manifest[n]["shape"]) / 1e3 / ms[n] for n in (a, b))
        log(f"[imageio] {smi}: {a} {ms[a]:.3f} ms per image ({ra:.1f} Mpixel/s) vs {b} "
            f"{ms[b]:.3f} ms ({rb:.1f} Mpixel/s), ratio {ms[a] / ms[b]:.2f}, by the host clock, "
            f"one thread")
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
            # the second drive's frames: Adam7 with an sRGB chunk
            write_png(out / f"{i:010d}.png",
                      np.stack([gray, np.roll(gray, 3, axis=1), gray // 2 + 64], axis=-1),
                      adam7=d == 1, srgb=d == 1)
    (root / "train.txt").write_text("".join(f"{d}\n" for d in drives))
    log(f"[sequence] corpus: {SEQ_DRIVES} drives x {SEQ_FRAMES} frames, {KITTI_RAW[0]}x"
        f"{KITTI_RAW[1]} RGB PNG (drive 2: Adam7 with sRGB), written in "
        f"{time.perf_counter() - t0:.1f} s")
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
    fixtures of HA_CLI_FIXTURES under HA_CLI_IMAGES twelve-digit names),
    against the same export on the kernels' plain versions; img/s with the
    decode's share.
    Returns the CLI's launches per kernel."""
    folder = td / "COCO" / "train2017"
    folder.mkdir(parents=True)
    jpegs = [FIXTURES / name for name in HA_CLI_FIXTURES]
    if HA_CLI_IMAGES < len(jpegs):
        raise AssertionError(f"HA_CLI_IMAGES {HA_CLI_IMAGES} < {len(jpegs)} JPEG fixtures")
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
    per_image = {"stem": 1, "down1": 1, "nms": 1, "vresample": 0, "vresample_coef": 4,
                 "ordered_scatter": 0}
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


def steady_state(agent, tag: str, n: int, what: str, smi: str) -> dict:
    """The trainer's step (a batch sampled from the device corpus, prepared,
    one update through ``agent.step``: the plain, accumulated or subpixel
    step, whichever the agent runs) ``n`` times: CUDA events and the host
    clock around whole steps, then by part (``prepare_batch``,
    forward+backward up to the optimizer's step, Adam: events recorded by
    the optimizer's step hooks); device time by operation and the idle share
    under ``torch.profiler``; host syncs per step by call site; peak memory.
    Logs under ``tag`` and returns the numbers."""
    st = agent.state
    B = agent.real_batch_size

    def step():
        agent.step(agent.prepare(agent.next_batch()))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(n):
        step()
    e1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    dev_ms = e0.elapsed_time(e1) / n
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    parts = np.zeros(3)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    hooks = (st.optimizer.register_step_pre_hook(lambda *_: ev[2].record()),
             st.optimizer.register_step_post_hook(lambda *_: ev[3].record()))
    try:
        for _ in range(n):
            ev[0].record()
            batch = agent.prepare(agent.next_batch())
            ev[1].record()
            agent.step(batch)
            torch.cuda.synchronize()
            parts += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    finally:
        for h in hooks:
            h.remove()
    parts /= n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    # the optimizer's and the program's range annotations span kernels that are
    # counted already
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("Optimizer.") and not e.is_user_annotation]
    busy_ms = sum(e.device_time_total for e in on_card) / 5 / 1e3
    top = sorted(((a.key, a.self_device_time_total / 5 / 1e3) for a in prof.key_averages()
                  if a.self_device_time_total > 0 and not a.key.startswith("Optimizer.")),
                 key=lambda kv: -kv[1])[:12]
    # host syncs per step: every operation that makes the host wait for the card
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            step()
    torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    syncs = sum(sites.values()) / 3
    log(f"{tag} steady state, {n} steps of {what} ({smi}): "
        f"{1e3 / dev_ms:.3f} steps/s, "
        f"{B * 1e3 / dev_ms:.2f} img/s by CUDA events ({dev_ms:.3f} ms/step); "
        f"{n / host_s:.3f} steps/s, {B * n / host_s:.2f} img/s by the host "
        f"clock; by part (CUDA events, synchronised per step): prepare_batch {parts[0]:.3f} ms "
        f"({parts[0] / parts.sum():.3f}), forward+backward {parts[1]:.3f} ms "
        f"({parts[1] / parts.sum():.3f}), Adam {parts[2]:.3f} ms ({parts[2] / parts.sum():.3f}); "
        f"{len(on_card) / 5:.0f} device operations and {busy_ms:.3f} ms of device time per step "
        f"under torch.profiler, idle share {max(0.0, 1 - busy_ms / (prof_s * 1e3 / 5)):.3f}; "
        f"{syncs:.1f} host syncs per step; peak memory {peak_gb:.2f} GiB")
    log(f"{tag} device time per step by operation (torch.profiler, self time, ms): " +
        "; ".join(f"{name[:60]} {ms:.3f}" for name, ms in top))
    log(f"{tag} host syncs per step by call site: " + ", ".join(
        f"{k} {v / 3:g}" for k, v in sorted(sites.items(), key=lambda kv: -kv[1])))
    return {"ms_per_step": dev_ms, "img_per_s": B * 1e3 / dev_ms,
            "img_per_s_host": B * n / host_s, "parts_ms": parts.tolist(),
            "idle": max(0.0, 1 - busy_ms / (prof_s * 1e3 / 5)), "peak_gib": peak_gb,
            "syncs": syncs, "ops_per_step": len(on_card) / 5}


def train_phase(dev: torch.device, td: Path, smi: str) -> dict:
    """Phase 17 [train]: stage-3 joint training through ``python -m
    ssp_torch.cli.train train_joint`` (called in this process, so that the
    launch counts can be read) on a ``Coco_sem`` tree built from phase 16's
    output, the flagship configuration at full width; then a step on the
    kernel against one on the plain versions, the steady-state rates by part,
    the idle share and peak memory, and the written checkpoint reloaded.
    Returns the CLI run's launches per kernel."""
    # ---- the tree: phase 16's JPEGs and pseudo-labels (stage 2 → stage 3),
    # 8 of them again as the val split, and panoptic PNGs of seeded rectangles
    coco, ann = td / "COCO", td / "COCO" / "annotations"
    preds = td / "logs" / "ha_cli" / "predictions"
    (coco / "val2017").mkdir()
    (preds / "val2017").mkdir()
    for p in sorted((coco / "train2017").glob("*.jpg"))[:8]:
        shutil.copy(p, coco / "val2017" / p.name)
        shutil.copy(preds / "train2017" / f"{p.stem}.npz", preds / "val2017" / f"{p.stem}.npz")
    rng = np.random.default_rng(SEED + 17)
    for split in ("train2017", "val2017"):
        (ann / f"semantic_{split}").mkdir(parents=True)
        for p in sorted((coco / split).glob("*.jpg")):
            h, w = imageio.decode_gray(p).shape
            raw = np.zeros((h, w), np.uint8)  # raw id 0 is no panoptic category: class 133
            for _ in range(12):
                y, x = rng.integers(0, h), rng.integers(0, w)
                raw[y:y + rng.integers(h // 8, h // 2), x:x + rng.integers(w // 8, w // 2)] = \
                    PANOPTIC_IDS[rng.integers(0, 133)]
            write_png(ann / f"semantic_{split}" / f"{p.stem}.png", raw)
    cfg = yaml.safe_load(TRAIN_CONFIG.read_text())
    cfg["data"].update(root=str(coco), labels=str(preds), sem_labels=str(ann))
    cfg.update(pretrained=str(NPZ), reset_iter=True, steps_per_dispatch=1, **TRAIN_RUN)
    cfg_path = td / "train_cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    B, (hh, hw) = cfg["model"]["batch_size"], cfg["data"]["preprocessing"]["resize"]

    # ---- the main path of this phase: the CLI, counted
    reset_launches()
    t0 = time.perf_counter()
    agent = train_cli.main(["train_joint", str(cfg_path), "train", "--device", str(dev)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    steps = TRAIN_RUN["train_iter"]
    n_val = len(range(0, steps, TRAIN_RUN["validation_interval"]))
    val_batches = n_val * (cfg["validation_size"] + 1)
    # per prepared batch: two coef passes for the images' warp, two for the
    # semantic maps'; the training forward is the module, no folded kernel;
    # each validation's images run NMS on the base and the warped view; the
    # sparse loss's backward, the ordered scatter (none in validation)
    want = {"stem": 0, "down1": 0, "nms": 2 * n_val, "vresample": 0,
            "vresample_coef": 4 * (steps + val_batches),
            "ordered_scatter": SCATTER_PER_STEP * steps}
    log(f"[train] train_joint {TRAIN_CONFIG.name} (ssmall-133, {B}x{hh}x{hw}, warped pair, "
        f"photometric, sparse 1000x100, fused CE, Kendall, Adam): {steps} steps and "
        f"{val_batches} validation batches in {cli_s:.2f} s with the model load ({smi}); "
        f"launches {launches} ({launches['vresample_coef'] / (steps + val_batches):.1f} "
        f"vresample_coef per prepared batch)")
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want}")
    exper = td / "logs" / "train"
    rows = [json.loads(r) for r in (exper / "metrics_train.jsonl").read_text().splitlines()]
    vrows = [json.loads(r) for r in (exper / "metrics_val.jsonl").read_text().splitlines()]
    every = TRAIN_RUN["tensorboard_interval"]
    if [r["step"] for r in rows] != list(range(0, steps, every)) or \
            [r["step"] for r in vrows] != list(range(0, steps, TRAIN_RUN["validation_interval"])):
        raise AssertionError(f"rows at {[r['step'] for r in rows]}, {[r['step'] for r in vrows]}")
    if not all(np.isfinite(v) for r in rows + vrows for v in r.values()):
        raise AssertionError("a non-finite loss in the metrics")
    ckpts = sorted(p.name for p in (exper / "checkpoints").iterdir())
    saves = list(range(TRAIN_RUN["save_interval"], steps, TRAIN_RUN["save_interval"])) + [steps]
    if ckpts != sorted(f"superPointNet_{s}.{e}" for s in saves for e in ("npz", "pth.tar")):
        raise AssertionError(f"checkpoints {ckpts}")
    log("[train] loss by step: " + ", ".join(
        f"{r['step']}: {r['loss']:.4f} (det {r['loss_det']:.4f}, desc {r['loss_desc']:.4f}, "
        f"sem {r['loss_sem']:.4f})" for r in rows) + "; val loss " + ", ".join(
        f"{r['step']}: {r['val_loss']:.4f}" for r in vrows))

    # ---- one step on the kernel, one on the plain versions: same state,
    # batch and draws (the sparse loss's too)
    st = agent.state
    draws = pair_draws(agent, B, hh, hw, dev, SEED + 18)
    p = agent.step_kwargs["desc_params"]

    def sparse_step(batch):
        _, _, valid = cell_matches(batch["H_pair"], (hh // 8, hw // 8))
        sd = sample_draws(valid, p["num_matching_attempts"],
                          p["num_masked_non_matches_per_match"],
                          torch.Generator(dev).manual_seed(SEED + 18))
        return train_step(st, batch, desc_draws=sd, **agent.step_kwargs)

    bk = kernel_vs_plain_step(agent, agent.next_batch(), draws, "[train]", sparse_step)

    # ---- repeatable: two eager steps from one state, bit for bit, with
    # torch.use_deterministic_algorithms off; the ordered scatter's inputs of
    # that step held against its plain version and timed
    calls = repeat_step(agent, bk, sparse_step, "[train]")
    scatter = scatter_check(calls, td, smi)

    # ---- steady state
    steady_state(agent, "[train]", TRAIN_TIMED, f"{B} images (each with its warped view) at "
                 f"{hh}x{hw}, each sampled from the device corpus", smi)

    # ---- the kernel at the training shapes: the images' and the semantic
    # maps' warps of one batch, both passes, against the plain version
    imgs = bk["image"][..., 0].contiguous()
    sem = bk["sem"].float().contiguous()
    canvas_i, Hres, bounds, _ = warp_twopass._canvas_and_residual(imgs, draws["pair"])
    canvas_s = warp_twopass._canvas_and_residual(sem, draws["pair"])[0]
    c1, c2 = (c.to(dev) for c in warp_twopass._pass_coefs(Hres, *bounds, canvas_i.shape[-1]))
    err, times = 0.0, []
    for canvas in (canvas_i, canvas_s):
        tmp = vres_mod.vresample_coef_plain(canvas, c1, 0)
        err = max(err, check_resample("train coef axis 0", vres_mod.vresample_coef(canvas, c1, 0),
                                      tmp, float(canvas.abs().max())),
                  check_resample("train coef axis 1", vres_mod.vresample_coef(tmp, c2, 1),
                                 vres_mod.vresample_coef_plain(tmp, c2, 1),
                                 float(canvas.abs().max())))
        for src, c, axis in ((canvas, c1, 0), (tmp, c2, 1)):
            n_out = c.shape[0] * src.shape[-1] * src.shape[-2]
            times.append((time_ms(lambda: vres_mod.vresample_coef(src, c, axis)),
                          time_ms(lambda: vres_mod.vresample_coef_plain(src, c, axis), iters=5),
                          bound(n_out * 62.0, PEAK_FP32, 4.0 * (c.numel() + n_out + src.numel()))))
    ms, plain_ms = (float(np.mean([t[i] for t in times])) for i in (0, 1))
    b_ms = float(np.mean([t[2][0] for t in times]))
    log(f"[train] vresample_coef at the training shapes ({B} warps on a "
        f"{canvas_i.shape[-1]}x{canvas_i.shape[-1]} canvas, images and class ids, both axes; "
        f"{smi}): "
        f"{ms:.4f} ms (bound {b_ms:.4f} ms by bytes), plain {plain_ms:.4f} ms, max abs err "
        f"{err:.3g}")

    # ---- the written checkpoint reloads and detects
    npz = exper / "checkpoints" / f"superPointNet_{steps}.npz"
    model = load_weights(npz, cfg["model"]["name"], cfg["model"]["params"], device=dev)
    dd = make_detect_describe_fn(best_apply_fn(model, input_hw=(hh, hw), device=dev), device=dev,
                                 conf_thresh=cfg["model"]["detection_threshold"],
                                 nms_radius=cfg["model"]["nms"])
    out = dd(imgs[0])
    if not all(bool(torch.isfinite(t.float()).all()) for t in out if torch.is_tensor(t)):
        raise AssertionError("detect+describe on the trained checkpoint: non-finite output")
    log(f"[train] {npz.name} reloaded through load_weights; detect+describe on it: "
        f"{int(out[1].sum())} points")
    return {"launches": launches, "scatter": scatter,
            "coef": {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "max_abs_err": err}}


def _state_of(st) -> dict:
    """Parameters, BatchNorm statistics, ηs and Adam's moments, cloned."""
    out = {f"model.{k}": v.detach().clone() for k, v in st.model.state_dict().items()}
    out["etas"] = st.etas.detach().clone()
    for i, s_ in enumerate(st.optimizer.state.values()):
        for k, v in s_.items():
            if torch.is_tensor(v):
                out[f"adam.{i}.{k}"] = v.detach().clone()
    return out


def repeat_step(agent, batch: dict, step, tag: str) -> list:
    """``step(batch)`` twice from the same saved state (the switch off): the
    metrics, parameters, BatchNorm statistics, ηs and Adam's moments must be
    equal bit for bit.  Returns the ordered scatter's inputs of the first
    run, in call order (clones)."""
    st = agent.state
    saved = (copy.deepcopy(st.model.state_dict()), copy.deepcopy(st.optimizer.state_dict()),
             st.scheduler.state_dict(), st.etas.detach().clone(), st.step)
    calls, real = [], osc_mod.ordered_scatter

    def record(src, idx, T):
        calls.append((src.detach().clone(), idx.clone(), T))
        return real(src, idx, T)

    runs = []
    for i in range(2):
        st.model.load_state_dict(saved[0])
        st.optimizer.load_state_dict(copy.deepcopy(saved[1]))
        st.scheduler.load_state_dict(saved[2])
        with torch.no_grad():
            st.etas.copy_(saved[3])
        st.step = saved[4]
        osc_mod.ordered_scatter = record if i == 0 else real
        try:
            metrics = {k: float(v) for k, v in step(batch).items()}
        finally:
            osc_mod.ordered_scatter = real
        torch.cuda.synchronize()
        runs.append((metrics, _state_of(st)))
    (m0, s0), (m1, s1) = runs
    diff = max([abs(m0[k] - m1[k]) for k in m0] +
               [float((s0[k].double() - s1[k].double()).abs().max()) for k in s0])
    equal = m0 == m1 and all(torch.equal(s0[k], s1[k]) for k in s0)
    log(f"{tag} two eager steps from one state, torch.use_deterministic_algorithms off: "
        f"{'equal bit for bit' if equal else 'DIFFERENT'} over the metrics and {len(s0)} "
        f"tensors of state (largest difference {diff:.3g}; loss {m0['loss']:.6f} / "
        f"{m1['loss']:.6f}); the ordered scatter ran {len(calls)} times in the step")
    if not equal:
        raise AssertionError(f"{tag}: two steps from one state differ by {diff}")
    return calls


def scatter_check(calls: list, td: Path, smi: str) -> dict:
    """The ordered scatter at each shape a flagship step gave it (its own
    inputs, ``calls``: the descriptor taps and the match rows), and on the
    last call's indices sorted and reversed, against the plain version on
    the host bit for bit; then its device and eager ms and device
    operations per call beside ``scatter_add``'s (the one PyTorch call for
    the same sums), the plain version's ms and its bound (src, idx and out
    once): ``bench_own_kernels.scatter_rows``, its device operations read
    in a fresh process through a file under ``td``.  Returns the row of the
    largest K on the path (the descriptor taps) with every shape's beside
    it."""
    rows = scatter_rows(calls, td)
    for name, t_ in rows.items():
        log(f"[train] ordered_scatter at {name} ({smi}): device {t_['ms']:.4f} ms, eager "
            f"{t_['eager_ms']:.4f} ms, {len(t_['ops'])} device operations per call under "
            f"torch.profiler in a fresh process ({', '.join(f'{n} {ms:.4f} ms' for n, ms in t_['ops'])}); bound "
            f"{t_['bound_ms']:.4f} ms by {t_['bound_by']}; plain {t_['plain_ms']:.4f} ms; "
            f"scatter_add device {t_['library_ms']:.4f} ms, eager {t_['library_eager_ms']:.4f} "
            f"ms; max abs err {t_['max_abs_err']} against the plain version on the host, bit for "
            f"bit (also on the indices sorted and reversed)")
    main = max(rows, key=lambda name: int(name.split("x")[1]))
    return {"shape": main, **rows[main], "shapes": rows}


def coef_calls_per_batch(agent, host: dict) -> int:
    """``vresample_coef`` calls that one prepared training batch makes on the
    two-pass route, counted on the CPU (where the wrapper runs its plain
    version and launches nothing) with the agent's preparation settings."""
    calls = [0]
    wrapped = warp_twopass.vresample_coef

    def counting(*args, **kwargs):
        calls[0] += 1
        return wrapped(*args, **kwargs)

    warp_twopass.vresample_coef = counting
    try:
        cpu = {k: v.cpu() for k, v in host.items()}
        g = torch.Generator().manual_seed(SEED)
        prepare_batch(cpu["image"].float(), cpu["points"].float(), cpu["points_valid"].bool(),
                      generator=g, host_generator=g, warp="twopass", **agent.prep_train)
    finally:
        warp_twopass.vresample_coef = wrapped
    return calls[0]


def synth_phase(dev: torch.device, td: Path, smi: str) -> dict:
    """Phase 18 [synth]: stage 1, MagicPoint pretraining on Synthetic Shapes.
    The generator against the manifest made with OpenCV; the stage-1 corpus
    generated into ``SSP_DATA_PATH``; ``python -m ssp_torch.cli.train
    train_base`` on ``SYNTH_CONFIG`` (called in this process, so that the
    launch counts can be read); a step on the kernel against one on the
    plain versions; the steady-state rates by part; the last checkpoint
    reloaded for detect+describe.  Returns the launches per kernel of the
    CLI run and of the reload."""
    # ---- the generator against the manifest (OpenCV drew the JAX package's)
    manifest = json.loads(SYNTH_MANIFEST.read_text())
    size, blur = tuple(manifest["size"]), manifest["blur_size"]
    per_prim = {}
    for s in manifest["samples"]:
        t0 = time.perf_counter()
        img, pts = generate_sample(s["primitive"], size, s["seed"], blur)
        per_prim.setdefault(s["primitive"], []).append(time.perf_counter() - t0)
        got = (hashlib.sha256(img.tobytes()).hexdigest(), hashlib.sha256(pts.tobytes()).hexdigest(),
               len(pts))
        if got != (s["image_sha256"], s["points_sha256"], s["n_points"]):
            raise AssertionError(f"generate_sample({s['primitive']}, seed {s['seed']}) differs "
                                 f"from the manifest: {got}")
    log(f"[synth] generate_sample: the {len(manifest['samples'])} samples of the manifest "
        f"({len(per_prim)} primitives, {size[0]}x{size[1]}, blur {blur}) equal their SHA-256; "
        f"ms per sample by the host clock, one thread: " + ", ".join(
            f"{k} {np.mean(v) * 1e3:.2f}" for k, v in per_prim.items()))

    # ---- the corpus, generated into SSP_DATA_PATH
    cfg = yaml.safe_load(SYNTH_CONFIG.read_text())
    cfg["data"]["generation"]["split_sizes"] = dict(SYNTH_SPLITS)
    cfg.update(steps_per_dispatch=1, **SYNTH_RUN)
    cfg_path = td / "synth_cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    B, (hh, hw) = cfg["model"]["batch_size"], cfg["data"]["preprocessing"]["resize"]
    t0 = time.perf_counter()
    train_set, val_set = train_cli.make_dataset(cfg, "train"), train_cli.make_dataset(cfg, "val")
    gen_s = time.perf_counter() - t0
    n_prims = len(per_prim)
    n_gen = n_prims * (SYNTH_SPLITS["training"] + SYNTH_SPLITS["validation"])
    full = n_prims * sum(yaml.safe_load(SYNTH_CONFIG.read_text())["data"]["generation"]
                         ["split_sizes"].values())
    log(f"[synth] corpus: {n_gen} samples at {hh}x{hw} generated in {gen_s:.2f} s, one "
        f"thread, with the npz writes ({gen_s * 1e3 / n_gen:.2f} ms/sample of "
        f"wall time; at that rate the config's full corpus of {full} samples takes "
        f"{gen_s / n_gen * full:.1f} s, once); {len(train_set)} training samples after "
        f"truncate, {len(val_set)} validation")

    # ---- the main path of this phase: the CLI, counted
    reset_launches()
    t0 = time.perf_counter()
    agent = train_cli.main(["train_base", str(cfg_path), "synth", "--device", str(dev)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    steps = SYNTH_RUN["train_iter"]
    host = agent.next_batch()
    per_batch = coef_calls_per_batch(agent, host)
    # training batches are warped (homographic, two coef passes per warp);
    # validation batches are not (enable_val: false); the training forward is
    # the module, no folded kernel; each validation's image runs NMS once
    n_val = len(range(0, steps, SYNTH_RUN["validation_interval"]))
    want = {"stem": 0, "down1": 0, "nms": n_val, "vresample": 0,
            "vresample_coef": per_batch * steps, "ordered_scatter": 0}
    log(f"[synth] train_base {SYNTH_CONFIG.name} (gauss2 from scratch, {B}x{hh}x{hw}, "
        f"homographic and photometric, detector loss alone, Adam, the corpus on the card as "
        f"uint8): {steps} steps in {cli_s:.2f} s with the model build ({smi}); launches "
        f"{launches} ({launches['vresample_coef'] / steps:.1f} vresample_coef per prepared "
        f"training batch; {per_batch} counted on the CPU route)")
    if per_batch != 2 or launches != want:
        raise AssertionError(f"synth launches {launches}, expected {want}")
    exper = td / "logs" / "synth"
    rows = [json.loads(r) for r in (exper / "metrics_train.jsonl").read_text().splitlines()]
    vrows = [json.loads(r) for r in (exper / "metrics_val.jsonl").read_text().splitlines()]
    if [r["step"] for r in rows] != list(range(steps)) or \
            [r["step"] for r in vrows] != list(range(0, steps, SYNTH_RUN["validation_interval"])):
        raise AssertionError(f"rows at {[r['step'] for r in rows]}, {[r['step'] for r in vrows]}")
    if not all(np.isfinite(v) for r in rows + vrows for v in r.values()):
        raise AssertionError("a non-finite loss in the metrics")
    if not rows[-1]["loss_det"] < rows[0]["loss_det"]:
        raise AssertionError(f"detector loss {rows[0]['loss_det']} at step 1, "
                             f"{rows[-1]['loss_det']} at step {steps}")
    ckpts = sorted(p.name for p in (exper / "checkpoints").iterdir())
    saves = range(SYNTH_RUN["save_interval"], steps + 1, SYNTH_RUN["save_interval"])
    if ckpts != sorted(f"superPointNet_{s}.{e}" for s in saves for e in ("npz", "pth.tar")):
        raise AssertionError(f"checkpoints {ckpts}")
    log("[synth] detector loss by step: " + ", ".join(
        f"{i + 1}: {rows[i]['loss_det']:.4f}" for i in sorted({0, *range(9, steps, 10)})) +
        "; val loss " + ", ".join(f"{r['step']}: {r['val_loss']:.4f}" for r in vrows))

    # ---- one step on the kernel, one on the plain versions: same state,
    # batch and draws
    st = agent.state
    g_host = torch.Generator().manual_seed(SEED + 19)
    g_dev = torch.Generator(dev).manual_seed(SEED + 19)
    photo = agent.prep_train["photometric"]
    homo = {k: v for k, v in agent.prep_train["homographic"]["params"].items()
            if k != "valid_border_margin"}
    draws = {"homographic": sample_homographies(B, generator=g_host, **homo),
             "photo": draw_photometric((B, hh, hw), photo["primitives"], photo["params"], g_dev,
                                       dev)}
    bk = agent.prepare(host, draws=draws)
    bp = agent.prepare(host, draws=draws, reference=True)
    img_err = check_resample("synth images", bk["image"], bp["image"],
                             float(bp["image"].abs().max()))
    for k in bk:
        if k != "image" and not torch.equal(bk[k], bp[k]):
            raise AssertionError(f"synth batch {k}: the kernel's differs from the plain one's")
    saved = (copy.deepcopy(st.model.state_dict()), copy.deepcopy(st.optimizer.state_dict()),
             st.scheduler.state_dict(), st.etas.detach().clone(), st.step)

    def step_from_saved(batch):
        st.model.load_state_dict(saved[0])
        st.optimizer.load_state_dict(copy.deepcopy(saved[1]))
        st.scheduler.load_state_dict(saved[2])
        with torch.no_grad():
            st.etas.copy_(saved[3])
        st.step = saved[4]
        return train_step(st, batch, generator=agent.generator, **agent.step_kwargs)

    mk, mp = step_from_saved(bk), step_from_saved(bp)
    rel = {k: abs(float(mk[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-6) for k in mk}
    log(f"[synth] one step, kernel against plain versions (same state, batch and draws): images "
        f"max abs err {img_err:.3g}; metrics max rel diff {max(rel.values()):.3g} "
        f"({max(rel, key=rel.get)}); loss {float(mk['loss']):.6f} / {float(mp['loss']):.6f}")
    if max(rel.values()) > TRAIN_REL or not all(np.isfinite(float(v)) for v in mk.values()):
        raise AssertionError(f"kernel vs plain step metrics: {rel}")

    # ---- steady state
    rates = steady_state(agent, "[synth]", SYNTH_TIMED, f"{B} images at {hh}x{hw}, each "
                         "sampled from the device corpus", smi)

    # ---- the last checkpoint reloads and detects: the folded kernels launch
    npz = exper / "checkpoints" / f"superPointNet_{steps}.npz"
    model = load_weights(npz, cfg["model"]["name"], cfg["model"]["params"], device=dev)
    dd = make_detect_describe_fn(best_apply_fn(model, input_hw=(hh, hw), device=dev), device=dev,
                                 conf_thresh=cfg["model"]["detection_threshold"],
                                 nms_radius=cfg["model"]["nms"])
    image = bk["image"][0, ..., 0].contiguous()
    dd(image)  # the first call builds what it needs
    torch.cuda.synchronize()
    reset_launches()
    out = dd(image)
    torch.cuda.synchronize()
    reload_launches = read_launches()
    if reload_launches != {"stem": 1, "down1": 1, "nms": 1, "vresample": 0, "vresample_coef": 0,
                           "ordered_scatter": 0}:
        raise AssertionError(f"detect+describe on the stage-1 checkpoint: {reload_launches}")
    if not all(bool(torch.isfinite(t.float()).all()) for t in out if torch.is_tensor(t)):
        raise AssertionError("detect+describe on the stage-1 checkpoint: non-finite output")
    log(f"[synth] {npz.name} reloaded through load_weights; detect+describe on one image: "
        f"{int(out[1].sum())} points, launches {reload_launches}")

    # ---- gauss2 joint training on the same corpus (the cache written above)
    jcfg = yaml.safe_load(SYNTH_JOINT_CONFIG.read_text())
    jcfg["data"]["generation"]["split_sizes"] = dict(SYNTH_SPLITS)
    jcfg.update(steps_per_dispatch=1, **SYNTH_JOINT_RUN)
    jcfg_path = td / "synth_joint_cfg.yaml"
    jcfg_path.write_text(yaml.safe_dump(jcfg))
    before = sorted(p.name for p in (td / f"synthetic_shapes_{jcfg['data']['suffix']}").iterdir())
    reset_launches()
    t0 = time.perf_counter()
    train_cli.main(["train_joint", str(jcfg_path), "synth_joint", "--device", str(dev)])
    torch.cuda.synchronize()
    joint_s = time.perf_counter() - t0
    joint_launches = read_launches()
    jrows = [json.loads(r) for r in
             (td / "logs" / "synth_joint" / "metrics_train.jsonl").read_text().splitlines()]
    after = sorted(p.name for p in (td / f"synthetic_shapes_{jcfg['data']['suffix']}").iterdir())
    if len(jrows) != SYNTH_JOINT_RUN["train_iter"] or \
            not all(np.isfinite(v) for r in jrows for v in r.values()):
        raise AssertionError(f"{SYNTH_JOINT_CONFIG.name}: rows {jrows}")
    # two coef passes per warped pair, training and validation; NMS on the
    # validation's base and warped images; the sparse loss's ordered scatters
    # per training step; nothing else
    n_val = len(range(0, SYNTH_JOINT_RUN["train_iter"], SYNTH_JOINT_RUN["validation_interval"]))
    if after != before or joint_launches["vresample_coef"] % 2 or \
            joint_launches["vresample_coef"] < 2 * SYNTH_JOINT_RUN["train_iter"] or \
            joint_launches["nms"] != 2 * n_val or \
            joint_launches["ordered_scatter"] != SCATTER_PER_STEP * SYNTH_JOINT_RUN["train_iter"] or \
            any(v for k, v in joint_launches.items()
                if k not in ("vresample_coef", "nms", "ordered_scatter")):
        raise AssertionError(f"{SYNTH_JOINT_CONFIG.name}: launches {joint_launches}, cache "
                             f"{before} -> {after}")
    log(f"[synth] train_joint {SYNTH_JOINT_CONFIG.name} (gauss2, warped pair, sparse, Kendall) "
        f"on the same cache files: {len(jrows)} steps in {joint_s:.2f} s, losses " + ", ".join(
            f"{r['loss']:.4f} (det {r['loss_det']:.4f}, desc {r['loss_desc']:.4f})"
            for r in jrows) + f"; launches {joint_launches}")
    return {"launches": launches, "reload_launches": reload_launches, "rates": rates}


def kernel_vs_plain_step(agent, host: dict, draws: dict, tag: str, step=None) -> dict:
    """Prepare ``host`` with the same draws on the resample kernel and on the
    plain versions and take one step (``step(batch)``, by default
    ``agent.step``) on each from the same saved state: the warped images
    within VRES_TOL, every other batch entry but the warped class ids equal
    (those within TRAIN_LABEL_FLIPS), the metrics within TRAIN_REL.  Returns
    the batch prepared on the kernel."""
    step = step or agent.step
    st = agent.state
    bk = agent.prepare(host, draws=draws)
    bp = agent.prepare(host, draws=draws, reference=True)
    img_err = check_resample(f"{tag} warped images", bk["warped_image"], bp["warped_image"],
                             float(bp["warped_image"].abs().max()))
    inside = bp["warped_valid_mask"] > 0
    flips = float(((bk["warped_sem"] != bp["warped_sem"]) & inside).sum() / inside.sum())
    for k in bk:
        if k not in ("warped_image", "warped_sem") and not torch.equal(bk[k], bp[k]):
            raise AssertionError(f"{tag} batch {k}: the kernel's differs from the plain one's")
    if flips > TRAIN_LABEL_FLIPS:
        raise AssertionError(f"{tag}: {flips:.2e} of the warped class ids flipped")
    saved = (copy.deepcopy(st.model.state_dict()), copy.deepcopy(st.optimizer.state_dict()),
             st.scheduler.state_dict(), st.etas.detach().clone(), st.step)

    def step_from_saved(batch):
        st.model.load_state_dict(saved[0])
        st.optimizer.load_state_dict(copy.deepcopy(saved[1]))
        st.scheduler.load_state_dict(saved[2])
        with torch.no_grad():
            st.etas.copy_(saved[3])
        st.step = saved[4]
        return step(batch)

    mk, mp = step_from_saved(bk), step_from_saved(bp)
    rel = {k: abs(float(mk[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-6) for k in mk}
    log(f"{tag} one step, kernel against plain versions (same state, batch and draws): warped "
        f"images max abs err {img_err:.3g}, {flips:.2e} of the warped class ids inside the mask "
        f"changed; metrics max rel diff {max(rel.values()):.3g} ({max(rel, key=rel.get)}); "
        f"loss {float(mk['loss']):.6f} / {float(mp['loss']):.6f}")
    if max(rel.values()) > TRAIN_REL or not all(np.isfinite(float(v)) for v in mk.values()):
        raise AssertionError(f"{tag} kernel vs plain step metrics: {rel}")
    return bk


def pair_draws(agent, B: int, hh: int, hw: int, dev: torch.device, seed: int) -> dict:
    """Seeded homography and photometric draws for one warped-pair batch."""
    g_host, g_dev = torch.Generator().manual_seed(seed), torch.Generator(dev).manual_seed(seed)
    photo = agent.prep_train["photometric"]
    pair = agent.prep_train["warped_pair"]["params"]
    return {"pair": sample_homographies(B, generator=g_host, **pair),
            "photo": draw_photometric((B, hh, hw), photo["primitives"], photo["params"], g_dev,
                                      dev),
            "photo_warped": draw_photometric((B, hh, hw), photo["primitives"], photo["params"],
                                             g_dev, dev)}


def run_cli(name: str, cfg: dict, command: str, td: Path, dev: torch.device):
    """``python -m ssp_torch.cli.train <command>`` on ``cfg`` in this process,
    every launch count from 0: (agent, launches, seconds, experiment dir)."""
    path = td / f"{name}_cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    reset_launches()
    t0 = time.perf_counter()
    agent = train_cli.main([command, str(path), name, "--device", str(dev)])
    torch.cuda.synchronize()
    return agent, read_launches(), time.perf_counter() - t0, td / "logs" / name


def train2_phase(dev: torch.device, td: Path, smi: str) -> dict:
    """Phase 19 [train2]: the rest of training on the card, each path at full
    width: (a) the flagship with the dense loss, its validation telemetry and
    a profile; (b) exact accumulation, r = 2; (c) SubpixelNet with
    ``Train_model_subpixel`` and ``Val_model_subpixel``; (d)
    ``Val_model_heatmap``; (e) ``evaluate -o``.  Returns the launches per
    kernel of each path's run."""
    out = {}
    coco = td / "COCO"
    flagship = yaml.safe_load(TRAIN_CONFIG.read_text())
    flagship["data"].update(root=str(coco), labels=str(td / "logs" / "ha_cli" / "predictions"),
                            sem_labels=str(coco / "annotations"))
    flagship.update(pretrained=str(NPZ), reset_iter=True, steps_per_dispatch=1)
    B, (hh, hw) = flagship["model"]["batch_size"], flagship["data"]["preprocessing"]["resize"]

    # ---- (a) the dense loss, with the validation telemetry and a profile
    cfg = copy.deepcopy(flagship)
    cfg["model"]["dense_loss"]["enable"] = True
    cfg.update(val_residual_diagnostic=True, profile={"enable": True, "steps": TRAIN2_PROFILE},
               **TRAIN2_RUN)
    agent, launches, cli_s, exper = run_cli("dense", cfg, "train_joint", td, dev)
    steps = TRAIN2_RUN["train_iter"]
    n_val = len(range(0, steps, TRAIN2_RUN["validation_interval"]))
    val_batches = n_val * (cfg["validation_size"] + 1)
    # 4 coef passes per prepared batch (images and class ids); the validation
    # images run NMS on the base and the warped view; the training forward is
    # the module, no folded kernel
    want = {"stem": 0, "down1": 0, "nms": 2 * n_val, "vresample": 0,
            "vresample_coef": 4 * (steps + val_batches), "ordered_scatter": 0}
    p = agent.step_kwargs["desc_params"]
    log(f"[train2] (a) train_joint {TRAIN_CONFIG.name} with the dense loss (lambda_d "
        f"{p['lambda_d']}, descriptor_dist {p['descriptor_dist']}; ssmall-133, {B}x{hh}x{hw}): "
        f"{steps} steps and {val_batches} validation batches in {cli_s:.2f} s with the model load "
        f"({smi}); launches {launches}")
    if agent.step_kwargs["desc_loss"] != "dense" or launches != want:
        raise AssertionError(f"dense launches {launches}, expected {want}")
    out["dense"] = launches
    rows = [json.loads(r) for r in (exper / "metrics_train.jsonl").read_text().splitlines()]
    vrows = [json.loads(r) for r in (exper / "metrics_val.jsonl").read_text().splitlines()]
    traces = sorted((exper / "profile").glob("trace_*.json"))
    if not all(np.isfinite(v) for r in rows + vrows for v in r.values()) or \
            not all("val_subpix_residual_err" in r for r in vrows) or \
            [t.name for t in traces] != [f"trace_{2 + TRAIN2_PROFILE}.json"]:
        raise AssertionError(f"dense run: rows {rows}, val {vrows}, traces {traces}")
    log(f"[train2] (a) losses: " + ", ".join(
        f"{r['step']}: {r['loss']:.4f} (desc {r['loss_desc']:.4f}, pos {r['positive_dist']:.5f}, "
        f"neg {r['negative_dist']:.5f})" for r in rows) + "; val_subpix_residual_err " +
        ", ".join(f"{r['val_subpix_residual_err']:.4f}" for r in vrows) +
        f"; profile {traces[0].name} ({traces[0].stat().st_size / 2 ** 20:.1f} MiB)")
    kernel_vs_plain_step(agent, agent.next_batch(), pair_draws(agent, B, hh, hw, dev, SEED + 21),
                         "[train2] (a)")
    steady_state(agent, "[train2] (a) dense", TRAIN2_TIMED,
                 f"{B} images (each with its warped view) at {hh}x{hw}", smi)

    # ---- (b) exact accumulation over two micro-batches of 16
    cfg = copy.deepcopy(flagship)
    cfg["model"].update(real_batch_size=2 * B, exact_accumulation=True)
    cfg.update(**ACCUM_RUN)
    agent, launches, cli_s, exper = run_cli("accum", cfg, "train_joint", td, dev)
    steps = ACCUM_RUN["train_iter"]
    n_val = len(range(0, steps * agent.r, ACCUM_RUN["validation_interval"] * agent.r))
    # the real batch is prepared once per optimizer step (as the JAX trainer
    # prepares it) and then split into the micro-batches: 4 coef passes; the
    # sparse loss's ordered scatters per micro-batch
    per_step = 4
    want = {"stem": 0, "down1": 0, "nms": 2 * n_val, "vresample": 0,
            "vresample_coef": per_step * (steps + n_val * (ACCUM_RUN["validation_size"] + 1)),
            "ordered_scatter": SCATTER_PER_STEP * agent.r * steps}
    log(f"[train2] (b) train_joint with exact_accumulation, real batch {agent.real_batch_size} "
        f"in r = {agent.r} micro-batches of {B}: {steps} optimizer steps in {cli_s:.2f} s with "
        f"the model load ({smi}); launches {launches}: {per_step} vresample_coef per optimizer "
        f"step (one prepared real batch)")
    if not agent.accumulate or launches != want:
        raise AssertionError(f"accum launches {launches}, expected {want}")
    out["accum"] = launches
    rows = [json.loads(r) for r in (exper / "metrics_train.jsonl").read_text().splitlines()]
    if [r["step"] for r in rows] != list(range(0, steps * agent.r, agent.r)) or \
            not all(np.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"accum rows {rows}")
    rates = steady_state(agent, "[train2] (b) accum", ACCUM_TIMED,
                         f"{2 * B} images in 2 micro-batches of {B} (each with its warped view) "
                         f"at {hh}x{hw}", smi)
    log(f"[train2] (b) {rates['ms_per_step']:.3f} ms per optimizer step of {2 * B} pairs "
        f"({smi})")

    # ---- (c) SubpixelNet on the stage-1 corpus of phase 18
    cfg = yaml.safe_load(SYNTH_CONFIG.read_text())
    cfg["data"]["generation"]["split_sizes"] = dict(SYNTH_SPLITS)
    cfg["front_end_model"] = "Train_model_subpixel"
    cfg["model"]["name"] = "SubpixelNet"
    cfg.update(steps_per_dispatch=1, **SUBPIX_RUN)
    Bs, (sh, sw) = cfg["model"]["batch_size"], cfg["data"]["preprocessing"]["resize"]
    agent, launches, cli_s, exper = run_cli("subpixel", cfg, "train_base", td, dev)
    steps = SUBPIX_RUN["train_iter"]
    n_val = len(range(0, steps, SUBPIX_RUN["validation_interval"]))
    # 2 coef passes per training batch (the homographic warp), none per
    # validation batch; the validation image's NMS (no warped view)
    want = {"stem": 0, "down1": 0, "nms": n_val, "vresample": 0, "vresample_coef": 2 * steps,
            "ordered_scatter": 0}
    rows = [json.loads(r) for r in (exper / "metrics_train.jsonl").read_text().splitlines()]
    sub = [r["loss_subpix"] for r in rows]
    log(f"[train2] (c) train_base {SYNTH_CONFIG.name} as Train_model_subpixel on SubpixelNet "
        f"({Bs}x{sh}x{sw}, {agent.model.dtype}): {steps} steps in {cli_s:.2f} s with the model "
        f"build ({smi}); launches {launches}; loss_subpix by step " +
        ", ".join(f"{v:.5f}" for v in sub) + "; loss_det " +
        ", ".join(f"{r['loss_det']:.4f}" for r in rows))
    if launches != want or len(sub) != steps or not np.isfinite(sub).all():
        raise AssertionError(f"subpixel launches {launches} (expected {want}), loss_subpix {sub}")
    out["subpixel"] = launches
    # loss_subpix on one fixed training batch (batch statistics, no update)
    # before and after the steady-state steps: single batches' losses spread
    # too widely to show a fall over ten steps
    fixed = agent.prepare(agent.next_batch())

    def fixed_loss() -> float:
        with torch.no_grad():
            return float(subpixel_losses(agent.state.model.train(), fixed,
                                         **agent.subpixel_kwargs)[1]["loss_subpix"])

    before = fixed_loss()
    steady_state(agent, "[train2] (c) subpixel", SUBPIX_TIMED,
                 f"{Bs} images at {sh}x{sw}, SubpixelNet (decoder to full resolution)", smi)
    after = fixed_loss()
    log(f"[train2] (c) loss_subpix on one fixed training batch: {before:.5f} after the CLI's "
        f"{steps} steps, {after:.5f} after the steady state's {2 * SUBPIX_TIMED + 10} more")
    if not after < before:
        raise AssertionError(f"loss_subpix did not fall: {before} -> {after}")
    npz = exper / "checkpoints" / f"superPointNet_{steps}.npz"
    val = SubpixelValAgent(load_weights(npz, "SubpixelNet", device=dev), device=dev)
    host = agent.prepare(agent.next_batch(), train=False)
    images, pts = host["image"][:8], host["points"][:8]
    pts3 = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    refined = val.refine_points(images, pts3)
    off = val.run(images)["subpixel"]
    ix = torch.round(pts[..., 0]).long().clamp(0, sw - 1)
    iy = torch.round(pts[..., 1]).long().clamp(0, sh - 1)
    b = torch.arange(images.shape[0], device=dev)[:, None]
    if not torch.allclose(refined[..., :2], pts + off[b, iy, ix], atol=1e-5, rtol=0) or \
            not bool(torch.isfinite(refined).all()):
        raise AssertionError("Val_model_subpixel.refine_points")
    log(f"[train2] (c) {npz.name} through load_weights and Val_model_subpixel.refine_points on "
        f"{images.shape[0]} images: mean |offset| {float(off[b, iy, ix].abs().mean()):.4f} px")

    # ---- (d) Val_model_heatmap over phase 12's images.  Its points are held
    # as phase 12 holds the detections: subpixel off, all K points (threshold
    # 0); at 0.015 a point whose score rounds across the threshold on one
    # side only would count as lost
    m = HPATCHES_CONFIG["model"]
    vcfg = {"model": {**m, "subpixel": {"enable": False}, "detection_threshold": 0.0},
            "pretrained": str(NPZ)}
    vh, vw = HPATCHES_CONFIG["data"]["preprocessing"]["resize"]
    dataset = PatchesDataset(preprocessing={"resize": [vh, vw]})
    imgs = [dataset[i][k] for i in range(len(dataset)) for k in ("image", "warped_image")]
    agent, plain = ValAgent(vcfg, device=dev), ValAgent(vcfg, device=dev, reference=True)
    agent.run(imgs[0])  # builds what it needs
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = []
    for img in imgs:
        agent.run(img)
        results.append((agent.heatmap_to_pts(), agent.desc_to_sparse_desc()))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_launches()
    want = {"stem": len(imgs), "down1": len(imgs), "nms": len(imgs), "vresample": 0,
            "vresample_coef": 0, "ordered_scatter": 0}
    if launches != want:
        raise AssertionError(f"Val_model_heatmap launches {launches}, expected {want}")
    out["val_agent"] = launches
    worst = {"shared": 1.0, "strong_recall": 1.0, "cos": 1.0}
    for img, (pts, desc) in zip(imgs, results):
        plain.run(img)
        w = agreement(*(torch.from_numpy(a)[None] for a in
                        (pts, desc, plain.heatmap_to_pts(), plain.desc_to_sparse_desc())))
        worst = {k: min(worst[k], w[k]) for k in worst}
    log(f"[train2] (d) Val_model_heatmap ({m['name']}, the trained weights, K={m['top_k']}, "
        f"NMS {m['nms']}, all K points) over phase 12's {len(imgs)} images at {vh}x{vw}: "
        f"launches {launches} "
        f"(once each per image); {len(imgs) / run_s:.2f} img/s by the host clock ({smi}); "
        f"against the plain versions: worst image shares {worst['shared']:.4f} of its points, "
        f"finds {worst['strong_recall']:.4f} of the strong ones, cosine {worst['cos']:.6f}")

    # ---- (e) evaluate -o over a copy of phase 12's export
    preds = td / "eval_o"
    shutil.copytree(td / "logs" / "smoke" / "predictions", preds,
                    ignore=shutil.ignore_patterns("result.*"))
    t0 = time.perf_counter()
    evaluate(preds, output_img=True)
    eval_s = time.perf_counter() - t0
    pngs = sorted(preds.glob("*/*.png"))
    pair_files = sorted(f for f in preds.glob("*.npz") if f.name != "result.npz")
    for f in pair_files:
        with np.load(f) as z:
            data = {k: z[k] for k in z.files}
        img1, img2 = (data[k][..., 0] if data[k].ndim == 3 else data[k]
                      for k in ("image", "warped_image"))
        canvases = {f"repeatibility3/{f.stem}_1.png": draw_keypoints(img1, data["prob"]),
                    f"repeatibility3/{f.stem}_2.png": draw_keypoints(img2, data["warped_prob"])}
        if len(data.get("matches", ())):
            canvases[f"matching/{f.stem}.png"] = draw_matches(
                img1, data["prob"], img2, data["warped_prob"], data["matches"])
        for name, canvas in canvases.items():
            bl, gr, rd = (canvas[..., c].astype(np.int64) for c in range(3))
            luma = ((9797 * rd + 19234 * gr + 3737 * bl) >> 15).astype(np.uint8)
            if not np.array_equal(imageio.decode_gray(preds / name), luma):
                raise AssertionError(f"evaluate -o: {name} does not decode to its canvas")
    if len(pngs) < 2 * len(pair_files):
        raise AssertionError(f"evaluate -o wrote {len(pngs)} PNGs for {len(pair_files)} pairs")
    log(f"[train2] (e) evaluate -o over phase 12's {len(pair_files)} pairs: "
        f"{len(pngs)} PNGs ({len(list(preds.glob('repeatibility3/*.png')))} keypoint overlays, "
        f"{len(list(preds.glob('matching/*.png')))} match drawings) in {eval_s:.2f} s, each "
        f"decoding through the port's decoder to the luma of the canvas drawn")
    return out


def _host_ms(fn, reps: int) -> float:
    """Mean host-clock ms of ``fn()`` over ``reps`` calls."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _step_result(state, metrics) -> dict:
    """A step's loss, the parameter checksum Σ|p| (fp64) and the ηs."""
    return {"loss": float(metrics["loss"]),
            "checksum": sum(float(p.detach().double().abs().sum())
                            for p in state.model.parameters()),
            "etas": state.etas.detach().cpu().clone()}


def _timed_steps(agent, n: int):
    """ms per training step by the host clock (a batch sampled from the device
    corpus, prepared, one update), and the launches of the ``n`` steps."""
    agent.step(agent.prepare(agent.next_batch()))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(n):
        agent.step(agent.prepare(agent.next_batch()))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, read_launches()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(job: str, world: int, backend: str, work: Path, timeout: float = 300) -> list:
    """``world`` processes of this script (``--rest-rank``), every one on the
    one card (``LOCAL_RANK`` 0), joined over ``backend``; their results in
    rank order.  All are killed when one fails or at ``timeout`` seconds."""
    port, procs = _free_port(), []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        out = open(work / f"{job}_{world}_{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rest-rank", job, backend,
             str(work)], env=env, stdout=out, stderr=subprocess.STDOUT), out))
    deadline = time.time() + timeout
    try:
        while time.time() < deadline:
            codes = [p.poll() for p, _ in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.5)
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = {r: (work / f"{job}_{world}_{r}.log").read_text()[-3000:] for r in failed}
        raise AssertionError(f"[rest] {job} ranks {failed} of {world} failed: {tails}")
    return [torch.load(work / f"{job}_{world}_{r}.pt", weights_only=False) for r in range(world)]


def rest_rank(job: str, backend: str, work: Path) -> None:
    """One rank of phase 20 (``python chip_smoke.py --rest-rank <job>
    <backend> <dir>``, rank and world from the environment): ``train``, the
    flagship step on this rank's rows of the parent's prepared batch, timed
    steps, and (on several ranks) the train CLI's ``train_joint``; ``ha``, the
    HA CLI's ``export_detector_homoAdapt``.  Writes its result to ``dir``."""
    from ssp_torch.parallel import mesh
    from ssp_torch.train.trainer import TrainAgent
    from ssp_torch.utils.experiment import ExperimentPaths

    dev = mesh.init_distributed("cuda", backend=backend)
    rank, world = mesh.rank(), mesh.world()
    if job == "shrink":
        cfg = torch.load(work / "train_in.pt", weights_only=False)["cfg"]
        reset_launches()
        t0 = time.perf_counter()
        agent = train_cli.train_joint(dict(cfg, **REST_RUN), "rest_cli_shrink", device=dev)
        torch.cuda.synchronize()
        out = {"idle": agent.idle, "world": agent.world, "cli_s": time.perf_counter() - t0,
               "cli_launches": read_launches()}
    elif job == "train":
        inp = torch.load(work / "train_in.pt", weights_only=False)
        cfg = inp["cfg"]
        agent = TrainAgent(cfg, save_path=ExperimentPaths(f"rest_ranks{world}"), device=dev)
        agent.attach_device_corpus(train_cli.make_dataset(cfg, "train"))
        batch = mesh.shard_rows({k: v.to(dev) for k, v in inp["batch"].items()}, world, rank)
        draws = mesh.shard_rows({k: v.to(dev) for k, v in inp["draws"].items()}, world, rank)
        metrics = train_step(agent.state, batch, desc_draws=SparseDraws(**draws),
                             **agent.step_kwargs)
        out = _step_result(agent.state, metrics)
        out["ms"], out["launches"] = _timed_steps(agent, REST_TIMED)
        if world > 1:
            reset_launches()
            t0 = time.perf_counter()
            train_cli.train_joint(dict(cfg, **REST_RUN), "rest_cli", device=dev)
            torch.cuda.synchronize()
            out["cli_s"], out["cli_launches"] = time.perf_counter() - t0, read_launches()
    else:
        config = {**HA_CLI_CONFIG, "pretrained": str(ROOT / HA_CLI_CONFIG["pretrained"])}
        reset_launches()
        t0 = time.perf_counter()
        written = export_detector_homoAdapt(config, "ha_rest", device=dev)
        torch.cuda.synchronize()
        out = {"written": written, "s": time.perf_counter() - t0, "launches": read_launches()}
    torch.save(out, work / f"{job}_{world}_{rank}.pt")
    mesh.shutdown()


def rest_phase(dev: torch.device, td: Path, smi: str, main_desc: torch.Tensor) -> dict:
    """Phase 20 [rest]: the host ops, ``import_torch``, ``convert2script``,
    multi-rank training and the multi-rank HA export, on the trees and
    outputs of phases 12, 16 and 17 under ``td``.  Returns the launches per
    kernel of (b)'s export, (d)'s timed steps and train CLI on every rank and
    (e)'s export on every rank."""
    from ssp_torch import native
    from ssp_torch.cli import import_torch
    from ssp_torch.cli.convert2script import export_model
    from ssp_torch.train.trainer import TrainAgent
    from ssp_torch.utils.experiment import ExperimentPaths

    torch.cuda.empty_cache()
    work = td / "rest"
    work.mkdir()
    name = HPATCHES_CONFIG["model"]["name"]
    hh, hw = HPATCHES_CONFIG["data"]["preprocessing"]["resize"]
    preds = td / "logs" / "smoke" / "predictions"
    with np.load(preds / "0.npz") as z:
        img = z["image"][..., 0] if z["image"].ndim == 3 else z["image"]
    img = np.ascontiguousarray(img, np.float32)
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # ---- (a) the host ops against their plain numpy versions
    ss = load_flax_npz(NPZ, name, device=dev)
    maps = {}
    for shape, im in (((hh, hw), img), ((2 * hh, 2 * hw), np.kron(img, np.ones((2, 2))))):
        with torch.inference_mode():
            semi = best_apply_fn(ss, input_hw=shape, device=dev)(
                torch.from_numpy(im[None, ..., None].astype(np.float32)).to(dev))["semi"]
        maps[shape] = flatten_detection(semi)[0, ..., 0].float().cpu().numpy()
    m = HPATCHES_CONFIG["model"]
    for shape, heat in maps.items():
        got = native.greedy_nms(heat, m["nms"], m["detection_threshold"])
        want = native.greedy_nms_plain(heat, m["nms"], m["detection_threshold"])
        if not np.array_equal(got, want):
            raise AssertionError(f"[rest] greedy_nms {shape}: {int((got != want).sum())} cells "
                                 f"differ from the plain version")
        args = (heat, m["nms"], m["detection_threshold"])
        log(f"[rest] (a) greedy_nms on phase 12's heatmap at {shape[0]}x{shape[1]} (dist "
            f"{m['nms']}, min score {m['detection_threshold']}): {int(got.sum())} kept, equal "
            f"to the plain version; {_host_ms(lambda: native.greedy_nms(*args), 20):.3f} ms "
            f"(C++), plain {_host_ms(lambda: native.greedy_nms_plain(*args), 2):.3f} ms, host "
            f"clock")
    d1, d2 = (main_desc[i].float().cpu().numpy() for i in (0, 1))
    got = native.nn_match_two_way_native(d1, d2, m["nn_thresh"])
    want = native.nn_match_two_way_plain(d1, d2, m["nn_thresh"])
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"[rest] matcher {got.shape} differs from the plain {want.shape}")
    log(f"[rest] (a) nn_match_two_way_native on the main path's {d1.shape[0]}x{d2.shape[0]}x"
        f"{d1.shape[1]} descriptors: {got.shape[1]} mutual matches under {m['nn_thresh']}, "
        f"equal to the plain version; "
        f"{_host_ms(lambda: native.nn_match_two_way_native(d1, d2, m['nn_thresh']), 3):.3f} ms "
        f"(C++), plain {_host_ms(lambda: native.nn_match_two_way_plain(d1, d2, m['nn_thresh']), 1):.3f}"
        f" ms")
    ha_h = HA_CLI_CONFIG["data"]["homography_adaptation"]["homographies"]["params"]
    Hm = sample_homographies(1, generator=torch.Generator().manual_seed(SEED + 20),
                             **ha_h)[0].double().numpy()
    got = native.inv_warp_bilinear(img, Hm)
    err = float(np.abs(got - native.inv_warp_bilinear_plain(img, Hm)).max())
    if not err <= VRES_TOL:
        raise AssertionError(f"[rest] inv_warp_bilinear: max abs err {err} > {VRES_TOL}")
    log(f"[rest] (a) inv_warp_bilinear at {hh}x{hw}: max abs err {err:.3g} against the plain "
        f"version; {_host_ms(lambda: native.inv_warp_bilinear(img, Hm), 20):.3f} ms (C++), "
        f"plain {_host_ms(lambda: native.inv_warp_bilinear_plain(img, Hm), 5):.3f} ms")

    # ---- (b) import_torch: the trained weights as a reference checkpoint
    # file, imported, then phase 12's export on REST_PAIRS of its pairs
    torch.save({"model_state_dict": read_state_dict(NPZ, name), "n_iter": 200000},
               work / "wsem.pth.tar")
    imported = import_torch.main([str(work / "wsem.pth.tar"), str(work / "imported"),
                                  "--model", name, "--n-classes", "133"])
    if imported.name != "superPointNet_200000.pth.tar":
        raise AssertionError(f"[rest] import wrote {imported}")
    sub = work / "HPatches"
    sub.mkdir()
    for seq in sorted(p for p in (td / "HPatches").iterdir() if p.is_dir())[
            :REST_PAIRS // len(HP_VIEWS)]:
        (sub / seq.name).symlink_to(seq, target_is_directory=True)
    config = copy.deepcopy(HPATCHES_CONFIG)
    config["data"]["root"], config["pretrained"] = str(sub), str(imported)
    reset_launches()
    written = export_descriptor(config, "rest_import", device=dev)
    torch.cuda.synchronize()
    launches = read_launches()
    add(launches)
    if written != REST_PAIRS or any(launches[k] != 2 * REST_PAIRS for k in ("stem", "down1", "nms")):
        raise AssertionError(f"[rest] export from the import: {written} pairs, {launches}")
    for i in range(REST_PAIRS):
        with np.load(td / "logs" / "rest_import" / "predictions" / f"{i}.npz") as a, \
                np.load(preds / f"{i}.npz") as b:
            if a.files != b.files or not all(np.array_equal(a[k], b[k]) for k in a.files):
                raise AssertionError(f"[rest] pair {i} from the import differs from phase 12's")
    log(f"[rest] (b) import_torch of {NPZ.name} written as a reference .pth.tar: "
        f"{imported.name}; export_descriptor from it on {REST_PAIRS} pairs equals phase 12's "
        f"files (points, descriptors, matches); launches {launches}")

    # ---- (c) convert2script: ssmall-133 at 1x240x320, fp32 and bf16
    x = torch.from_numpy(img[None, ..., None]).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    times = {}
    try:
        for dt in ("float32", "bfloat16"):
            cfg = {"model": {"name": name, "params": {"n_classes": 133, "dtype": dt}},
                   "pretrained": str(imported)}
            t0 = time.perf_counter()
            path = export_model(cfg, work / f"ssmall_{dt}.pt2", 1, hh, hw, device=dev)
            export_s = time.perf_counter() - t0
            program = torch.export.load(path).module()
            eager = load_weights(imported, name, cfg["model"]["params"], device=dev)
            with torch.no_grad():
                a, e = program(x), eager(x)
                errs = {k: float((u.float() - e[k].float()).abs().max())
                        for k, u in zip(("semi", "desc"), a)}
                scale = {k: float(e[k].float().abs().max()) for k in errs}
                cos = float((a[1].float() * e["desc"].float()).sum(-1).min())
                times[dt] = (time_ms(lambda: program(x)), time_ms(lambda: eager(x)))
            ok = (max(errs.values()) <= ART_ATOL if dt == "float32" else
                  all(errs[k] <= REL_MAX * scale[k] for k in errs) and cos >= COS_MIN)
            log(f"[rest] (c) convert2script {dt} 1x{hh}x{hw}: {path.stat().st_size} bytes in "
                f"{export_s:.1f} s; the loaded program against the eager module: max abs err "
                f"{errs}, desc cosine >= {cos:.6f}")
            if not ok or a[0].shape != (1, hh // 8, hw // 8, 65):
                raise AssertionError(f"[rest] the {dt} program: {errs}, cosine {cos}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    fast = best_apply_fn(ss, input_hw=(hh, hw), device=dev)
    fast_ms = time_ms(lambda: fast(x))
    log(f"[rest] (c) ms per image at 1x{hh}x{hw} by CUDA events ({smi}): program fp32 "
        f"{times['float32'][0]:.3f}, eager fp32 {times['float32'][1]:.3f}, program bf16 "
        f"{times['bfloat16'][0]:.3f}, eager bf16 {times['bfloat16'][1]:.3f}, best_apply_fn's "
        f"kernel path {fast_ms:.3f}")
    del ss, fast
    torch.cuda.empty_cache()

    # ---- (d) the flagship step on REST_WORLD ranks of the one card (gloo)
    # against one process on the same prepared global batch and draws
    cfg = yaml.safe_load((td / "train_cfg.yaml").read_text())
    agent = TrainAgent(cfg, save_path=ExperimentPaths("rest_single"), device=dev)
    agent.attach_device_corpus(train_cli.make_dataset(cfg, "train"))
    batch = agent.prepare(agent.next_batch())
    p = agent.step_kwargs["desc_params"]
    th, tw = cfg["data"]["preprocessing"]["resize"]
    _, _, valid = cell_matches(batch["H_pair"], (th // 8, tw // 8))
    draws = sample_draws(valid, p["num_matching_attempts"], p["num_masked_non_matches_per_match"],
                         torch.Generator(dev).manual_seed(SEED + 20))
    torch.save({"cfg": cfg, "batch": {k: v.cpu() for k, v in batch.items()},
                "draws": {k: v.cpu() for k, v in vars(draws).items()}}, work / "train_in.pt")
    one = _step_result(agent.state, train_step(agent.state, batch, desc_draws=draws,
                                               **agent.step_kwargs))
    one["ms"], one_launches = _timed_steps(agent, REST_TIMED)
    del agent, batch
    torch.cuda.empty_cache()
    B = cfg["model"]["batch_size"]
    ranks = run_ranks("train", REST_WORLD, "gloo", work)
    nccl = run_ranks("train", 1, "nccl", work)[0]

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    worst = max(max(rel(r["loss"], one["loss"]), rel(r["checksum"], one["checksum"]))
                for r in ranks)
    nccl_diff = max(rel(nccl["loss"], one["loss"]), rel(nccl["checksum"], one["checksum"]))
    coef = [r["launches"]["vresample_coef"] / REST_TIMED for r in ranks]
    log(f"[rest] (d) the flagship step ({B} pairs at {th}x{tw}, ssmall-133, sparse, Kendall) on "
        f"{REST_WORLD} ranks of one card over gloo, {B // REST_WORLD} pairs each, against one "
        f"process on the same prepared batch and draws: loss {[r['loss'] for r in ranks]} / "
        f"{one['loss']:.6f}, checksum {[r['checksum'] for r in ranks]} / {one['checksum']:.4f}: "
        f"max rel diff {worst:.3g} (bar {TRAIN_REL}); ηs per rank "
        f"{[r['etas'].tolist() for r in ranks]}; one rank over NCCL at world size 1 against "
        f"the non-distributed step: max rel diff {nccl_diff:.3g}")
    log(f"[rest] (d) ms/step by the host clock over {REST_TIMED} steps ({smi}): one process "
        f"{one['ms']:.3f} ({B} pairs), {REST_WORLD} ranks on one card "
        f"{[round(r['ms'], 3) for r in ranks]} ({B // REST_WORLD} pairs each), NCCL world 1 "
        f"{nccl['ms']:.3f}; vresample_coef per rank per step {coef} (one process "
        f"{one_launches['vresample_coef'] / REST_TIMED})")
    if worst > TRAIN_REL or nccl_diff > TRAIN_REL:
        raise AssertionError(f"[rest] multi-rank step: {worst}, NCCL world 1: {nccl_diff}")
    if not torch.equal(ranks[0]["etas"], ranks[1]["etas"]):
        raise AssertionError(f"[rest] the ranks' ηs differ: {[r['etas'] for r in ranks]}")
    if coef != [4.0] * REST_WORLD:
        raise AssertionError(f"[rest] vresample_coef per rank per step {coef}, expected 4")
    scatters = [r["launches"]["ordered_scatter"] for r in ranks] + \
        [one_launches["ordered_scatter"]]
    if scatters != [SCATTER_PER_STEP * REST_TIMED] * (REST_WORLD + 1):
        raise AssertionError(f"[rest] ordered_scatter over {REST_TIMED} steps per rank and in "
                             f"one process {scatters}, expected {SCATTER_PER_STEP} per step")
    steps, n_val = REST_RUN["train_iter"], 1
    exper = td / "logs" / "rest_cli"
    rows = [json.loads(r) for r in (exper / "metrics_train.jsonl").read_text().splitlines()]
    want_cli = {"stem": 0, "down1": 0, "nms": 2 * n_val, "vresample": 0,
                "vresample_coef": 4 * (steps + n_val),
                "ordered_scatter": SCATTER_PER_STEP * steps}
    for r, res in enumerate(ranks):
        want = dict(want_cli, nms=want_cli["nms"] if r == 0 else 0)
        if res["cli_launches"] != want:
            raise AssertionError(f"[rest] train CLI rank {r}: launches {res['cli_launches']}, "
                                 f"expected {want}")
        add(res["launches"])
        add(res["cli_launches"])
    if [r["step"] for r in rows] != list(range(steps)) or \
            not all(np.isfinite(v) for r in rows for v in r.values()) or \
            not (exper / "checkpoints" / f"superPointNet_{steps}.pth.tar").exists():
        raise AssertionError(f"[rest] train CLI on {REST_WORLD} ranks: rows {rows}")
    log(f"[rest] (d) train_joint on {REST_WORLD} ranks ({steps} steps, one validation): "
        f"{[round(r['cli_s'], 2) for r in ranks]} s with the model load; rank 0 alone wrote "
        f"{len(rows)} metric rows and the checkpoints; launches per rank "
        f"{[r['cli_launches'] for r in ranks]}")

    # ---- (d) the mesh shrink: the train CLI on SHRINK_WORLD ranks, which do
    # not divide the global batch: the largest count that does trains
    t0 = time.perf_counter()
    shrink = run_ranks("shrink", SHRINK_WORLD, "gloo", work)
    wall = time.perf_counter() - t0
    n_train = max(n for n in range(1, SHRINK_WORLD + 1) if B % n == 0)
    if [r["idle"] for r in shrink] != [r >= n_train for r in range(SHRINK_WORLD)] or \
            {r["world"] for r in shrink} != {n_train}:
        raise AssertionError(f"[rest] shrink: {[(r['idle'], r['world']) for r in shrink]}")
    for r, res in enumerate(shrink):
        want = (dict(want_cli, nms=want_cli["nms"] if r == 0 else 0) if r < n_train else
                dict.fromkeys(want_cli, 0))
        if res["cli_launches"] != want:
            raise AssertionError(f"[rest] shrink rank {r}: launches {res['cli_launches']}, "
                                 f"expected {want}")
        add(res["cli_launches"])
    shrunk = td / "logs" / "rest_cli_shrink"
    srows = [json.loads(r) for r in (shrunk / "metrics_train.jsonl").read_text().splitlines()]
    keys = [k for k in rows[0] if k.startswith(("loss", "eta", "positive", "negative"))]
    sdiff = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(srows, rows)
                for k in keys)
    log(f"[rest] (d) the mesh shrink: train_joint on {SHRINK_WORLD} ranks of one card over gloo "
        f"with a global batch of {B}: ranks 0..{n_train - 1} train "
        f"({[round(r['cli_s'], 2) for r in shrink]} s each with the model load, {wall:.1f} s "
        f"with the processes' start), ranks {n_train}..{SHRINK_WORLD - 1} idle and exit 0; "
        f"{len(srows)} metric rows against the {REST_WORLD}-rank run's {len(rows)}: largest "
        f"relative difference {sdiff:.3g} over {keys}; launches per rank "
        f"{[r['cli_launches'] for r in shrink]}")
    if n_train != REST_WORLD or [r["step"] for r in srows] != [r["step"] for r in rows] or \
            sdiff > TRAIN_REL or \
            not (shrunk / "checkpoints" / f"superPointNet_{steps}.pth.tar").exists():
        raise AssertionError(f"[rest] shrink: {n_train} ranks, rows {srows}, diff {sdiff}")

    # ---- (e) the HA CLI on REST_WORLD ranks of the one card
    t0 = time.perf_counter()
    ha = run_ranks("ha", REST_WORLD, "gloo", work)
    wall = time.perf_counter() - t0
    single = td / "logs" / "ha_cli" / "predictions" / "train2017"
    multi = td / "logs" / "ha_rest" / "predictions" / "train2017"
    names = sorted(f.name for f in single.glob("*.npz"))
    n = len(names)
    if sorted(f.name for f in multi.glob("*.npz")) != names or \
            sum(r["written"] for r in ha) != n:
        raise AssertionError(f"[rest] HA on {REST_WORLD} ranks wrote {[r['written'] for r in ha]}")
    diff = 0.0
    for f in names:
        with np.load(single / f) as a, np.load(multi / f) as b:
            if a["pts"].shape != b["pts"].shape:
                raise AssertionError(f"[rest] {f}: {a['pts'].shape} vs {b['pts'].shape}")
            diff = max(diff, float(np.abs(a["pts"] - b["pts"]).max(initial=0.0)))
    for r, res in enumerate(ha):
        idle = [k for k in ("stem", "down1", "nms", "vresample_coef") if res["launches"][k] == 0]
        if idle or res["launches"]["ordered_scatter"]:
            raise AssertionError(f"[rest] HA rank {r}: launches {res['launches']}")
        add(res["launches"])
    audit = (td / "logs" / "ha_rest" / "export.txt").read_text().splitlines()
    log(f"[rest] (e) export_detector_homoAdapt on {REST_WORLD} ranks of one card: "
        f"{[r['written'] for r in ha]} of the {n} images each, the same {n} files as phase 16's "
        f"one process, points max abs diff {diff:.3g} (bar {HA_MULTI_MAX}); launches per rank "
        f"{[r['launches'] for r in ha]}; {n / max(r['s'] for r in ha):.2f} img/s over the "
        f"ranks' exports with the model load ({wall:.1f} s with the processes' start; {smi})")
    if diff > HA_MULTI_MAX or len(audit) != 2:
        raise AssertionError(f"[rest] HA on {REST_WORLD} ranks: diff {diff}, audit {audit}")
    return total


def classical_phase(dev: torch.device, td: Path, smi: str) -> dict:
    """Phase 21 [classical]: the classical SIFT/ORB baselines.  (a) the
    port's SIFT and ORB (C++ on the host) on the committed fixtures; (b) the
    cross-checked matcher kernel against its plain version, exactly, and
    its times; (c) ``export_classical`` for both methods over phase 12's
    corpus under ``td``, the card's files against the CPU's, the port's
    evaluation of both.  Returns {"launches": per kernel of (c)'s two
    exports, "row": the matcher's entry of the kernels line}."""
    from ssp_torch.cli.export_classical import export_classical
    from ssp_torch.export import features
    from ssp_torch.kernels import bfmatch
    from ssp_torch.utils.config import load_config

    # ---- (a) the fixtures: OpenCV's portable SIFT and its ORB, exactly
    manifest = json.loads((CLASSICAL_FIXTURES / "manifest.json").read_text())
    n_kp, host_ms, envelope = {}, {"sift": [], "orb": []}, []
    for name in sorted(manifest["keypoints"]):
        with np.load(CLASSICAL_FIXTURES / f"{name}.npz") as z:
            fx = {k: z[k] for k in z.files}
        for run, method in (("sift_plain", "sift"), ("orb", "orb")):
            detect = features.sift if method == "sift" else features.orb
            t0 = time.perf_counter()
            kps, d = detect(fx["image"], manifest["nfeatures"])
            host_ms[method].append((time.perf_counter() - t0) * 1e3)
            kp = np.concatenate([kps.pt, kps.size[:, None], kps.angle[:, None],
                                 kps.response[:, None]], axis=1)
            if not (np.array_equal(kp, fx[f"{run}_kp"]) and
                    np.array_equal(kps.octave, fx[f"{run}_octave"]) and
                    np.array_equal(d, fx[f"{run}_desc"])):
                raise AssertionError(f"[classical] (a) {method} on {name} differs from OpenCV's "
                                     f"{run}: {len(kp)} vs {len(fx[f'{run}_kp'])} keypoints")
            n_kp[f"{name}/{method}"] = len(kp)
            if method == "sift":  # OpenCV's default path, measured where the fixtures were made
                ref = fx["sift_default_kp"][:, :2]
                if len(ref) and len(kp):
                    dist = np.linalg.norm(ref[:, None] - kp[None, :, :2], axis=-1)
                    envelope.append(float((dist.min(1) < 0.1).mean()))
    log(f"[classical] (a) SIFT and ORB on the {len(manifest['keypoints'])} fixtures "
        f"(OpenCV {manifest['opencv']}, nfeatures {manifest['nfeatures']}): equal to OpenCV's "
        f"portable SIFT and its ORB, every keypoint and descriptor byte ({n_kp}); against "
        f"OpenCV's default-path SIFT, share of its keypoints within 0.1 px: "
        f"{min(envelope):.4f} at worst; host ms per 240x320 image on the host CPU (one thread): "
        f"SIFT {np.mean(host_ms['sift']):.2f}, ORB {np.mean(host_ms['orb']):.2f}")

    # ---- (b) the matcher kernel against its plain version, exactly, then
    # timed (bench_own_kernels: the cases, the comparisons and the readings)
    matches, err, on_card = check_matcher(matcher_cases(SEED + 21), dev)
    times = matcher_rows(on_card, td)
    for k, v in times.items():
        log(f"[classical] (b) matcher {k}: device {v['ms']:.4f} ms, eager {v['eager_ms']:.4f} "
            f"ms (bound {v['bound_ms']:.6f} ms by {v['bound_by']}); "
            f"{len(v['ops'])} device operations per call under torch.profiler in a fresh "
            f"process ("
            + ", ".join(f"{n} {ms:.4f} ms" for n, ms in v["ops"]) +
            f"); with the wrapper's checks and compaction {v['wrapper_ms']:.4f} ms, plain "
            f"{v['plain_ms']:.4f} ms ({smi})")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path("bfmatch"))],
                              capture_output=True, text=True, check=True).stdout
        mma = {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("IMMA", "BMMA")}
        log(f"[classical] (b) tensor-core opcodes in the matcher's library (cuobjdump -sass): "
            f"{mma}")
        if not (mma["IMMA"] and mma["BMMA"]):
            raise AssertionError(f"[classical] (b) the matcher's library holds {mma}")
    else:
        log(f"[classical] (b) no cuobjdump beside {_build._nvcc()}: the matcher's opcodes "
            f"not counted")
    log(f"[classical] (b) matcher equal to its plain version (on the card and on the CPU) on "
        f"{matches} cross-checked matches, max abs err {err}; an empty side gives none")

    # ---- (c) export_classical on the card over phase 12's corpus
    config = load_config(ROOT / "configs" / "classical_descriptors.yaml")
    n_pairs = HP_SEQ * len(HP_VIEWS)
    launches, result = {}, {}
    for method in ("sift", "orb"):
        cfg = copy.deepcopy(config)
        cfg["model"]["name"] = method
        exper = f"classical_{method}"
        reset_launches()
        seconds = {}
        t0 = time.perf_counter()
        written = export_classical(cfg, exper, device=dev, seconds=seconds)
        wall = time.perf_counter() - t0
        counts = {**read_launches(), "bfmatch": bfmatch.launches}
        out = td / "logs" / exper / "predictions"
        with_matches = 0
        for i in range(n_pairs):
            with np.load(out / f"{i}.npz") as z:
                with_matches += int(len(z["prob"]) > 0 and len(z["warped_prob"]) > 0)
        if written != n_pairs or counts["bfmatch"] != with_matches or with_matches == 0 or \
                any(counts[k] for k in counts if k != "bfmatch"):
            raise AssertionError(f"[classical] (c) {method}: {written} pairs, launches {counts}, "
                                 f"{with_matches} pairs with keypoints on both sides")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        mtimes = {f.name: f.stat().st_mtime_ns for f in out.glob("*.npz")}
        again = export_classical(cfg, exper, device=dev)
        if again != n_pairs or mtimes != {f.name: f.stat().st_mtime_ns for f in out.glob("*.npz")}:
            raise AssertionError(f"[classical] (c) {method}: a second call wrote files")
        # the same export with the matcher's plain version on the CPU: the same files
        export_classical(cfg, f"{exper}_cpu", device="cpu")
        cpu_out = td / "logs" / f"{exper}_cpu" / "predictions"
        for i in range(n_pairs):
            with np.load(out / f"{i}.npz") as a, np.load(cpu_out / f"{i}.npz") as b:
                if sorted(a.files) == sorted(b.files) and a["matches"].shape == b["matches"].shape:
                    err = max(err, float(np.abs(a["matches"] - b["matches"]).max(initial=0.0)))
                if sorted(a.files) != sorted(b.files) or \
                        not all(np.array_equal(a[k], b[k]) for k in a.files):
                    raise AssertionError(f"[classical] (c) {method} pair {i}: the card's file "
                                         f"differs from the CPU's")
        shares = {k: v / sum(seconds.values()) for k, v in seconds.items()}
        summary = evaluate(out)
        result[method] = {"pairs_per_s": n_pairs / wall, "seconds": seconds, "summary": summary}
        log(f"[classical] (c) export_classical {method}: {written} pairs, matcher launched "
            f"{counts['bfmatch']} times (once per pair with keypoints on both sides), a second "
            f"call wrote nothing, equal to the CPU export; {n_pairs / wall:.2f} pairs/s by the "
            f"host clock, ms per pair: " +
            ", ".join(f"{k} {v / n_pairs * 1e3:.2f} ({shares[k]:.3f})" for k, v in seconds.items())
            + f" ({smi})")
        log(f"[classical] (c) evaluate {method}: " +
            ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in summary.items()))

    k = f"{MATCHER_ROWS}x{MATCHER_ROWS}_sift"
    row = {"name": "bfmatch", "route": "cuda", "source": "ssp_torch/csrc/bfmatch.cu",
           "replaces": "no TPU kernel: ssp/export/classical.py:44 cv2.BFMatcher on the host",
           "tpu_counterpart": False, "launches": launches["bfmatch"],
           "launches_classical": launches["bfmatch"], "max_abs_err": err,
           "ms": times[k]["ms"], "plain_ms": times[k]["plain_ms"],
           "bound_ms": times[k]["bound_ms"], "bound_by": times[k]["bound_by"],
           "library_ms": None, "shape": k, "eager_ms": times[k]["eager_ms"],
           "ops_per_call": len(times[k]["ops"]),
           "orb_ms": times[f"{MATCHER_ROWS}x{MATCHER_ROWS}_orb"]["ms"],
           "orb_eager_ms": times[f"{MATCHER_ROWS}x{MATCHER_ROWS}_orb"]["eager_ms"],
           "orb_plain_ms": times[f"{MATCHER_ROWS}x{MATCHER_ROWS}_orb"]["plain_ms"],
           "orb_bound_ms": times[f"{MATCHER_ROWS}x{MATCHER_ROWS}_orb"]["bound_ms"],
           "sift_pairs_per_s": result["sift"]["pairs_per_s"],
           "orb_pairs_per_s": result["orb"]["pairs_per_s"]}
    return {"launches": launches, "row": row}


def dispatch_ha_group(dev: torch.device, smi: str) -> dict:
    """Phase 22 (a): bench_ha's group (8x240x320, 100 warps, the export
    settings of configs/magicpoint_coco_export.yaml, trained weights) as one
    CUDA graph against the staged group on the same homographies; the times
    of both, by CUDA events and by the host clock, the host's queueing, the
    capture's time and the graph pool's memory.  Returns the graph's
    launches: those of one replay, counted at the capture (the wrappers'
    counters see no replay), times the replays."""
    G, HH, HW = bench_ha.GROUP, bench_ha.H, bench_ha.W
    staged = bench_ha.build_ha(NPZ, device=dev)
    graphed = bench_ha.build_ha(NPZ, device=dev, one_dispatch=True)
    images = torch.from_numpy(structured_images(G, HH, HW, SEED + 22)[..., 0]).to(dev)

    def gens():
        return [torch.Generator().manual_seed(SEED + 22 + i) for i in range(G)]

    want_pts, want_valid = staged(images, generator=gens())
    got_pts, got_valid = graphed(images, generator=gens())
    again_pts, again_valid = graphed(images, generator=gens())
    torch.cuda.synchronize()
    region = graphed.regions[(G, HH, HW)]
    per_replay = dict(region.launches_per_replay)
    diff = float((got_pts - want_pts).abs().max())
    log(f"[dispatch] (a) HA group {G}x{HH}x{HW}, {bench_ha.NUM_H} warps, one CUDA graph against "
        f"the staged group, same homographies: valid equal {torch.equal(got_valid, want_valid)} "
        f"({int(got_valid.sum())} points), points max abs diff {diff:.3g} (bar "
        f"{HA_ONE_DISPATCH_MAX}); a second replay equal to the first "
        f"{torch.equal(again_pts, got_pts) and torch.equal(again_valid, got_valid)}")
    if not torch.equal(got_valid, want_valid) or diff > HA_ONE_DISPATCH_MAX:
        raise AssertionError(f"HA one_dispatch against staged: valid equal "
                             f"{torch.equal(got_valid, want_valid)}, points diff {diff}")
    if not (torch.equal(again_pts, got_pts) and torch.equal(again_valid, got_valid)):
        raise AssertionError("two replays of the HA graph on the same inputs differ")
    with torch.inference_mode():
        eager_pts, eager_valid = region.eager()  # the same chain, eagerly, on the same inputs
    if not (torch.equal(eager_pts, got_pts) and torch.equal(eager_valid, got_valid)):
        raise AssertionError("the HA graph's replay differs from the same chain run eagerly")
    log("[dispatch] (a) the replay equal bit for bit to the same chain run eagerly on the "
        "same inputs (CapturedRegion.eager)")
    idle = [k for k in ("stem", "down1", "nms", "vresample_coef") if per_replay[k] == 0]
    if idle or per_replay["vresample"] or per_replay["ordered_scatter"]:
        raise AssertionError(f"HA graph launches per replay {per_replay}")
    gen = torch.Generator().manual_seed(SEED + 23)
    runs = {"staged": [], "graph": []}
    for name in ("staged", "graph", "graph", "staged"):
        fn = staged if name == "staged" else graphed
        runs[name].append([t / bench_ha.ITERS * 1e3 for t in bench_ha.time_groups(fn, images, gen)])
    launches = {k: v * region.replays for k, v in per_replay.items()}
    # the host's own work per group before the replay: the homographies and
    # both warps' plans (make_ha_fn's prologue, done here the same way)
    params = DEFAULT_HA["homographies"]["params"]
    t0 = time.perf_counter()
    for _ in range(bench_ha.ITERS):
        Hs = torch.cat([torch.eye(3).expand(G, 1, 3, 3), torch.stack([
            sample_homographies(bench_ha.NUM_H - 1, generator=g, shift=-1.0, **params)
            for g in gens()])], dim=1).reshape(-1, 3, 3)
        warp_twopass.twopass_plan(Hs, HH, HW)
        warp_twopass.twopass_plan(inv3(Hs), HH, HW)
    prologue_ms = (time.perf_counter() - t0) * 1e3 / bench_ha.ITERS
    log(f"[dispatch] (a) ms per group ({smi}), runs in the order staged, graph, graph, staged, "
        f"{bench_ha.ITERS} groups each: " + "; ".join(
            f"{k}: CUDA events {' / '.join(f'{r[0]:.3f}' for r in v)}, host clock "
            f"{' / '.join(f'{r[1]:.3f}' for r in v)}, host queueing "
            f"{' / '.join(f'{r[2]:.3f}' for r in v)}" for k, v in runs.items()) +
        f"; the graph's host prologue alone {prologue_ms:.3f} ms per group (the host queues "
        f"ahead of the card by at most {graphs.SLOTS} groups: the pinned slots); capture "
        f"{region.capture_s * 1e3:.1f} ms, graph pool "
        f"{region.pool_bytes / 2 ** 20:.1f} MiB; launches per replay {per_replay} (counted at "
        f"the capture) x {region.replays} replays = {launches}")
    return launches


def dispatch_ha_cli(dev: torch.device, td: Path) -> dict:
    """Phase 22 (b): export_detector_homoAdapt with one_dispatch over phase
    16's images: the same files as phase 16's staged export, byte for byte
    in their points.  Returns the launches (the eager warm-up calls by the
    wrappers' counters, the replays as the capture's count per replay times
    the region's replays)."""
    config = copy.deepcopy(HA_CLI_CONFIG)
    config["pretrained"] = str(ROOT / HA_CLI_CONFIG["pretrained"])
    config["data"]["homography_adaptation"]["one_dispatch"] = True
    n = HA_CLI_IMAGES
    per_image = {"stem": 1, "down1": 1, "nms": 1, "vresample": 0, "vresample_coef": 4,
                 "ordered_scatter": 0}
    regions: dict = {}
    reset_launches()
    t0 = time.perf_counter()
    written = export_detector_homoAdapt(config, "ha_cli_graph", device=dev, regions=regions)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counted = read_launches()
    # the first image: WARMUP eager calls and the capture, each counted once;
    # then one replay per image
    if written != n or counted != {k: v * (graphs.WARMUP + 1) for k, v in per_image.items()}:
        raise AssertionError(f"HA CLI one_dispatch: {written} images, counted {counted}")
    if len(regions) != 1:
        raise AssertionError(f"HA CLI one_dispatch: regions {list(regions)}")
    region = next(iter(regions.values()))
    per_replay = region.launches_per_replay
    if per_replay != per_image:
        raise AssertionError(f"HA CLI one_dispatch: {per_replay} launches per replay")
    # the wrappers counted the warm-up calls and the capture (which ran nothing)
    launches = {k: counted[k] - v + v * region.replays for k, v in per_replay.items()}
    ours = td / "logs" / "ha_cli_graph" / "predictions" / "train2017"
    theirs = td / "logs" / "ha_cli" / "predictions" / "train2017"
    names = sorted(p.name for p in ours.glob("*.npz"))
    if names != sorted(p.name for p in theirs.glob("*.npz")):
        raise AssertionError(f"HA CLI one_dispatch files {names}")
    for name in names:
        with np.load(ours / name) as a, np.load(theirs / name) as b:
            if not np.array_equal(a["pts"], b["pts"]):
                raise AssertionError(f"HA CLI one_dispatch: {name} differs from phase 16's")
    log(f"[dispatch] (b) export_detector_homoAdapt with one_dispatch: {written} files equal to "
        f"phase 16's; {n / cli_s:.2f} img/s by the host clock with the model load, the warm-up "
        f"and the capture; launches {launches} ({graphs.WARMUP} eager calls and "
        f"{region.replays} replays of {per_replay}, the replays counted at the capture)")
    return launches


def _dispatch_run(cfg: dict, name: str, mode: str, dev: torch.device, attach,
                  deterministic: bool) -> dict:
    """One run of phase 22's training loop (``dispatch_train``): a fresh agent,
    graphed or eager, with its corpus from ``attach``; one untimed turn, the
    timed turns, one profiled turn.  ``deterministic``: under
    ``torch.use_deterministic_algorithms`` (no atomics whose order changes
    from run to run)."""
    from ssp_torch.utils.experiment import ExperimentPaths

    turns = DISPATCH_TIMED // DISPATCH_SPD
    gc.collect()  # an earlier run's agent and graph (a reference cycle) leave the card
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()  # by earlier phases, not this run
            agent = registry.get("agent", cfg["front_end_model"])(
                cfg, save_path=ExperimentPaths(name), device=dev, eager=mode == "eager")
            attach(agent)
            if agent.graphed() != (mode == "graph"):
                raise AssertionError(f"{name}: graphed() is {agent.graphed()}")
            metrics = [{k: float(v) for k, v in agent.dispatch().items()}]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            wait0 = agent.loader_wait_s
            t0 = time.perf_counter()
            e0.record()
            out = [agent.dispatch() for _ in range(turns)]
            e1.record()
            queued_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            wait_s = agent.loader_wait_s - wait0
            peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
            metrics += [{k: float(v) for k, v in m.items()} for m in out]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                metrics.append({k: float(v) for k, v in agent.dispatch().items()})
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t1
    finally:
        torch.use_deterministic_algorithms(False)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("Optimizer.") and not e.is_user_annotation]
    busy_ms = sum(e.device_time_total for e in on_card) / 1e3
    steps = turns * DISPATCH_SPD
    region = agent.region
    state = {k: v.detach().clone() for k, v in agent.state.model.state_dict().items()}
    etas, count = agent.state.etas.detach().clone(), agent.state.step
    # the host's own work per step: the prologue (homographies and warp plans)
    t1 = time.perf_counter()
    for _ in range(10):
        agent._prologue(cfg["data"]["preprocessing"]["resize"])
    prologue_ms = (time.perf_counter() - t1) * 1e2
    return {
        "ms_per_step": e0.elapsed_time(e1) / steps, "host_ms_per_step": host_s * 1e3 / steps,
        "queue_ms_per_step": queued_s * 1e3 / steps, "prologue_ms": prologue_ms,
        "wait_ms_per_step": wait_s * 1e3 / steps,
        "idle": max(0.0, 1 - busy_ms / (prof_s * 1e3)) if on_card else None,
        "device_ops_per_step": len(on_card) / DISPATCH_SPD, "peak_gib": peak,
        "metrics": metrics, "step": count, "state": state, "etas": etas,
        "capture_ms": region.capture_s * 1e3 if region else None,
        "pool_mib": region.pool_bytes / 2 ** 20 if region else None,
        "per_replay": dict(region.launches_per_replay) if region else None,
        "replays": region.replays if region else 0,
        "inputs": sorted(region.inputs) if region else [],
        "loader": agent.train_loader is not None,
        "nondeterministic": sorted({str(w.message).split(".")[0][:120] for w in caught
                                    if "deterministic" in str(w.message)}),
    }


def _largest_diff(a: dict, b: dict) -> float:
    """The largest absolute difference between two runs' metrics of every
    turn, module states (parameters and BatchNorm statistics) and ηs."""
    return max([abs(x[k] - y[k]) for x, y in zip(a["metrics"], b["metrics"]) for k in x] +
               [float((a["state"][k].double() - b["state"][k].double()).abs().max())
                for k in a["state"]] + [float((a["etas"] - b["etas"]).abs().max())])


def dispatch_train(cfg: dict, tag: str, dev: torch.device, smi: str, attach,
                   scatters: int) -> dict:
    """Phase 22 (c)/(d)/(e): the trainer's loop with DISPATCH_SPD steps per
    dispatch, graphed and eager (the agent's ``eager`` keyword), from the
    same state and seeds, ``attach(agent)`` giving each its device corpus or
    its host loader:
    one untimed turn (WARMUP eager steps, the capture, the replays), then
    DISPATCH_TIMED steps timed by CUDA events and the host clock with the
    peak memory, then one turn under ``torch.profiler`` for the idle share.
    The two loops run once as they are (timed) and once under
    ``torch.use_deterministic_algorithms``, where the metrics of every turn,
    the parameters, the BatchNorm statistics and the ηs must be equal.
    The captured step launches the ordered scatter ``scatters`` times.
    Returns the graphed run's launches."""
    cfg = dict(copy.deepcopy(cfg), steps_per_dispatch=DISPATCH_SPD)
    res = {(mode, det): _dispatch_run(cfg, f"dispatch_{tag[1]}_{mode}_{int(det)}", mode, dev,
                                      attach, det)
           for det in (False, True) for mode in ("graph", "eager")}
    g, e = res[("graph", False)], res[("eager", False)]
    gd, ed = res[("graph", True)], res[("eager", True)]
    diff, diff_det = _largest_diff(g, e), _largest_diff(gd, ed)
    B = cfg["model"].get("real_batch_size", cfg["model"]["batch_size"])
    launches = {k: v * g["replays"] for k, v in g["per_replay"].items()}
    log(f"[dispatch] {tag} {DISPATCH_SPD} steps per dispatch, {len(g['metrics'])} turns from "
        f"the same state and seeds ({smi}), graphed against eager, the largest absolute "
        f"difference over every turn's metrics, the parameters, the BatchNorm statistics and "
        f"the etas: {diff:.3g} as they run, switch off (loss {g['metrics'][-1]['loss']:.6f} / "
        f"{e['metrics'][-1]['loss']:.6f}), {diff_det:.3g} under "
        f"torch.use_deterministic_algorithms (loss {gd['metrics'][-1]['loss']:.6f} / "
        f"{ed['metrics'][-1]['loss']:.6f}; ops it flagged: {gd['nondeterministic'] or 'none'}); "
        f"step counts {g['step']} / {e['step']}")
    for mode, r in (("graph", g), ("eager", e)):
        idle = "not measured" if r["idle"] is None else f"{r['idle']:.3f}"
        log(f"[dispatch] {tag} {mode}: {r['ms_per_step']:.3f} ms/step by CUDA events over "
            f"{DISPATCH_TIMED} steps ({B * 1e3 / r['ms_per_step']:.2f} img/s), "
            f"{r['host_ms_per_step']:.3f} ms/step by the host clock, the host queued a step in "
            f"{r['queue_ms_per_step']:.3f} ms (its prologue alone {r['prologue_ms']:.3f} ms, "
            f"its wait for the host loader {r['wait_ms_per_step']:.3f} ms); "
            f"idle share {idle} ({r['device_ops_per_step']:.0f} device operations per step "
            f"under torch.profiler); peak memory of the timed steps {r['peak_gib']:.2f} GiB "
            f"above what earlier phases hold" +
            ("" if r["capture_ms"] is None else f", the graph's pool {r['pool_mib']:.1f} MiB "
                                                f"besides; capture {r['capture_ms']:.1f} ms"))
    log(f"[dispatch] {tag} graph launches: {g['per_replay']} per replay (counted at the "
        f"capture) x {g['replays']} replays = {launches}")
    if gd["step"] != ed["step"] or g["step"] != e["step"] or diff != 0.0 or diff_det != 0.0:
        raise AssertionError(f"{tag}: the graphed loop differs from the eager loop by "
                             f"{diff} (switch off) and {diff_det} (on); steps "
                             f"{g['step']} / {e['step']}")
    if not all(np.isfinite(v) for m in g["metrics"] for v in m.values()):
        raise AssertionError(f"{tag}: a non-finite metric")
    if g["per_replay"]["vresample_coef"] == 0 or g["per_replay"]["ordered_scatter"] != scatters:
        raise AssertionError(f"{tag}: the captured step launches {g['per_replay']}, "
                             f"ordered_scatter expected {scatters}")
    if ("raw.image" in g["inputs"]) != g["loader"]:
        raise AssertionError(f"{tag}: the graph's inputs {g['inputs']}")
    return launches


def dispatch_phase(dev: torch.device, td: Path, smi: str) -> dict:
    """Phase 22 [dispatch]: the JAX package's single-program dispatches as
    CUDA graphs, on the trained weights.  (a) the HA group as one graph
    against the staged group; (b) the HA CLI with ``one_dispatch`` against
    phase 16's files; (c) the flagship on phase 17's tree and (d) stage 1 on
    phase 18's corpus, each with the device corpus, and (e) the flagship on
    phase 17's tree through the host loader (the JAX trainer's
    ``multi_train_step``), each with DISPATCH_SPD steps per dispatch,
    graphed against eager.  Returns the launches per path."""
    out = {"ha": dispatch_ha_group(dev, smi), "ha_cli": dispatch_ha_cli(dev, td)}
    for tag, name, source, scatters in (("(c) flagship", "train", "corpus", SCATTER_PER_STEP),
                                        ("(d) stage 1", "synth", "corpus", 0),
                                        ("(e) flagship, host loader", "train", "loader",
                                         SCATTER_PER_STEP)):
        cfg = yaml.safe_load((td / f"{name}_cfg.yaml").read_text())
        cfg.update(pretrained=str(NPZ), reset_iter=True, auto_resume=False)
        train_set = train_cli.make_dataset(cfg, "train")
        if source == "corpus":
            def attach(a, train_set=train_set):
                a.attach_device_corpus(train_set)
        else:
            workers = int((cfg.get("training") or {}).get("workers_train", 4))

            def attach(a, train_set=train_set, workers=workers):
                a.train_loader = Prefetcher(train_set.batches(
                    a.real_batch_size, shuffle=True, seed=SEED, workers=workers))

            # the loader's own pace: batches read one after another, no step beside
            it = train_set.batches(int(cfg["model"]["batch_size"]), shuffle=True, seed=SEED,
                                   workers=workers)
            next(it)
            t0 = time.perf_counter()
            for _ in range(DISPATCH_TIMED):
                next(it)
            threaded = (time.perf_counter() - t0) * 1e3 / DISPATCH_TIMED
            it.close()
            t0 = time.perf_counter()
            for i in range(len(train_set)):
                train_set[i]
            serial = (time.perf_counter() - t0) * 1e3 / len(train_set)
            log(f"[dispatch] (e) the host loader alone, no step beside, by the host clock: "
                f"{threaded:.3f} ms per batch of {cfg['model']['batch_size']} with {workers} "
                f"decode threads over {DISPATCH_TIMED} batches; one thread {serial:.3f} ms per "
                f"sample over the {len(train_set)} samples")
        out["loader" if source == "loader" else name] = dispatch_train(cfg, tag, dev, smi,
                                                                        attach, scatters)
    return out


def tools_phase(dev: torch.device, td: Path, smi: str) -> dict:
    """Phase 23 [tools]: the port's evaluation tools on the card, each from 0
    launches: ``eval_sequence --pred`` over phase 15's export, ``eval_sequence
    --synthetic`` (TOOLS_SYNTH_FRAMES frames at 240×320, the fp32 module as
    the JAX tool's fp32 flax), ``eval_semantic`` over phase 17's ``Coco_sem``
    val split with its trained weights, ``run_export`` over phase 12's
    HPatches tree with the trained weights.  Prints each tool's metrics and
    seconds; returns the launches summed over the four."""
    total: dict = {}

    def run(name, fn, check):
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the tools print their results
            out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        bad = check(out)
        shown = {k: v for k, v in out.items() if not isinstance(v, dict)}
        log(f"[tools] {name}: {secs:.2f} s ({smi}); launches {launches}; {json.dumps(shown)}")
        if bad:
            raise AssertionError(f"[tools] {name}: {bad}")
        return out

    def finite(*keys):
        return lambda m: [k for k in keys if not np.isfinite(float(m[k]))]

    run("eval_sequence --pred (phase 15's export_sequence, 2 drives x 16 frames)",
        lambda: eval_sequence.main(["--pred", str(td / "logs" / "sequence" / "predictions"),
                                    "--device", str(dev)]),
        lambda m: ([] if m["n_sequences"] == SEQ_DRIVES and
                   m["n_frames"] == SEQ_DRIVES * SEQ_FRAMES else ["sequences"]) +
        finite("survival_mean", "mean_matches_per_pair")(m))
    run(f"eval_sequence --synthetic ({TOOLS_SYNTH_FRAMES} frames at 240x320)",
        lambda: eval_sequence.main(["--synthetic", "--ckpt", str(NPZ), "--n-frames",
                                    str(TOOLS_SYNTH_FRAMES), "--device", str(dev)]),
        lambda m: ([] if m["reproj_pairs"] > 0 else ["no pair matched"]) +
        finite("reproj_median_px", "survival_mean", "reproj_inlier3_mean")(m))
    npz = td / "logs" / "train" / "checkpoints" / f"superPointNet_{TRAIN_RUN['train_iter']}.npz"
    run("eval_semantic (phase 17's val split, its trained weights)",
        lambda: eval_semantic.main([str(npz), "--root", str(td / "COCO"), "--sem-labels",
                                    str(td / "COCO" / "annotations"), "--device", str(dev)]),
        lambda m: ([] if m["images"] == 8 else ["images"]) +
        finite("pixel_accuracy", "mean_class_accuracy", "mean_iou")(m))
    cfg = yaml.safe_load((ROOT / run_export_cli.DEFAULT_CONFIG).read_text())
    cfg["data"]["root"] = str(td / "HPatches")
    cfg["pretrained"] = str(NPZ)
    cfg_path = td / "run_export.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    run("run_export (phase 12's 32 pairs, the trained weights)",
        lambda: run_export_cli.main([str(cfg_path), "tools_hp", "--device", str(dev)]),
        lambda m: ([] if m["n_files"] == HP_SEQ * len(HP_VIEWS) else ["n_files"]) +
        finite("repeatability", "localization_err", "nn_map", "matching_score")(m))
    return total


def corpus_phase(dev: torch.device, td: Path, smi: str) -> dict:
    """Phase 24 [corpus]: the five corpus tools (``ssp_torch/cli/make_*.py``)
    write their trees under ``td / "corpus"``, each held to the manifest of the
    JAX scripts' trees; then the stand-in chain of
    ``docs/REAL_DATA_RUNBOOK.md`` on those trees through the port's CLIs, each
    stage cut as CORPUS_TRAIN says: the stage-2 HA export of both splits,
    ``train_joint`` on ``configs/pipeline240_joint_wsem.yaml`` on the HA labels
    and on the oracle labels, ``export_eval`` on ``configs/pipeline240_sweep.
    yaml`` over the synthetic HPatches, ``export_sequence`` and ``eval_sequence
    --pred`` on the ``--motion`` tree.  Each stage's outputs are checked, each
    tool's and stage's seconds printed.  Returns the launches over the phase."""
    from ssp_torch.cli import (export_eval, make_coco_sem_labels, make_coco_tree,
                               make_gt_labels, make_kitti_tree, make_synth_hpatches)
    from ssp_torch.data.corpus import tree_digests

    t_phase = time.perf_counter()
    work = td / "corpus"
    manifest = json.loads(CORPUS_MANIFEST.read_text())
    cut = manifest["coco_split_sizes"]
    coco, gt, hp = work / "COCO240", work / "gt_labels", work / "HPatches"
    total: dict = {}
    saved = os.environ["SSP_DATA_PATH"]
    os.environ["SSP_DATA_PATH"] = str(work / "data")  # the synthetic shards' cache

    def run(name, fn):
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the tools print what they wrote
            out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"[corpus] {name}: {secs:.2f} s ({smi}); launches {launches}")
        return out

    try:
        # ---- (a) the five tools, against the manifest
        run(f"make_coco_tree at {cut['training']} + {cut['validation']} per primitive "
            "(the script's 1500 + 40 cut)",
            lambda: make_coco_tree.make_coco_tree(coco, split_sizes=cut))
        run("make_gt_labels at the same cut",
            lambda: make_gt_labels.make_gt_labels(gt, split_sizes=cut))
        run("make_coco_sem_labels (sigma 4)",
            lambda: make_coco_sem_labels.main(["--root", str(coco)]))
        run("make_synth_hpatches (40 sequences x 2 views, 240x320)",
            lambda: make_synth_hpatches.main([str(hp)]))
        for name, flags in (("KITTI_synth", []), ("KITTI_motion", ["--motion"])):
            run(f"make_kitti_tree {' '.join(flags) or '(static)'} (2 + 1 drives x 10 frames, "
                "384x1248)",
                lambda: make_kitti_tree.main(["--root", str(work / name), *flags]))
        for name, want in manifest["trees"].items():
            got = tree_digests(work / name)
            bad = sorted(k for k in set(want) | set(got) if got.get(k) != want.get(k))
            if bad:
                raise AssertionError(f"[corpus] {name}: {len(bad)} of {len(want)} files differ "
                                     f"from the manifest, e.g. {bad[:4]}")
            log(f"[corpus] {name}: {len(got)} files equal to the JAX scripts' manifest")

        # ---- (b) the stand-in chain on those trees
        preds = td / "logs" / "corpus_export" / "predictions"
        n_split = {s: len(list((coco / s).glob("*.jpg"))) for s in ("train2017", "val2017")}
        for cfg_name, split in (("pipeline240_export.yaml", "train2017"),
                                ("pipeline240_export_val.yaml", "val2017")):
            cfg = yaml.safe_load((ROOT / "configs" / cfg_name).read_text())
            cfg["data"]["root"], cfg["pretrained"] = str(coco), str(NPZ)
            written = run(f"export_detector_homoAdapt {cfg_name} ({n_split[split]} images, "
                          f"{cfg['data']['homography_adaptation']['num']} warps each; the "
                          "trained weights as the stage-1 detector)",
                          lambda: export_detector_homoAdapt(cfg, "corpus_export", device=dev))
            files = sorted((preds / split).glob("*.npz"))
            if written != n_split[split] or len(files) != n_split[split]:
                raise AssertionError(f"[corpus] HA export of {split}: {written} written, "
                                     f"{len(files)} files")
            for f in files:
                with np.load(f) as z:
                    if z["pts"].ndim != 2 or z["pts"].shape[1] != 3 or \
                            not np.isfinite(z["pts"]).all():
                        raise AssertionError(f"[corpus] {f}: pts {z['pts'].shape}")
        train_cfg = yaml.safe_load((ROOT / "configs" / "pipeline240_joint_wsem.yaml").read_text())
        for exper, labels in (("corpus_joint", preds), ("corpus_joint_gt", gt)):
            cfg = copy.deepcopy(train_cfg)
            cfg["data"].update(root=str(coco), labels=str(labels), sem_labels=str(coco /
                                                                                "annotations"))
            cfg.update(**CORPUS_TRAIN)
            cfg_path = work / f"{exper}.yaml"
            cfg_path.write_text(yaml.safe_dump(cfg))
            run(f"train_joint pipeline240_joint_wsem.yaml on {labels.relative_to(td)} "
                f"(cut: {CORPUS_TRAIN})",
                lambda: train_cli.main(["train_joint", str(cfg_path), exper, "--device",
                                        str(dev)]))
            out = td / "logs" / exper
            rows = [json.loads(r) for r in (out / "metrics_train.jsonl").read_text().splitlines()]
            ckpts = sorted(p.name for p in (out / "checkpoints").glob("superPointNet_*.npz"))
            steps = CORPUS_TRAIN["train_iter"]
            if [r["step"] for r in rows] != list(range(steps)) or \
                    not all(np.isfinite(v) for r in rows for v in r.values()) or \
                    ckpts != [f"superPointNet_{s}.npz" for s in range(
                        CORPUS_TRAIN["save_interval"], steps + 1, CORPUS_TRAIN["save_interval"])]:
                raise AssertionError(f"[corpus] {exper}: rows {rows}, checkpoints {ckpts}")
            log(f"[corpus] {exper}: loss by step " + ", ".join(
                f"{r['step']}: {r['loss']:.4f}" for r in rows) + f"; checkpoints {ckpts}")
        sweep_cfg = yaml.safe_load((ROOT / "configs" / "pipeline240_sweep.yaml").read_text())
        sweep_cfg["data"]["root"] = str(hp)
        sweep_cfg["model"]["folder"] = str(td / "logs" / "corpus_joint" / "checkpoints")
        csv_path = run(f"export_eval pipeline240_sweep.yaml over {hp.name} (80 pairs) and "
                       "corpus_joint's checkpoints",
                       lambda: export_eval.sweep(sweep_cfg, "corpus_sweep", device=dev))
        with open(csv_path) as f:
            sweep_rows = list(csv.DictReader(f))
        n_ckpt = len(list((td / "logs" / "corpus_joint" / "checkpoints").glob("*.npz")))
        if len(sweep_rows) != n_ckpt or not all(
                float(r["repeatability"]) > 0 and np.isfinite(float(r["nn_map"]))
                for r in sweep_rows):
            raise AssertionError(f"[corpus] sweep rows {sweep_rows}")
        log(f"[corpus] sweep: {len(sweep_rows)} rows, " + "; ".join(
            f"iter {r['iter']}: repeatability {float(r['repeatability']):.4f}, NN mAP "
            f"{float(r['nn_map']):.4f}" for r in sweep_rows))
        motion = work / "KITTI_motion"
        seq_cfg = copy.deepcopy(SEQUENCE_CONFIG)
        seq_cfg["data"]["root"] = seq_cfg["data"]["root_split_txt"] = str(motion)
        seq_cfg["pretrained"] = str(NPZ)
        written = run("export_sequence (the --motion tree's 2 train drives x 10 frames, "
                      "384x1248)", lambda: export_sequence(seq_cfg, "corpus_sequence",
                                                          device=dev))
        m = run("eval_sequence --pred (rel_H.json as the ground truth)",
                lambda: eval_sequence.main(["--pred", str(td / "logs" / "corpus_sequence" /
                                                          "predictions"), "--rel-h-root",
                                            str(motion), "--device", str(dev)]))
        if written != 20 or m["n_sequences"] != 2 or m["n_frames"] != 20 or not all(
                np.isfinite(float(m[k])) for k in ("survival_mean", "mean_matches_per_pair")):
            raise AssertionError(f"[corpus] sequence: {written} frames, {m}")
        log(f"[corpus] eval_sequence: " + json.dumps(
            {k: v for k, v in m.items() if not isinstance(v, dict)}))
    finally:
        os.environ["SSP_DATA_PATH"] = saved
    missing = [k for k in ("stem", "down1", "nms", "vresample_coef") if not total.get(k)]
    if dev.type == "cuda" and missing:
        raise AssertionError(f"[corpus] no launch of {missing} over the phase: {total}")
    log(f"[corpus] phase 24: {time.perf_counter() - t_phase:.2f} s ({smi}); launches over the "
        f"phase {total}")
    return total


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rest-rank"]:
        rest_rank(sys.argv[2], sys.argv[3], Path(sys.argv[4]))
    else:
        sys.exit(main())
