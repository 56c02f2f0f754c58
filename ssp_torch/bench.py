"""Detect+describe throughput at 480×640 on one GPU.

Port of the repo's ``bench.py``: the full inference path a SLAM front-end
consumes — folded-BN bf16 forward, heatmap flattening, NMS with border
removal, top-K keypoints, descriptor sampling at the keypoints — with the
export-grade post-processing (exact top-K, gather sampler).

    python -m ssp_torch.bench [--weights evidence/wsem_weights.npz] [--profile]

Prints ONE JSON line: ``metric``, ``value`` (images/s, timed with CUDA
events after warm-up), ``unit``, ``vs_baseline`` (against the SuperPoint
paper's 70 FPS at 480×640 on a Titan X, arXiv:1712.07629), ``device``
(the card's name and power limit) and ``postprocess``.  ``--profile``
also prints to stderr where the device time of a batch goes, by kernel,
from ``torch.profiler`` over five batches.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ssp_torch.core.grid import flatten_detection
from ssp_torch.kernels.nms import nms, nms_plain
from ssp_torch.models.fast_infer import make_fast_apply
from ssp_torch.postprocess.points import sample_descriptors, top_k

REFERENCE_IMG_PER_S = 70.0  # SuperPoint paper: 70 FPS @ 480×640, Titan X
H, W = 480, 640
BATCH = 16
TOP_K = 1000
NMS_RADIUS = 4
BORDER = 4
ITERS = 30  # timed batches, after three of warm-up
DEFAULT_WEIGHTS = Path(__file__).resolve().parents[1] / "evidence" / "wsem_weights.npz"

# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 outside the tensor cores, HBM3, int8 (the matcher's byte arithmetic)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12


def bound(flops: float, flop_peak: float, nbytes: float):
    """(least ms for the work on this card, what bounds it)."""
    t_ops, t_bytes = flops / flop_peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def build_pipeline(
    variables: Union[nn.Module, Mapping[str, torch.Tensor]],
    device="cuda",
    *,
    k: int = TOP_K,
    reference: bool = False,
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """``detect_describe(images [B, H, W, 1]) → (pts [B, K, 3] (x, y,
    score), desc [B, K, 256])`` on ``device``.

    ``variables`` is the port's model or its reference-named state dict.
    ``reference=True`` runs every kernel's plain PyTorch version instead
    (the card-side check of the kernels).
    """
    fast_apply = make_fast_apply(variables, device=device, reference=reference)

    @torch.inference_mode()
    def detect_describe(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = fast_apply(images)
        heat = flatten_detection(out["semi"])[..., 0]  # [B, H, W]
        return postprocess(heat, out["desc"], k=k, reference=reference)

    return detect_describe


def postprocess(heat: torch.Tensor, coarse_desc: torch.Tensor, *, k: int = TOP_K,
                reference: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """heat [B, H, W], coarse_desc [B, H/8, W/8, D] → NMS (radius 4) with
    4-px border removal → exact top-``k`` → (pts [B, k, 3] (x, y, score),
    desc [B, k, D]) sampled at the points."""
    suppress = nms_plain if reference else nms
    nmsed = suppress(heat.contiguous(), radius=NMS_RADIUS, border=BORDER)
    B, h, w = nmsed.shape
    scores, idx = top_k(nmsed.reshape(B, h * w), k)
    pts = torch.stack([(idx % w).float(), (idx // w).float(), scores], dim=-1)
    return pts, sample_descriptors(coarse_desc, pts)


def structured_images(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """[n, h, w, 1] fp32 images in [0, 1] of random overlapping rectangles
    on a noisy background: corners the detector fires on, so keypoint
    comparisons are not made among near-ties of a noise image."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0.0, 0.1, size=(n, h, w)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for img in imgs:
        for _ in range(max(4, h * w // 4096)):
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            y1 = rng.integers(y0 + 8, min(h, y0 + h // 3) + 1)
            x1 = rng.integers(x0 + 8, min(w, x0 + w // 3) + 1)
            img[(ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)] = rng.uniform(0.2, 1.0)
    return imgs[..., None]


def main(argv=None) -> None:
    from ssp_torch.models.weights import load_flax_npz

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=str(DEFAULT_WEIGHTS),
                    help="flax-keyed npz, loaded as SuperPointNet_gauss2")
    ap.add_argument("--profile", action="store_true",
                    help="print the device time per kernel over five batches to stderr")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssp_torch.bench needs a CUDA card")

    model = load_flax_npz(args.weights, "SuperPointNet_gauss2", device="cuda")
    fn = build_pipeline(model, "cuda")
    images = torch.from_numpy(
        np.random.default_rng(0).uniform(size=(BATCH, H, W, 1)).astype(np.float32)
    ).cuda()

    for _ in range(3):  # warm-up: kernel build, cuDNN autotuning
        fn(images)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn(images)
    end.record()
    torch.cuda.synchronize()
    img_per_s = BATCH * ITERS / (start.elapsed_time(end) / 1e3)
    if args.profile:
        _profile(fn, images)

    print(json.dumps({
        "metric": "480x640 images/sec/chip (detect+describe)",
        "value": img_per_s,
        "unit": "images/s",
        "vs_baseline": img_per_s / REFERENCE_IMG_PER_S,
        "device": _card(),
        "postprocess": "export_grade",
    }))


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _profile(fn, images: torch.Tensor, batches: int = 5) -> None:
    """Device time by kernel over ``batches`` calls, to stderr: the table
    of ``torch.profiler`` sorted by device time, and the share of the
    window in which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            fn(images)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25),
          file=sys.stderr)
    # the kernels themselves (the operators that launch them carry the same
    # device time again), summed; one stream, so they never overlap
    busy_us = sum(e.device_time_total for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[profile] {batches} batches: {wall_us / batches:.1f} us/batch wall, "
          f"{busy_us / batches:.1f} us/batch of kernels, idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}", file=sys.stderr)


if __name__ == "__main__":
    main()
