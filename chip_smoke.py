"""Smoke run of the PyTorch port (``ssp_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA card, the
CUDA toolkit and PyTorch built for CUDA.  It imports nothing of JAX and
nothing of the JAX package ``ssp``.  Phases, each of which raises on
failure (nothing is caught):

1. the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from ``ssp_torch/csrc`` (one ``nvcc`` per
   source, all started together) and prints the build seconds;
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
6. each kernel's time at the main path's shapes beside its plain
   version's, the cuDNN composition of the same function (stem, down1)
   and its bound on this card.

Prints a ``{"kernels": [...]}`` line, then the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ssp_torch.bench import (BATCH, BORDER, NMS_RADIUS, TOP_K, H, W, build_pipeline,
                             structured_images)
from ssp_torch.core.grid import flatten_detection
from ssp_torch.kernels import _build
from ssp_torch.kernels import down1 as down1_mod
from ssp_torch.kernels import nms as nms_mod
from ssp_torch.kernels import stem as stem_mod
from ssp_torch.models.fast_infer import fold_variables, make_fast_apply
from ssp_torch.models.weights import load_flax_npz

ROOT = Path(__file__).resolve().parent
NPZ = ROOT / "evidence" / "wsem_weights.npz"
ODD_HW = (120, 168)
SEED = 0

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


def cudnn_pair(x_nhwc: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """The same function as one cuDNN composition: conv (BN scale folded
    into the weights, bias in the conv) → ReLU → conv → ReLU → 2×2 max,
    bf16 channels-last.  Timed beside the kernel, used nowhere in the port."""
    x = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2)
    y = F.relu(F.conv2d(x, w1, b1, padding=1))
    y = F.relu(F.conv2d(y, w2, b2, padding=1))
    return F.max_pool2d(y, 2)


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
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {', '.join(_build.SOURCES)} built in {time.perf_counter() - t0:.1f} s")

    # ---- 3. main path ------------------------------------------------------
    model = load_flax_npz(NPZ, "SuperPointNet_gauss2", device=dev)
    detect_describe = build_pipeline(model, dev, k=TOP_K)
    plain_pipeline = build_pipeline(model, dev, k=TOP_K, reference=True)
    images = torch.from_numpy(structured_images(BATCH, H, W, SEED)).to(dev)

    stem_mod.launches = down1_mod.launches = nms_mod.launches = 0
    pts, desc = detect_describe(images)
    torch.cuda.synchronize()
    launches = {"stem": stem_mod.launches, "down1": down1_mod.launches, "nms": nms_mod.launches}
    log(f"[main] detect+describe {BATCH}x{H}x{W}, K={TOP_K}: launches {launches}")
    idle = [k for k, n in launches.items() if n == 0]
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
        heat = flatten_detection(make_fast_apply(model, device=dev, reference=True)(images)["semi"])
        heat = heat[..., 0].contiguous()
    odd = torch.from_numpy(structured_images(2, *ODD_HW, SEED + 1)).to(dev)
    odd_heat = torch.from_numpy(
        np.random.default_rng(SEED).uniform(size=(2, *ODD_HW)).astype(np.float32) ** 4).to(dev)

    err = {"stem": 0.0, "down1": 0.0, "nms": 0.0}
    for pool in (True, False):
        for x in (images, odd):
            e = stem_mod.assert_bf16_close(stem_mod.stem(x, *stem_p, pool=pool),
                                           stem_mod.stem_plain(x, *stem_p, pool=pool))
            err["stem"] = max(err["stem"], e)
        for x in (stem_out, stem_mod.stem_plain(odd, *stem_p)):
            e = stem_mod.assert_bf16_close(down1_mod.down1(x, *down1_p, pool=pool),
                                           down1_mod.down1_plain(x, *down1_p, pool=pool))
            err["down1"] = max(err["down1"], e)
    for h in (heat, odd_heat):
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

    # ---- 6. kernel times at the main path's shapes -------------------------
    # bounds from this run's inputs: each input read once, each output
    # written once, every multiply-add of the convs at the bf16 peak
    affine_bytes = 4 * 64 * 4
    px = images[..., 0].numel()  # stem pixels
    stem_flops = 2.0 * px * 64 * 9 * (1 + 64)
    stem_bytes = images.numel() * 4 + stem_out.numel() * 2 + 9 * 64 * 65 * 2 + affine_bytes
    px2 = stem_out[..., 0].numel()  # down1 pixels
    d1_flops = 2.0 * px2 * 64 * 9 * 64 * 2
    d1_bytes = stem_out.numel() * 2 * 5 // 4 + 2 * 9 * 64 * 64 * 2 + affine_bytes
    # NMS: per cell, 2·iterations − 1 = 5 separable window maxes of 4r max
    # operations, plus ~10 compares and selects; fp32 outside the tensor cores
    nms_ops = heat.numel() * (5 * 4 * NMS_RADIUS + 10.0)
    nms_bytes = 2 * heat.numel() * 4
    stem_lib = (cudnn_weights(*folded["inc0"]), cudnn_weights(*folded["inc1"]))
    d1_lib = (cudnn_weights(*folded["d1a"]), cudnn_weights(*folded["d1b"]))
    with torch.inference_mode():
        rows = [
            ("stem", "ssp/kernels/stem_pallas_v2.py:182", "ssp_torch/csrc/conv_pair.cu",
             lambda: stem_mod.stem(images, *stem_p),
             lambda: stem_mod.stem_plain(images, *stem_p),
             lambda: cudnn_pair(images, *stem_lib[0], *stem_lib[1]),
             bound(stem_flops, PEAK_BF16, stem_bytes)),
            ("down1", "ssp/kernels/down1_pallas.py:107", "ssp_torch/csrc/conv_pair.cu",
             lambda: down1_mod.down1(stem_out, *down1_p),
             lambda: down1_mod.down1_plain(stem_out, *down1_p),
             lambda: cudnn_pair(stem_out, *d1_lib[0], *d1_lib[1]),
             bound(d1_flops, PEAK_BF16, d1_bytes)),
            ("nms", "ssp/kernels/nms_pallas.py:124", "ssp_torch/csrc/nms.cu",
             lambda: nms_mod.nms(heat, radius=NMS_RADIUS, border=BORDER),
             lambda: nms_mod.nms_plain(heat, radius=NMS_RADIUS, border=BORDER),
             None,
             bound(nms_ops, PEAK_FP32, nms_bytes)),
        ]
        kernels = []
        for name, replaces, source, kern, plain, lib, (bound_ms, bound_by) in rows:
            ms, plain_ms = time_ms(kern), time_ms(plain, iters=5)
            lib_ms = time_ms(lib) if lib is not None else None
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": err[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms,
            })
            log(f"[time] {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by {bound_by}), plain "
                f"{plain_ms:.4f} ms, library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    torch.cuda.synchronize()

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
