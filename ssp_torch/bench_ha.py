"""Homography-adaptation export throughput on one GPU.

Port of the repo's ``bench_ha.py``: images/s of the HA pipeline (warp stack
→ batched forward → inverse warp → aggregate → NMS → top-k) at the
reference's export settings (240×320, ``num: 100``, ``top_k: 600``, NMS 4,
subpixel on: ``configs/magicpoint_coco_export.yaml``), a group of 8 images
per call, ``SuperPointNet_gauss2`` with trained weights.

    python -m ssp_torch.bench_ha [--weights evidence/wsem_weights.npz]
                                 [--sustained] [--profile] [--routes] [--one-dispatch]

Prints ONE JSON line: ``metric``, ``value`` (images/s), ``unit``,
``vs_baseline``, ``ms_per_group``, ``host_queueing_ms_per_group`` (how long
the host took to queue a group's launches: the card cannot go faster),
``device`` (the card's name and power limit), and for the
kernel-level loop ``host_clock_value`` (the same loop by the host clock).
The kernel-level loop is timed with CUDA events after a warm-up group;
``--sustained`` times ``run_ha_export`` over 64 images (host image feed,
device pipeline, npz writes) by the host clock.  ``--profile`` also prints
to stderr where the device time of a group goes, by kernel, and the share
of the window in which the card ran no kernel.  ``--routes`` times the
kernel-level loop on both routes of the two-pass warp in one process, in the
order default, other, other, default (coordinates rebuilt in the resample
kernel from coefficients, or read from grids built with tensor ops:
``warp_twopass.COEF_GRIDS``), and prints each run's ms per group.
``--one-dispatch`` times the staged group beside the group as one CUDA
graph (``make_ha_fn(..., one_dispatch=True)``), in the order staged, graph,
graph, staged, and prints each run's ms per group by CUDA events and by the
host clock and the host's queueing ms, with the capture's ms, the graph
pool's MB and the kernels' launches per replay.  It needs a CUDA card.

Baseline: the published SuperPoint rate is 70 FPS at 480×640 on a Titan X
(arXiv:1712.07629).  One HA image costs 100 forwards at 240×320 = 25
forward-equivalents of 480×640 pixels, so the forward-bound reference HA
rate is 70/25 = 2.8 img/s, before the reference's per-sample CPU costs.
``vs_baseline`` divides by that bound.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from ssp_torch.bench import DEFAULT_WEIGHTS, _card, _profile, structured_images
from ssp_torch.export.homography_adaptation import make_ha_fn, run_ha_export
from ssp_torch.kernels import warp_twopass
from ssp_torch.models.fast_infer import best_apply_fn
from ssp_torch.models.weights import load_flax_npz

NUM_H = 100
H, W = 240, 320
GROUP = 8  # images per call
TOP_K = 600
ITERS = 5  # timed groups, after one of warm-up
SUSTAINED_IMAGES = 64  # --sustained: images through run_ha_export
REFERENCE_HA_IMG_PER_S = 2.8


def build_ha(weights=DEFAULT_WEIGHTS, device="cuda", **overrides):
    """The export-setting HA callable on ``device`` with the trained
    ``SuperPointNet_gauss2``; ``overrides`` replace ``make_ha_fn`` arguments."""
    model = load_flax_npz(weights, "SuperPointNet_gauss2", device=device)
    params = dict(num_h=NUM_H, top_k=TOP_K, nms_radius=4, subpixel=True)
    params.update(overrides)
    return make_ha_fn(best_apply_fn(model, input_hw=(H, W), device=device), device=device,
                      **params)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=str(DEFAULT_WEIGHTS),
                    help="flax-keyed npz, loaded as SuperPointNet_gauss2")
    ap.add_argument("--sustained", action="store_true",
                    help="time run_ha_export over 64 images by the host clock")
    ap.add_argument("--profile", action="store_true",
                    help="print the device time per kernel of two groups to stderr")
    ap.add_argument("--routes", action="store_true",
                    help="time a group on the coef and on the rows route of the warp")
    ap.add_argument("--one-dispatch", action="store_true",
                    help="time the staged group beside the group as one CUDA graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssp_torch.bench_ha needs a CUDA card")
    ha = build_ha(args.weights)
    if args.sustained:
        return sustained(ha)

    images = torch.from_numpy(structured_images(GROUP, H, W, 0)[..., 0]).cuda()
    gen = torch.Generator().manual_seed(1)

    if args.one_dispatch:
        fns = {"staged": ha, "one_dispatch": build_ha(args.weights, one_dispatch=True)}
        runs = {name: [] for name in fns}
        for name in ("staged", "one_dispatch", "one_dispatch", "staged"):
            device_s, host_s, queued_s = time_groups(fns[name], images, gen)
            runs[name].append({"ms_per_group": device_s / ITERS * 1e3,
                               "host_clock_ms_per_group": host_s / ITERS * 1e3,
                               "host_queueing_ms_per_group": queued_s / ITERS * 1e3})
        region = next(iter(fns["one_dispatch"].regions.values()))
        print(json.dumps({"metric": "HA group ms, staged launches against one CUDA graph "
                                    "(8 images, num=100, 240x320)",
                          "runs": runs, "capture_ms": region.capture_s * 1e3,
                          "graph_pool_mb": region.pool_bytes / 2 ** 20,
                          "launches_per_replay": region.launches_per_replay,
                          "device": _card()}))
        return
    if args.routes:
        default = warp_twopass.COEF_GRIDS
        ms = {"coef": [], "rows": []}
        for coef in (default, not default):  # both routes warm before either is timed
            warp_twopass.COEF_GRIDS = coef
            time_groups(ha, images, gen)
        for coef in (default, not default, not default, default):
            warp_twopass.COEF_GRIDS = coef
            ms["coef" if coef else "rows"].append(time_groups(ha, images, gen)[0] / ITERS * 1e3)
        warp_twopass.COEF_GRIDS = default
        print(json.dumps({"metric": "HA group ms by route of the two-pass warp (8 images, "
                                    "num=100, 240x320)",
                          "default_route": "coef" if default else "rows",
                          "ms_per_group": ms, "device": _card()}))
        return
    device_s, host_s, queued_s = time_groups(ha, images, gen)
    img_per_s = GROUP * ITERS / device_s
    if args.profile:
        _profile(lambda x: ha(x, generator=gen), images, batches=2)
    print(json.dumps({
        "metric": "HA export images/sec/chip (num=100, 240x320)",
        "value": img_per_s,
        "unit": "images/s",
        "vs_baseline": img_per_s / REFERENCE_HA_IMG_PER_S,
        "host_clock_value": GROUP * ITERS / host_s,
        "ms_per_group": device_s / ITERS * 1e3,
        "host_queueing_ms_per_group": queued_s / ITERS * 1e3,
        "device": _card(),
    }))


def time_groups(ha, images, gen):
    """(seconds by CUDA events, seconds by the host clock, seconds the host
    took to queue the work) of ITERS groups after a warm-up group (kernel
    build, cuDNN autotuning, a graph's capture).  Where the third is close
    to the second, the card waits for the host's launches."""
    ha(images, generator=gen)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(ITERS):
        ha(images, generator=gen)
    end.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3, time.perf_counter() - t0, queued_s


def sustained(ha) -> None:
    """End-to-end ``run_ha_export`` throughput: host image feed → device
    pipeline → npz writes, including every host↔device transfer; a warm-up
    group first, into its own directory."""
    imgs = [(f"img_{i:04d}", structured_images(1, H, W, i)[0, ..., 0])
            for i in range(SUSTAINED_IMAGES)]
    with tempfile.TemporaryDirectory() as td:
        run_ha_export(ha, imgs[:GROUP], Path(td) / "warm", seed=0, group=GROUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = run_ha_export(ha, imgs, Path(td) / "out", seed=0, group=GROUP)
        dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "HA export sustained images/sec/chip (run_ha_export, num=100, 240x320)",
        "value": n / dt,
        "unit": "images/s",
        "vs_baseline": n / dt / REFERENCE_HA_IMG_PER_S,
        "device": _card(),
    }))


if __name__ == "__main__":
    main()
