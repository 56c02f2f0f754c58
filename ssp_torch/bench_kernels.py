"""The hand-written conv, NMS and coef-resample kernels alone, on one GPU:
each against its plain PyTorch version, then its time, at the shapes the
two paths give it.

    python -m ssp_torch.bench_kernels [--resources] [--cores] [--iters 20]

Shapes: the stem (pooled and unpooled) at 16×480×640 (detect+describe) and
100×240×320 (one chunk of the homography-adaptation export), down1 at
16×240×320×64 and 100×120×160×64, ``vresample_coef`` at 800 warps of 8
shared 320×320 canvases and 100 warps of 100, both axes, with the rows
kernel ``vresample`` on the same coordinates beside it, NMS (radius 4,
3 iterations, border 4) at 16×480×640 and at the HA group's 8×240×320,
held exactly against ``nms_plain`` first.  Weights and inputs are random,
from a seed (the heatmaps uniform⁴, as a softmax leaves them).  Times are
means over back-to-back launches by CUDA events after a warm-up; for NMS
also the host's time to enqueue one ``nms()`` call (host clock over the
same loop, before the synchronise), which bounds back-to-back calls when
it exceeds the kernel's.  ``--resources`` first prints what ``ptxas -v`` says of ``stem.cu``,
``down1.cu``, ``nms.cu`` and ``vresample.cu``; ``--cores`` also times NMS at
every core tile of ``ssp_torch.kernels.nms.CORES`` that fits.  Prints one
JSON line with the times in ms and the card's name and power limit.  It
needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ssp_torch.bench import _card
from ssp_torch.kernels import _build
from ssp_torch.kernels import down1 as down1_mod
from ssp_torch.kernels import nms as nms_mod
from ssp_torch.kernels import stem as stem_mod
from ssp_torch.kernels import vresample as vres_mod
from ssp_torch.kernels import warp_twopass


def _time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pair_params(rng, cin: int, dev):
    out = []
    for c in (cin, 64):
        w = rng.normal(0, (2.0 / (9 * c)) ** 0.5, (3, 3, c, 64)).astype(np.float32)
        s = rng.uniform(0.5, 1.5, 64).astype(np.float32)
        b = rng.normal(0, 0.2, 64).astype(np.float32)
        out += [torch.from_numpy(w).to(dev, torch.bfloat16), torch.from_numpy(s).to(dev),
                torch.from_numpy(b).to(dev)]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resources", action="store_true", help="print ptxas -v of the kernels")
    ap.add_argument("--cores", action="store_true", help="time NMS at every core tile that fits")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssp_torch.bench_kernels needs a CUDA card")
    dev = torch.device("cuda")
    if args.resources:
        for name in ("stem", "down1", "nms", "vresample"):
            print(_build.resource_usage(name), file=sys.stderr, flush=True)
    _build.build_all()
    rng = np.random.default_rng(0)
    times = {}

    with torch.inference_mode():
        stem_p = stem_mod.prepare_stem(*_pair_params(rng, 1, dev))
        down1_p = down1_mod.prepare_down1(*_pair_params(rng, 64, dev))
        for B, H, W in ((16, 480, 640), (100, 240, 320)):
            x = torch.from_numpy(rng.uniform(size=(B, H, W, 1)).astype(np.float32)).to(dev)
            for pool in (True, False):
                got = stem_mod.stem_prepared(x, stem_p, pool=pool)
                torch.cuda.synchronize()
                stem_mod.assert_bf16_close(got, stem_mod.stem_plain(x, *stem_p.params, pool=pool))
                key = f"stem{'' if pool else '_unpooled'} {B}x{H}x{W}"
                times[key] = _time_ms(lambda: stem_mod.stem_prepared(x, stem_p, pool=pool),
                                      args.iters)
                print(f"{key}: {times[key]:.4f} ms", file=sys.stderr, flush=True)
                del got
            x2 = stem_mod.stem_prepared(x, stem_p)
            stem_mod.assert_bf16_close(down1_mod.down1_prepared(x2, down1_p),
                                       down1_mod.down1_plain(x2, *down1_p.params))
            key = f"down1 {B}x{H // 2}x{W // 2}x64"
            times[key] = _time_ms(lambda: down1_mod.down1_prepared(x2, down1_p), args.iters)
            print(f"{key}: {times[key]:.4f} ms", file=sys.stderr, flush=True)
            del x, x2

        for B, H, W in ((16, 480, 640), (8, 240, 320)):
            heat = torch.from_numpy((rng.uniform(size=(B, H, W)) ** 4).astype(np.float32)).to(dev)
            got = nms_mod.nms(heat, 4, 3, 4)
            if not torch.equal(got, nms_mod.nms_plain(heat, 4, 3, 4)):
                raise AssertionError(f"nms {B}x{H}x{W} not exact")
            key = f"nms {B}x{H}x{W}"
            times[key] = _time_ms(lambda: nms_mod.nms(heat, 4, 3, 4), args.iters)
            print(f"{key}: {times[key]:.4f} ms", file=sys.stderr, flush=True)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                nms_mod.nms(heat, 4, 3, 4)
            times[f"{key} host enqueue"] = (time.perf_counter() - t0) / args.iters * 1e3
            torch.cuda.synchronize()
            print(f"{key} host enqueue: {times[key + ' host enqueue']:.4f} ms", file=sys.stderr,
                  flush=True)
            for core in (nms_mod.CORES if args.cores else ()):
                try:
                    g = nms_mod.geometry(4, 3, core)
                except ValueError:
                    continue
                nms_mod.launch(heat, got, 4, 3, 4, g)
                if not torch.equal(got, nms_mod.nms_plain(heat, 4, 3, 4)):
                    raise AssertionError(f"nms {B}x{H}x{W} at core {core} not exact")
                key = f"nms {B}x{H}x{W} core {core[0]}x{core[1]}"
                times[key] = _time_ms(lambda: nms_mod.launch(heat, got, 4, 3, 4, g), args.iters)
                print(f"{key}: {times[key]:.4f} ms", file=sys.stderr, flush=True)
            del heat, got

        S = 320
        for M, N in ((8, 800), (100, 100)):
            img = torch.from_numpy(rng.uniform(size=(M, S, S)).astype(np.float32)).to(dev)
            Hm = torch.from_numpy((np.eye(3) + rng.normal(0, 0.08, (N, 3, 3))).astype(np.float32))
            coefs = warp_twopass._pass_coefs(Hm, 0.0, 240.0, 0.0, float(S), S)
            for axis in (0, 1):
                c = coefs[axis].to(dev)
                got = vres_mod.vresample_coef(img, c, axis=axis)
                coords = vres_mod.coef_coords(c, S, S, axis)
                want = vres_mod.vresample_plain(img, coords, axis=axis)
                err = float((got - want).abs().max())
                if err > 1e-6:
                    raise AssertionError(f"vresample_coef axis {axis} [{N},{S},{S}]: {err}")
                for name, fn in (("vresample_coef", lambda: vres_mod.vresample_coef(img, c, axis=axis)),
                                 ("vresample", lambda: vres_mod.vresample(img, coords, axis=axis))):
                    key = f"{name} axis {axis} [{N},{S},{S}] over {M} images"
                    times[key] = _time_ms(fn, args.iters)
                    print(f"{key}: {times[key]:.4f} ms", file=sys.stderr, flush=True)
                del got, coords, want
    print(json.dumps({"kernel_ms": times, "device": _card()}))


if __name__ == "__main__":
    main()
