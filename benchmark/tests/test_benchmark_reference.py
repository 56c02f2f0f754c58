"""The yardstick's arithmetic against hand counts, and the plain reference
against the port's plain CPU path at a small size."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import BENCH_DIR
from reference import points as ref_points
from reference import superpoint as ref_net
from yardstick import frames, work

CFG = json.loads((BENCH_DIR / "configs" / "superpoint-gauss2.json").read_text())
WEIGHTS = BENCH_DIR / CFG["weights"]["inference"]


def test_forward_flops_by_hand():
    # 2·MACs of every conv at 240×320 (pixels 76,800): conv1a, conv1b at full
    # size, down1 at 1/4, down2 at 1/16, down3 and the heads at 1/64
    px = 240 * 320
    by_hand = 2 * (9 * 1 * 64 * px + 9 * 64 * 64 * px + 2 * 9 * 64 * 64 * px // 4
                   + (9 * 64 * 128 + 9 * 128 * 128) * px // 16 + 2 * 9 * 128 * 128 * px // 64
                   + (9 * 128 * 256 + 256 * 65 + 9 * 128 * 256 + 256 * 256) * px // 64)
    assert work.forward_flops(CFG["widths"], 240, 320) == by_hand == 13_025_894_400
    assert work.forward_flops(CFG["widths"], 480, 640) == 4 * by_hand
    semantic = 2 * (9 * 128 * 256 + 256 * 133) * px // 64
    assert work.forward_flops(CFG["widths"], 240, 320, 133) == by_hand + semantic


def test_kernel_bounds_by_hand():
    # stem at 16×480×640: 2·px·64·9·65 operations at 989 TFLOP/s
    px = 16 * 480 * 640
    assert work.stem_least_s(16, 480, 640, 64) == pytest.approx(2 * px * 64 * 9 * 65 / 989e12)
    # down1: two 64→64 convs at 240×320 per image
    assert work.down1_least_s(16, 480, 640, 64) == pytest.approx(
        2 * (px // 4) * 64 * 9 * 64 * 2 / 989e12)
    # NMS: bytes bound, the map read once and written once at 3.35 TB/s
    assert work.nms_least_s(16, 480, 640, 4) == pytest.approx(2 * px * 4 / 3.35e12)


def test_reference_forward_and_points_equal_the_ports_plain_path():
    from ssp_torch.export.descriptors_export import make_detect_describe_fn
    from ssp_torch.models.weights import load_flax_npz

    model = load_flax_npz(WEIGHTS, CFG["registry_name"], device="cpu").eval()
    w = ref_net.load_npz(WEIGHTS, "cpu")
    x = frames.structured_frames(2, 96, 128, torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = model(x[..., None])
    want = ref_net.forward(w, x)
    assert torch.allclose(got["semi"].permute(0, 3, 1, 2), want["semi"], atol=1e-4, rtol=1e-4)
    assert torch.allclose(got["desc"].permute(0, 3, 1, 2), want["desc"], atol=1e-5)
    dd = make_detect_describe_fn(lambda im: model(im), device="cpu", top_k=100)
    pts, valid, desc = dd(x)
    rp, rv, rd = ref_points.detect_describe(ref_net.heatmap(want["semi"]), want["desc"],
                                            top_k_=100, conf_thresh=0.015, nms_radius=4)
    assert valid.sum() > 20 and torch.equal(valid, rv)
    assert torch.allclose(pts, rp, atol=1e-4) and torch.allclose(desc, rd, atol=1e-4)


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("ssp_torch", "ssp", "jax", "jaxlib", "flax"), \
                    (path.name, name)
