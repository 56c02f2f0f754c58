"""Stage 1's data without OpenCV: the port's rasteriser
(``ssp_torch.data.raster``, C++ in ``ssp_torch/csrc/raster_host.cpp``), its
synthetic-shapes generator and its ``SyntheticDataset_gaussian`` against
``cv2`` and the JAX package.

Bar: exact everywhere.

* Each ``raster`` routine against its ``cv2`` call on a seeded sweep:
  ``line`` at thickness 1-12 with end points on and off the canvas,
  ``fillConvexPoly`` (convex, non-convex and degenerate quads and
  polygons), ``fillPoly``, the filled ``circle``, the filled ``ellipse`` at
  angles 0-90, ``blur`` with k from 3 to 213 on a 480×640 canvas,
  ``GaussianBlur`` at 3, 11 and 21, ``getAffineTransform`` and
  ``getPerspectiveTransform`` (bit for bit).
* ``generate_sample`` against the JAX package's for every primitive × 25
  seeds at 240×320 with ``blur_size`` 21 and at 120×160 with 11: the float32
  images and the points.
* ``SyntheticShapesDataset`` against the JAX one with small ``split_sizes``
  and ``truncate``; each package reads the cache files the other wrote.
* ``tests/data/torch_synth/manifest.json``: the SHA-256 of the image and
  point bytes of each primitive × 4 seeds at 240×320, ``blur_size`` 21.  The
  JAX generator (``cv2`` in the seam) and the port's give the manifest's
  hashes; ``chip_smoke.py`` checks the port against it where there is no
  OpenCV.  Regenerate it with ``PYTHONPATH=. python tests/test_torch_synth.py``.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from ssp_torch.data import raster
from ssp_torch.data import synthetic_dataset as t_dataset
from ssp_torch.data import synthetic_shapes as t_shapes
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

cv2 = pytest.importorskip("cv2")

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = ROOT / "tests" / "data" / "torch_synth" / "manifest.json"
MANIFEST_SIZE, MANIFEST_BLUR, MANIFEST_SEEDS = (240, 320), 21, (0, 1, 2, 3)
CASES = 400  # per sweep


def _canvas(rng, h=60, w=80):
    return rng.integers(0, 256, (h, w), dtype=np.uint8)


def _points(rng, n, lo=(-40, -40), hi=(120, 100)):
    return np.stack([rng.integers(lo[0], hi[0], n), rng.integers(lo[1], hi[1], n)],
                    1).astype(np.int32)


@pytest.mark.parametrize("thickness", range(1, 13))
def test_line_matches_cv2(thickness):
    rng = np.random.default_rng(thickness)
    for _ in range(CASES):
        img = _canvas(rng)
        want = img.copy()
        p1, p2 = (tuple(int(v) for v in p) for p in _points(rng, 2))
        color = int(rng.integers(0, 256))
        cv2.line(want, p1, p2, color, thickness)
        raster.line(img, p1, p2, color, thickness)
        assert np.array_equal(img, want), (p1, p2, thickness)


@pytest.mark.parametrize("kind", ["quad", "degenerate", "polygon"])
def test_fill_convex_poly_matches_cv2(kind):
    rng = np.random.default_rng(len(kind))
    for _ in range(CASES):
        img = _canvas(rng)
        want = img.copy()
        q = _points(rng, 4 if kind != "polygon" else int(rng.integers(3, 9)), (-30, -30),
                    (110, 90))
        if kind == "degenerate":  # repeated or collinear vertices, as an int cast leaves them
            q[int(rng.integers(1, 4))] = q[0] if rng.uniform() < 0.5 else (q[0] + q[2]) // 2
        color = int(rng.integers(0, 256))
        cv2.fillConvexPoly(want, q, color)
        raster.fill_convex_poly(img, q, color)
        assert np.array_equal(img, want), q.tolist()


@pytest.mark.parametrize("inside", [True, False], ids=["inside", "crossing"])
def test_fill_poly_matches_cv2(inside):
    rng = np.random.default_rng(int(inside))
    lo, hi = ((0, 0), (80, 60)) if inside else ((-30, -30), (110, 90))
    for _ in range(CASES):
        img = _canvas(rng)
        want = img.copy()
        q = _points(rng, int(rng.integers(3, 9)), lo, hi)
        color = int(rng.integers(0, 256))
        cv2.fillPoly(want, [q.reshape(-1, 1, 2)], color)
        raster.fill_poly(img, q, color)
        assert np.array_equal(img, want), q.tolist()


def test_filled_circle_matches_cv2():
    rng = np.random.default_rng(5)
    for _ in range(CASES):
        img = _canvas(rng)
        want = img.copy()
        c = (int(rng.integers(-30, 110)), int(rng.integers(-30, 90)))
        r, color = int(rng.integers(0, 45)), int(rng.integers(0, 256))
        cv2.circle(want, c, r, color, -1)
        raster.circle_filled(img, c, r, color)
        assert np.array_equal(img, want), (c, r)


def test_filled_ellipse_matches_cv2():
    rng = np.random.default_rng(6)
    for i in range(CASES):
        img = _canvas(rng, 120, 160)
        want = img.copy()
        c = (int(rng.integers(-20, 180)), int(rng.integers(-20, 140)))
        axes = (int(rng.integers(0, 80)), int(rng.integers(0, 80)))
        angle = float(rng.uniform(0, 90)) if i % 4 else float(rng.integers(0, 91)) + 0.5
        color = int(rng.integers(0, 256))
        cv2.ellipse(want, c, axes, angle, 0, 360, color, -1)
        raster.ellipse_filled(img, c, axes, angle, color)
        assert np.array_equal(img, want), (c, axes, angle)


@pytest.mark.parametrize("k", [3, 5, 13, 15, 17, 41, 81, 101, 151, 205, 213])
def test_box_blur_matches_cv2(k):
    rng = np.random.default_rng(k)
    for img in (_canvas(rng, 480, 640), _canvas(rng, 333, 517),
                (rng.uniform(size=(480, 640)) > 0.5).astype(np.uint8) * 255):
        assert np.array_equal(raster.blur(img, k), cv2.blur(img, (k, k))), k


def test_box_blur_rounds_ties_in_single_precision():
    """A sum whose mean is 152.5 in float32 (152.50001 in float64): OpenCV
    rounds it to 152, half to even."""
    k = 205
    img = np.zeros((480, 640), np.uint8)
    # 6408813 = 25132·255 + 153 over the 205×205 window at the centre
    win = np.zeros(k * k, np.uint8)
    win[:25132] = 255
    win[25132] = 153
    img[240 - k // 2:240 + k // 2 + 1, 320 - k // 2:320 + k // 2 + 1] = win.reshape(k, k)
    assert float(np.float32(6408813) * np.float32(1 / k**2)) == 152.5
    got, want = raster.blur(img, k), cv2.blur(img, (k, k))
    assert got[240, 320] == want[240, 320] == 152
    assert np.array_equal(got, want)


@pytest.mark.parametrize("b", [3, 11, 21])
def test_gaussian_blur_matches_cv2(b):
    rng = np.random.default_rng(b)
    for img in (_canvas(rng, 480, 640), _canvas(rng, 240, 320), _canvas(rng, 37, 53)):
        assert np.array_equal(raster.gaussian_blur(img, b), cv2.GaussianBlur(img, (b, b), 0)), b


def test_transforms_match_cv2_bit_for_bit():
    rng = np.random.default_rng(7)
    for _ in range(CASES):
        src = rng.uniform(0, 640, (4, 2)).astype(np.float32)
        dst = (src + rng.uniform(-80, 80, (4, 2))).astype(np.float32)
        a, want_a = raster.affine_transform(src[:3], dst[:3]), cv2.getAffineTransform(src[:3],
                                                                                     dst[:3])
        p, want_p = raster.perspective_transform(src, dst), cv2.getPerspectiveTransform(src, dst)
        assert a.dtype == want_a.dtype and np.array_equal(a, want_a)
        assert p.dtype == want_p.dtype and np.array_equal(p, want_p)


def test_canvas_must_be_uint8():
    with pytest.raises(ValueError, match="uint8"):
        raster.line(np.zeros((4, 4), np.float32), (0, 0), (3, 3), 1)
    with pytest.raises(ValueError, match="odd"):
        raster.gaussian_blur(np.zeros((8, 8), np.uint8), 4)


@pytest.mark.parametrize("size,blur", [((240, 320), 21), ((120, 160), 11)],
                         ids=["240x320-b21", "120x160-b11"])
@pytest.mark.parametrize("prim", t_shapes.PRIMITIVES)
def test_generate_sample_matches_jax(prim, size, blur):
    from ssp.data import synthetic_shapes as j_shapes

    assert t_shapes.PRIMITIVES == j_shapes.PRIMITIVES
    assert t_shapes.SUPERSAMPLE == j_shapes.SUPERSAMPLE
    for seed in range(25):
        img, pts = t_shapes.generate_sample(prim, size, seed, blur)
        want_img, want_pts = j_shapes.generate_sample(prim, size, seed, blur)
        assert img.dtype == want_img.dtype == np.float32 and img.shape == size
        assert np.array_equal(img, want_img), (prim, seed)
        assert pts.dtype == want_pts.dtype and np.array_equal(pts, want_pts), (prim, seed)


def test_generate_sample_refuses_unknown_primitive():
    with pytest.raises(KeyError, match="draw_nothing"):
        t_shapes.generate_sample("draw_nothing")


DATASET_CFG = dict(primitives=["draw_lines", "draw_cube", "gaussian_noise"],
                   truncate={"draw_cube": 0.5, "gaussian_noise": 0.25},
                   generation={"split_sizes": {"training": 4, "validation": 2}, "random_seed": 3},
                   preprocessing={"resize": [64, 96], "blur_size": 21})


@pytest.mark.parametrize("task", ["train", "val"])
def test_dataset_matches_jax_and_shares_its_cache(task, tmp_path):
    from ssp.data.synthetic_dataset import SyntheticShapesDataset as JDataset

    port = t_dataset.SyntheticShapesDataset(task=task, cache_dir=tmp_path / "port", **DATASET_CFG)
    jax_ds = JDataset(task=task, cache_dir=tmp_path / "jax", **DATASET_CFG)
    n = {"train": 4, "val": 2}[task]
    assert len(port) == len(jax_ds) == n + max(round(n * 0.5), 1) + max(round(n * 0.25), 1)
    for name in ("_images", "_points", "_valid"):
        a, b = getattr(port, name), getattr(jax_ds, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port._points.shape[1] == t_dataset.MAX_POINTS == 120
    for i in range(len(port)):
        s, w = port[i], jax_ds[i]
        assert s.keys() == w.keys()
        assert all(np.array_equal(s[k], w[k]) for k in s)
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files[0] == f"draw_cube_{port.split}_{n}_64x96_b21_s3.npz"
    # each package reads what the other wrote (and writes nothing more)
    other_port = t_dataset.SyntheticShapesDataset(task=task, cache_dir=tmp_path / "jax",
                                                  **DATASET_CFG)
    other_jax = JDataset(task=task, cache_dir=tmp_path / "port", **DATASET_CFG)
    assert np.array_equal(other_port._images, jax_ds._images)
    assert np.array_equal(other_jax._images, port._images)
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == files


def test_dataset_defaults_and_registration(tmp_path, monkeypatch):
    from ssp_torch import registry
    from ssp_torch.data import SyntheticShapesDataset

    assert registry.get("dataset", "SyntheticDataset_gaussian") is SyntheticShapesDataset
    assert registry.get("dataset", "SyntheticShapes") is SyntheticShapesDataset
    assert t_dataset.DEFAULT_SPLIT_SIZES == {"training": 10000, "validation": 200, "test": 500}
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path))
    ds = SyntheticShapesDataset(task="test", primitives=["draw_star"], suffix="x",
                                generation={"split_sizes": {"test": 1}},
                                preprocessing={"resize": [32, 48]})
    assert ds.split == "test" and ds.blur_size == 11
    assert (tmp_path / "synthetic_shapes_x" / "draw_star_test_1_32x48_b11_s0.npz").exists()
    with pytest.raises(ValueError, match="200000"):
        SyntheticShapesDataset(task="train", primitives=["draw_star"], suffix="x",
                               generation={"split_sizes": {"training": 200_001}},
                               preprocessing={"resize": [8, 8]})
    with pytest.raises(KeyError, match="draw_blobs"):
        SyntheticShapesDataset(primitives=["draw_blobs"])


def _sample_hashes(generate):
    out = []
    for prim in t_shapes.PRIMITIVES:
        for seed in MANIFEST_SEEDS:
            img, pts = generate(prim, MANIFEST_SIZE, seed, MANIFEST_BLUR)
            out.append({"primitive": prim, "seed": seed, "n_points": int(len(pts)),
                        "image_sha256": hashlib.sha256(img.tobytes()).hexdigest(),
                        "points_sha256": hashlib.sha256(pts.tobytes()).hexdigest()})
    return out


def make_manifest(path: Path = MANIFEST) -> dict:
    """Write the manifest from the JAX generator (OpenCV draws)."""
    from ssp.data.synthetic_shapes import generate_sample

    manifest = {"size": list(MANIFEST_SIZE), "blur_size": MANIFEST_BLUR,
                "image": "float32 [H, W] bytes", "points": "float32 [N, 2] bytes",
                "samples": _sample_hashes(generate_sample)}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


def test_manifest_matches_jax_generator_and_port():
    from ssp.data.synthetic_shapes import generate_sample

    manifest = json.loads(MANIFEST.read_text())
    assert tuple(manifest["size"]) == MANIFEST_SIZE and manifest["blur_size"] == MANIFEST_BLUR
    assert len(manifest["samples"]) == len(t_shapes.PRIMITIVES) * len(MANIFEST_SEEDS)
    assert _sample_hashes(generate_sample) == manifest["samples"]
    assert _sample_hashes(t_shapes.generate_sample) == manifest["samples"]


if __name__ == "__main__":
    print(json.dumps(make_manifest(), indent=1))
