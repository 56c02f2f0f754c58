"""The corpus tools of the port (``ssp_torch/cli/make_*.py``) and the three
pieces of OpenCV and libjpeg they rest on, against ``cv2`` and the JAX
package's scripts (``scripts/make_*.py``).

Bar: exact everywhere.

* :func:`ssp_torch.data.imageio.write_jpeg` against ``cv2.imencode`` at
  qualities 50-100, 1×1 to 384×1248, on noise, flat and synthetic-shapes
  images: the same bytes, and the port's decode of its file equals
  ``cv2.imread`` of OpenCV's.
* The uint8 :func:`ssp_torch.data.raster.warp_perspective` against
  ``cv2.warpPerspective(..., INTER_LINEAR)`` on the homographies of
  ``scripts/make_synth_hpatches.py`` (mild and ``--strong``), a
  near-singular and an off-canvas one; :func:`ssp_torch.data.raster.
  gaussian_blur_sigma` against ``cv2.GaussianBlur(img, (0, 0), sigma)``.
* Each tool against its script on the same seeds at small sizes, compared by
  :func:`ssp_torch.data.corpus.tree_digests` (JPEG, PPM and text files by
  their bytes, PNG by its pixels, npz by its arrays).
* ``tests/data/torch_corpus/manifest.json``: the digests of the trees the
  JAX scripts write at the sizes of ``chip_smoke.py``'s phase 24 (the
  COCO tree and its labels at MANIFEST_SPLITS per primitive; the other
  tools at their defaults); the port's tools give the same.  Regenerate it
  with ``PYTHONPATH=. python tests/test_torch_corpus.py``.
"""

import functools
import importlib.util
import json
import os
import runpy
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

from ssp_torch.cli import (make_coco_sem_labels, make_coco_tree, make_gt_labels,
                           make_kitti_tree, make_synth_hpatches)
from ssp_torch.data import imageio, raster
from ssp_torch.data.corpus import tree_digests
from ssp_torch.data.synthetic_shapes import generate_sample
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

cv2 = pytest.importorskip("cv2")

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = ROOT / "tests" / "data" / "torch_corpus" / "manifest.json"
# the COCO tree's cut for the manifest and phase 24: 28 train, 15 val images
MANIFEST_SPLITS = {"training": 4, "validation": 2, "test": 2}
SMALL_SPLITS = {"training": 3, "validation": 2, "test": 2}
QUALITIES = (50, 75, 90, 95, 96, 100)
SIZES = ((1, 1), (7, 9), (17, 23), (240, 320), (384, 1248))


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(name: str, *argv: str) -> None:
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        runpy.run_path(str(ROOT / "scripts" / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = saved


@functools.lru_cache(maxsize=None)
def _image(kind: str, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(h * 10_000 + w)
    if kind == "noise":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "flat":
        return np.full((h, w), int(rng.integers(0, 256)), np.uint8)
    img, _ = generate_sample("draw_cube", size=(max(h, 16), max(w, 16)), seed=h + w,
                             blur_size=21)
    return np.ascontiguousarray(make_coco_tree.to_u8(img)[:h, :w])


# -- the JPEG encoder ----------------------------------------------------------

@pytest.mark.parametrize("kind", ("noise", "flat", "shapes"))
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
def test_write_jpeg_equals_cv2_imwrite(tmp_path, quality, hw, kind):
    img = _image(kind, *hw)
    path = imageio.write_jpeg(tmp_path / "a.jpg", img, quality)
    ok, want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok and path.read_bytes() == want.tobytes()
    np.testing.assert_array_equal(imageio.decode_gray(path),
                                  cv2.imdecode(want, cv2.IMREAD_GRAYSCALE))


def test_write_jpeg_default_quality_is_opencvs(tmp_path):
    img = _image("shapes", 240, 320)
    want = cv2.imencode(".jpg", img)[1].tobytes()
    assert imageio.write_jpeg(tmp_path / "a.jpg", img).read_bytes() == want


@pytest.mark.parametrize("bad", [
    np.zeros((8, 8), np.float32), np.zeros((8, 8, 3), np.uint8), np.zeros((0, 8), np.uint8),
    np.zeros((8,), np.uint8), np.zeros((1, 65536), np.uint8)],
    ids=("float32", "bgr", "empty", "1d", "wide"))
def test_write_jpeg_refuses_other_forms(tmp_path, bad):
    with pytest.raises(ValueError, match=r"uint8 \[H, W\]|65535"):
        imageio.write_jpeg(tmp_path / "a.jpg", bad)
    assert not (tmp_path / "a.jpg").exists()


# -- warpPerspective on uint8, GaussianBlur with a sigma ------------------------

def _homographies():
    """(name, H, h, w): make_synth_hpatches' own warps, mild and strong, at the
    tools' shapes and odd ones; a near-singular and an off-canvas one."""
    script = _script("make_synth_hpatches")
    rng = np.random.default_rng(21)
    cases = []
    for h, w in ((240, 320), (384, 1248), (17, 23), (61, 97)):
        for strong in (False, True):
            for i in range(2):
                H = script.center_conjugate(script.mild_homography(rng, strong), h, w)
                cases.append((f"{'strong' if strong else 'mild'}{i}-{h}x{w}", H, h, w))
    cases.append(("near-singular", np.array([[1e-3, 0.2, 3.0], [0.1, 1e-3, 2.0],
                                             [1e-4, 2e-4, 1.0]]), 240, 320))
    cases.append(("off-canvas", np.array([[1.0, 0.0, 5000.0], [0.0, 1.0, -4000.0],
                                          [0.0, 0.0, 1.0]]), 240, 320))
    cases.append(("perspective", np.array([[0.9, 0.1, 10.0], [-0.05, 1.1, -5.0],
                                           [1e-3, -5e-4, 1.0]]), 96, 320))
    return cases


@pytest.mark.parametrize("name,H,h,w", _homographies(), ids=lambda v: v if
                         isinstance(v, str) else "")
@pytest.mark.parametrize("kind", ("noise", "shapes"))
def test_warp_perspective_u8_equals_cv2(name, H, h, w, kind):
    img = _image(kind, h, w)
    got = raster.warp_perspective(img, H, (w, h))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.warpPerspective(img, H, (w, h),
                                                           flags=cv2.INTER_LINEAR))


def test_warp_perspective_u8_refuses_a_singular_h():
    with pytest.raises(ValueError, match="singular"):
        raster.warp_perspective(_image("noise", 7, 9), np.zeros((3, 3)), (9, 7))


def test_port_homographies_equal_the_scripts():
    script = _script("make_synth_hpatches")
    for strong in (False, True):
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(20):
            np.testing.assert_array_equal(
                make_synth_hpatches.center_conjugate(
                    make_synth_hpatches.mild_homography(a, strong), 240, 320),
                script.center_conjugate(script.mild_homography(b, strong), 240, 320))


@pytest.mark.parametrize("sigma", (0.5, 1.0, 2.0, 4.0, 8.0))
@pytest.mark.parametrize("kind,hw", [("noise", (240, 320)), ("shapes", (240, 320)),
                                     ("noise", (7, 9)), ("shapes", (17, 23))],
                         ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_gaussian_blur_sigma_equals_cv2(sigma, kind, hw):
    img = _image(kind, *hw)
    np.testing.assert_array_equal(raster.gaussian_blur_sigma(img, sigma),
                                  cv2.GaussianBlur(img, (0, 0), sigma))


# -- the tools against the scripts ---------------------------------------------

@pytest.mark.parametrize("strong", (False, True), ids=("mild", "strong"))
def test_make_synth_hpatches_equals_the_script(tmp_path, capsys, strong):
    flags = ["--n-seq", "4"] + (["--strong"] if strong else [])
    _run_script("make_synth_hpatches", str(tmp_path / "jax"), *flags)
    want = capsys.readouterr().out
    assert make_synth_hpatches.main([str(tmp_path / "port"), *flags]) == 4
    assert capsys.readouterr().out == want.replace("jax", "port")
    digests = tree_digests(tmp_path / "jax")
    assert len(digests) == 4 * 5
    assert tree_digests(tmp_path / "port") == digests


@pytest.mark.parametrize("motion", (False, True), ids=("static", "motion"))
def test_make_kitti_tree_equals_the_script(tmp_path, capsys, motion):
    flags = ["--drives", "1", "--frames", "3", "--size", "96", "320"] + \
        (["--motion"] if motion else [])
    _run_script("make_kitti_tree", "--root", str(tmp_path / "jax"), *flags)
    want = capsys.readouterr().out
    make_kitti_tree.main(["--root", str(tmp_path / "port"), *flags])
    assert capsys.readouterr().out == want.replace("jax", "port")
    digests = tree_digests(tmp_path / "jax")
    assert len(digests) == 3 + 1 + 2 + (2 if motion else 0)
    assert tree_digests(tmp_path / "port") == digests


def jax_coco_tree(root: Path, gt_out: Path, split_sizes: dict) -> None:
    """The loops of ``scripts/make_coco_tree.py`` and ``make_gt_labels.py``
    (their split sizes are fixed in the scripts) over the JAX package's
    dataset, then ``scripts/make_coco_sem_labels.py`` over the tree."""
    from ssp.data.synthetic_dataset import SyntheticShapesDataset

    cfg = dict(primitives="all",
               truncate={"draw_ellipses": 0.3, "draw_stripes": 0.5, "gaussian_noise": 0.1},
               suffix="jointd240", generation={"split_sizes": dict(split_sizes)},
               preprocessing={"blur_size": 21, "resize": [240, 320]})
    for split, out_dir in (("train", "train2017"), ("val", "val2017")):
        ds = SyntheticShapesDataset(task=split, **cfg)
        (root / out_dir).mkdir(parents=True, exist_ok=True)
        (gt_out / out_dir).mkdir(parents=True, exist_ok=True)
        for i in range(len(ds)):
            s = ds[i]
            img = np.clip(s["image"] * 255.0, 0, 255).astype(np.uint8)
            cv2.imwrite(str(root / out_dir / f"{i:012d}.jpg"), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 96])
            pts = np.asarray(s["points"], np.float32)[np.asarray(s["points_valid"], bool)]
            np.savez_compressed(gt_out / out_dir / f"{i:012d}.npz", pts=np.concatenate(
                [pts, np.ones((len(pts), 1), np.float32)], axis=1))
    _run_script("make_coco_sem_labels", "--root", str(root))


def test_make_coco_tree_labels_and_sem_labels_equal_the_scripts(tmp_path, monkeypatch,
                                                                 capsys):
    """Split sizes of 3 and 2 per primitive (22 train, 15 val images): the
    JPEG tree, the oracle labels, the semantic PNGs and the cache shards of
    each side, each side generating its own cache (the port's in worker
    processes, as at the scripts' sizes)."""
    monkeypatch.setattr(make_coco_tree, "PARALLEL_MIN", 0)
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path / "jax_data"))
    jax_coco_tree(tmp_path / "jax", tmp_path / "jax_gt", SMALL_SPLITS)
    capsys.readouterr()
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path / "port_data"))
    root, gt = tmp_path / "port", tmp_path / "port_gt"
    assert make_coco_tree.make_coco_tree(root, split_sizes=SMALL_SPLITS) == \
        {"train": 22, "val": 15}
    assert make_gt_labels.make_gt_labels(gt, split_sizes=SMALL_SPLITS) == \
        {"train": 22, "val": 15}
    assert make_coco_sem_labels.main(["--root", str(root)]) == \
        {"train2017": 22, "val2017": 15}
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"train 22 -> {root / 'train2017'}"
    assert out[-1] == f"val2017 15 -> {root / 'annotations' / 'semantic_val2017'}"
    for a, b, n in (("jax", "port", 2 * 37), ("jax_gt", "port_gt", 37),
                    ("jax_data", "port_data", 18)):
        digests = tree_digests(tmp_path / a)
        assert len(digests) == n
        assert tree_digests(tmp_path / b) == digests, (a, b)


def test_coarse_sem_labels_equal_the_script(tmp_path, capsys):
    root = tmp_path / "coco"
    for split in ("train2017", "val2017"):
        (root / split).mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(root / split / f"{i:012d}.jpg"), _image("shapes", 240, 320 - i),
                        [cv2.IMWRITE_JPEG_QUALITY, 96])
    _run_script("make_coco_sem_labels", "--root", str(root), "--coarse", "6", "--sigma", "2",
                "--out-name", "jax")
    make_coco_sem_labels.main(["--root", str(root), "--coarse", "6", "--sigma", "2",
                               "--out-name", "port"])
    digests = tree_digests(root / "jax")
    assert len(digests) == 4
    assert tree_digests(root / "port") == digests


# -- the manifest ----------------------------------------------------------------

TREES = ("COCO240", "gt_labels", "HPatches", "KITTI_synth", "KITTI_motion")
# the manifest's trees by the tool run that writes them (phase 24's sizes)
PORT_RUNS = {
    "coco": (("COCO240", "gt_labels"), lambda w: (
        make_coco_tree.make_coco_tree(w / "COCO240", split_sizes=MANIFEST_SPLITS),
        make_gt_labels.make_gt_labels(w / "gt_labels", split_sizes=MANIFEST_SPLITS),
        make_coco_sem_labels.main(["--root", str(w / "COCO240")]))),
    "hpatches": (("HPatches",), lambda w: make_synth_hpatches.main([str(w / "HPatches")])),
    "kitti": (("KITTI_synth",), lambda w: make_kitti_tree.main(["--root",
                                                                 str(w / "KITTI_synth")])),
    "kitti_motion": (("KITTI_motion",), lambda w: make_kitti_tree.main(
        ["--root", str(w / "KITTI_motion"), "--motion"])),
}


def make_manifest(path: Path = MANIFEST) -> dict:
    """Write the manifest from the JAX package's scripts (OpenCV writes)."""
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        saved = os.environ.get("SSP_DATA_PATH")
        os.environ["SSP_DATA_PATH"] = str(work / "data")
        try:
            jax_coco_tree(work / "COCO240", work / "gt_labels", MANIFEST_SPLITS)
        finally:
            if saved is None:
                os.environ.pop("SSP_DATA_PATH")
            else:
                os.environ["SSP_DATA_PATH"] = saved
        _run_script("make_synth_hpatches", str(work / "HPatches"))
        _run_script("make_kitti_tree", "--root", str(work / "KITTI_synth"))
        _run_script("make_kitti_tree", "--root", str(work / "KITTI_motion"), "--motion")
        manifest = {
            "coco_split_sizes": MANIFEST_SPLITS,
            "digests": "sha256: PNG of its decoded pixels (shape repr, then bytes), npz of "
                       "each array (key, dtype, shape, bytes), any other file of its bytes",
            "trees": {name: tree_digests(work / name) for name in TREES}}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


def test_manifest_counts():
    manifest = json.loads(MANIFEST.read_text())
    assert manifest["coco_split_sizes"] == MANIFEST_SPLITS
    # 28 + 15 JPEGs and their PNGs; 40 sequences of 3 PPMs and 2 homographies;
    # 2 + 1 drives of 10 and 5 frames, the split lists (and rel_H.json)
    assert {name: len(tree) for name, tree in manifest["trees"].items()} == \
        {"COCO240": 86, "gt_labels": 43, "HPatches": 200, "KITTI_synth": 27, "KITTI_motion": 30}


@pytest.mark.parametrize("run", sorted(PORT_RUNS))
def test_manifest_matches_the_port(tmp_path, monkeypatch, run):
    trees, write = PORT_RUNS[run]
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path / "data"))
    write(tmp_path)
    manifest = json.loads(MANIFEST.read_text())["trees"]
    for name in trees:
        got = tree_digests(tmp_path / name)
        bad = sorted(k for k in manifest[name] if got.get(k) != manifest[name][k])
        assert sorted(got) == sorted(manifest[name]) and not bad, (name, bad[:5])


if __name__ == "__main__":
    m = make_manifest()
    print(json.dumps({name: len(tree) for name, tree in m["trees"].items()}))
