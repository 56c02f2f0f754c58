"""Port parity for the two export CLIs that read JPEG and PNG corpora:
``ssp_torch.cli.export.export_sequence`` (the SLAM front end's per-frame
keypoints and descriptors over KITTI drives) and ``export_detector_homoAdapt``
(stage-2 homography-adaptation pseudo-labels over COCO), against
``ssp.cli.export``, on the CPU at a small resize of the shipped configs.

* ``export_sequence``, fp32 in both (``fast_inference: false``; the JAX
  CLI's flax module built with ``dtype: float32``), as the stage-4 export's
  CLIs are compared (``tests/test_torch_export.py``): only fp32 summation
  order differs.  The same files (``<scene>/<frame>.npz`` with ``pts`` and
  ``desc``), the same valid points within 1e-3 px, descriptor cosine
  ≥ 0.9999.  The JAX CLI's default forward is its module at bfloat16, not the
  port's folded bf16 forward; the defaults are not compared.
* ``export_detector_homoAdapt`` with ``num: 3``: the same files, the same
  ``pts`` layout and the same ``export.txt`` text as the JAX CLI.  The two
  draw their homographies from different generators, so the points are not
  compared across packages here: ``tests/test_torch_ha.py`` holds them with
  injected homographies.  The port CLI's points equal those of a direct
  ``run_ha_export(make_ha_fn(...), dataset.images(), seed, group=1)``.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from ssp_torch.cli import export as cli
from ssp_torch.data.coco import CocoDataset
from ssp_torch.export.homography_adaptation import make_ha_fn, run_ha_export
from ssp_torch.models.fast_infer import best_apply_fn
from ssp_torch.models.weights import load_weights

cv2 = pytest.importorskip("cv2")
jnp = pytest.importorskip("jax.numpy")

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "evidence" / "wsem_weights.npz"
SEQ_HW = (80, 256)  # KITTI's 375×1242 frame cut to 75×250, enlarged as 375×1242 → 384×1248
HA_HW = (48, 64)


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 30, np.float64) + rng.normal(0, 4, (h, w, 3))
    for _ in range(12):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y0:y0 + rng.integers(6, h // 2), x0:x0 + rng.integers(6, w // 3)] = \
            rng.uniform(60, 250, 3)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _kitti_tree(root: Path):
    for s, drive in enumerate(("2011_09_26_drive_0001_sync", "2011_09_26_drive_0002_sync")):
        d = root / drive / "image_02" / "data"
        d.mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(d / f"{i:010d}.png"), _frame(75, 250, 10 * s + i))
    (root / "train.txt").write_text("2011_09_26_drive_0001_sync\n2011_09_26_drive_0002_sync\n")


def _sequence_config(root: Path, **params):
    """``configs/kitti384_sequence_r5.yaml`` at a small resize, fp32, with a
    lower detection threshold (the trained detector scores few points over
    0.015 on these small frames)."""
    return {"data": {"dataset": "Kitti_inh", "export_folder": "train", "root": str(root),
                     "root_split_txt": str(root), "preprocessing": {"resize": list(SEQ_HW)},
                     "augmentation": {"photometric": {"enable": False}}},
            "front_end_model": "Val_model_heatmap",
            "model": {"name": "SuperPointNet_gauss2_ssmall",
                      "params": {"n_classes": 133, **params}, "batch_size": 1,
                      "detection_threshold": 0.001, "nms": 4, "top_k": 1000,
                      "fast_inference": False},
            "pretrained": str(NPZ)}


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.npz"))


def test_export_sequence_fp32_matches_jax(tmp_path, monkeypatch):
    from ssp.cli.export import export_sequence as j_export_sequence

    _kitti_tree(tmp_path / "kitti")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "jax"))
    j_export_sequence(_sequence_config(tmp_path / "kitti", dtype=jnp.float32), "seq")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "port"))
    config = _sequence_config(tmp_path / "kitti")
    assert cli.export_sequence(config, "seq", device="cpu") == 4
    assert cli.export_sequence(config, "seq", device="cpu") == 0  # resumes: all exist

    got_root = tmp_path / "port" / "seq" / "predictions" / "train"
    want_root = tmp_path / "jax" / "seq" / "predictions" / "train"
    files = _files(got_root)
    assert files == _files(want_root) and len(files) == 4
    assert files[0] == "2011_09_26_drive_0001_sync/0000000000.npz"
    for f in files:
        with np.load(got_root / f) as a, np.load(want_root / f) as b:
            a, b = dict(a), dict(b)
        assert set(a) == set(b) == {"pts", "desc"}
        assert a["pts"].dtype == b["pts"].dtype and a["desc"].dtype == b["desc"].dtype
        assert a["pts"].shape[1] == 3 and a["desc"].shape[1] == 256
        assert len(b["pts"]) >= 20, f
        # the same set of points (top-k holds every point over the threshold)
        ka, kb = np.lexsort(a["pts"][:, :2].T), np.lexsort(b["pts"][:, :2].T)
        assert len(ka) == len(kb), f
        np.testing.assert_allclose(a["pts"][ka, :2], b["pts"][kb, :2], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a["pts"][ka, 2], b["pts"][kb, 2], rtol=1e-3, atol=1e-6)
        cos = (a["desc"][ka] * b["desc"][kb]).sum(-1)
        print(f"{f}: {len(ka)} points, descriptor cosine >= {cos.min():.6f}")
        assert cos.min() >= 0.9999


def _coco_tree(root: Path):
    d = root / "COCO" / "train2017"
    d.mkdir(parents=True)
    stems = [f"{i:012d}" for i in (139, 285, 632)]
    for i, stem in enumerate(stems):
        cv2.imwrite(str(d / f"{stem}.jpg"), _frame(96, 128, 20 + i),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
    return stems


def _gauss2_npz(tmp_path: Path) -> Path:
    """The trained weights without the semantic head's, which the JAX
    package's strict npz loader refuses for ``SuperPointNet_gauss2``."""
    out = tmp_path / "gauss2_weights.npz"
    with np.load(NPZ) as data:
        np.savez(out, **{k: data[k] for k in data.files
                         if k.split("/")[1] not in ("convDS", "convSout")})
    return out


def _ha_config(pretrained=NPZ, **extra):
    """``configs/magicpoint_coco_export.yaml`` with 3 warps at 48×64 and the
    trained weights."""
    return {"data": {"dataset": "Coco", "export_folder": "train",
                     "preprocessing": {"resize": list(HA_HW)},
                     "augmentation": {"photometric": {"enable": False}},
                     "homography_adaptation": {
                         "enable": True, "num": 3, "aggregation": "sum", "filter_counts": 0,
                         "homographies": {"params": {
                             "translation": True, "rotation": True, "scaling": True,
                             "perspective": True, "scaling_amplitude": 0.2,
                             "perspective_amplitude_x": 0.2, "perspective_amplitude_y": 0.2,
                             "allow_artifacts": True, "patch_ratio": 0.85}},
                         **extra}},
            "model": {"name": "SuperPointNet_gauss2", "params": {}, "batch_size": 1,
                      "eval_batch_size": 1, "detection_threshold": 0.015, "nms": 4,
                      "top_k": 600, "subpixel": {"enable": True, "patch_size": 5}},
            "pretrained": str(pretrained)}


def test_export_detector_homoadapt_layout_matches_jax(tmp_path, monkeypatch):
    from ssp.cli.export import export_detector_homoAdapt as j_export

    stems = _coco_tree(tmp_path)
    config = _ha_config(_gauss2_npz(tmp_path))
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path))
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "jax"))
    j_export(config, "ha")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "port"))
    assert cli.export_detector_homoAdapt(config, "ha", device="cpu") == 3

    got_root, want_root = (tmp_path / side / "ha" for side in ("port", "jax"))
    files = _files(got_root / "predictions")
    assert files == _files(want_root / "predictions") == [f"train2017/{s}.npz" for s in stems]
    for f in files:
        with np.load(got_root / "predictions" / f) as a, \
                np.load(want_root / "predictions" / f) as b:
            assert a.files == b.files == ["pts"]
            assert a["pts"].dtype == b["pts"].dtype and a["pts"].shape[1] == b["pts"].shape[1] == 3
            assert len(a["pts"]) > 0 and np.isfinite(a["pts"]).all()
    audit = (got_root / "export.txt").read_text()
    assert audit == (want_root / "export.txt").read_text()
    assert audit == f"load model: {config['pretrained']}\nhomography adaptation: 3\n"

    # a second run writes nothing and appends its audit lines again
    assert cli.export_detector_homoAdapt(config, "ha", device="cpu") == 0
    assert (got_root / "export.txt").read_text() == audit * 2


def test_export_detector_homoadapt_is_run_ha_export(tmp_path, monkeypatch):
    """The CLI's points are those of the compute path it wraps, called
    directly with the config's values, seed 0 and group 1."""
    _coco_tree(tmp_path)
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path))
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "logs"))
    config = _ha_config()
    assert cli.export_detector_homoAdapt(config, "ha", device="cpu") == 3

    model = load_weights(str(NPZ), "SuperPointNet_gauss2", {}, device="cpu")
    ha = config["data"]["homography_adaptation"]
    ha_fn = make_ha_fn(best_apply_fn(model, input_hw=HA_HW, device="cpu"), device="cpu",
                       num_h=3, homography_params=ha["homographies"]["params"],
                       top_k=600, conf_thresh=0.015, nms_radius=4, subpixel=True)
    dataset = CocoDataset(task="train", preprocessing={"resize": list(HA_HW)})
    assert run_ha_export(ha_fn, dataset.images(), tmp_path / "direct", seed=0, group=1) == 3
    for f in _files(tmp_path / "direct"):
        with np.load(tmp_path / "direct" / f) as a, \
                np.load(tmp_path / "logs" / "ha" / "predictions" / "train2017" / f) as b:
            np.testing.assert_array_equal(a["pts"], b["pts"])


def test_export_detector_homoadapt_one_dispatch_writes_the_same_files(tmp_path, monkeypatch):
    """``homography_adaptation.one_dispatch: true`` (the chain as one program;
    eagerly on the CPU) writes the files the staged export writes, the same
    points bit for bit: with one image per call its one chunk holds all of
    the image's warps, as the staged export's does."""
    _coco_tree(tmp_path)
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path))
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "logs"))
    assert cli.export_detector_homoAdapt(_ha_config(), "staged", device="cpu") == 3
    assert cli.export_detector_homoAdapt(_ha_config(one_dispatch=True), "one", device="cpu") == 3
    staged = tmp_path / "logs" / "staged" / "predictions"
    one = tmp_path / "logs" / "one" / "predictions"
    assert _files(one) == _files(staged) and len(_files(one)) == 3
    for f in _files(one):
        with np.load(one / f) as a, np.load(staged / f) as b:
            np.testing.assert_array_equal(a["pts"], b["pts"])


def test_cli_main_runs_both_subcommands(tmp_path, monkeypatch):
    """``python -m ssp_torch.cli.export <command> <config> <exper> --device
    cpu`` through ``main``, for both new subcommands."""
    import yaml

    _kitti_tree(tmp_path / "kitti")
    _coco_tree(tmp_path)
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path))
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "logs"))
    for command, config, n in (("export_sequence", _sequence_config(tmp_path / "kitti"), 4),
                               ("export_detector_homoAdapt", _ha_config(), 3)):
        path = tmp_path / f"{command}.yaml"
        path.write_text(yaml.safe_dump(config))
        cli.main([command, str(path), command, "--device", "cpu"])
        assert len(_files(tmp_path / "logs" / command / "predictions")) == n
    assert os.path.exists(tmp_path / "logs" / "export_detector_homoAdapt" / "export.txt")
