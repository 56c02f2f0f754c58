"""The port's evaluation tools against the JAX package's, on the CPU.

* ``ssp_torch.cli.eval_sequence``: ``track_metrics`` and
  ``reprojection_metrics`` against those of ``scripts/eval_sequence.py`` on
  seeded tracks (integers equal, floats within 1e-6); the port's
  ``warpPerspective`` against ``cv2.warpPerspective`` byte for byte (seeded
  Synthetic Shapes images, the tool's ``small_motion`` chains and stronger
  perspective warps, widths that leave OpenCV's vector loop a remainder);
  ``--synthetic`` at 240×320 with 3 frames, fp32 on both sides: the frames
  equal to the JAX tool's byte for byte, the metrics within the evaluation
  bar (1%); ``--pred`` over an ``export_sequence``-shaped tree;
* ``ssp_torch.cli.eval_semantic`` against ``scripts/eval_wsem_semantic.py``
  on a tiny tree (seeded JPEGs in ``make_coco_tree.py``'s layout, labels
  by ``make_coco_sem_labels.py``), fp32 on both sides: every metric within
  1%;
* ``ssp_torch.cli.run_export`` on a ``make_synth_hpatches.py`` tree: its
  results equal those of ``export_descriptor`` then ``evaluate`` called
  directly.

The JAX tools are loaded from ``scripts/`` here only; the port never imports
them.
"""

import importlib.util
import json
import runpy
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ssp_torch.cli import eval_semantic, eval_sequence, run_export
from ssp_torch.data.raster import warp_perspective
from ssp_torch.data.synthetic_shapes import generate_sample
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "evidence" / "wsem_weights.npz"
BAR = 0.01  # the evaluation bar: relative, or absolute for a rate


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol, path=""):
    """Integers equal, floats within ``tol`` (absolute below 1, relative
    above), nested dicts key by key."""
    if isinstance(want, dict):
        assert sorted(map(str, got)) == sorted(map(str, want)), path
        for k in want:
            _close(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, (int, np.integer)) and not isinstance(want, bool) and tol < BAR:
        assert got == want, path
    elif isinstance(want, (float, int, np.floating)):
        if np.isnan(want):
            assert np.isnan(got), path
        else:
            assert abs(got - want) <= tol * max(1.0, abs(want)), (path, got, want)
    else:
        assert got == want, path


def _tracks(seed=0, n_frames=6, n=120, d=32):
    """Seeded frames: points moved by known homographies with pixel noise,
    a few dropped and replaced each frame, descriptors perturbed."""
    rng = np.random.default_rng(seed)
    base = rng.uniform([0, 0], [319, 239], (n, 2))
    desc = rng.normal(size=(n, d))
    frames, rel_H, H = [], [], np.eye(3)
    for t in range(n_frames):
        pts = np.concatenate([base, np.ones((n, 1))], 1) @ H.T
        pts = pts[:, :2] / pts[:, 2:] + rng.normal(0, 0.8, (n, 2))
        keep = rng.uniform(size=n) > 0.15
        extra = rng.uniform([0, 0], [319, 239], (10, 2))
        p = np.concatenate([pts[keep], extra])
        dd = np.concatenate([desc[keep] + rng.normal(0, 0.25, (keep.sum(), d)),
                             rng.normal(size=(10, d))])
        dd /= np.linalg.norm(dd, axis=1, keepdims=True)
        frames.append((np.concatenate([p, rng.uniform(0, 1, (len(p), 1))], 1).astype(np.float32),
                       dd.astype(np.float32)))
        step = np.array([[1, -0.01, 2.0], [0.01, 1, -1.5], [1e-5, 0, 1]])
        rel_H.append(step)
        H = step @ H
    return frames, rel_H[:-1]


@pytest.mark.parametrize("seed", [0, 1])
def test_track_and_reprojection_metrics_equal_the_jax_tool(seed):
    jax_tool = _script("eval_sequence")
    frames, rel_H = _tracks(seed)
    for thresh in (0.7, 1.2):
        _close(eval_sequence.track_metrics(frames, nn_thresh=thresh),
               jax_tool.track_metrics(frames, nn_thresh=thresh), 1e-6)
        got = eval_sequence.reprojection_metrics(frames, rel_H, thresh)
        _close(got, jax_tool.reprojection_metrics(frames, rel_H, thresh), 1e-6)
        assert got["reproj_matches"] > 0


@pytest.mark.parametrize("hw", [(240, 320), (64, 77), (101, 133)])
def test_warp_perspective_equals_opencv_byte_for_byte(hw):
    h, w = hw
    img, _ = generate_sample("draw_multiple_polygons", size=hw, seed=hw[1])
    H_abs, rel_H = eval_sequence.motion_chain(hw, 6, seed=hw[0])
    rng = np.random.default_rng(hw[1])
    strong = []
    for _ in range(3):
        th, s = np.radians(rng.uniform(-20, 20)), rng.uniform(0.8, 1.2)
        T = np.array([[1, 0, -(w - 1) / 2], [0, 1, -(h - 1) / 2], [0, 0, 1.0]])
        M = np.array([[s * np.cos(th), -s * np.sin(th), rng.uniform(-30, 30)],
                      [s * np.sin(th), s * np.cos(th), rng.uniform(-30, 30)],
                      [*rng.normal(0, 3e-4, 2), 1.0]])
        strong.append(np.linalg.inv(T) @ M @ T)
    for H in H_abs + rel_H + strong:
        for dsize in ((w, h), (w + 3, h - 5)):
            want = cv2.warpPerspective(img, H, dsize, flags=cv2.INTER_LINEAR)
            got = warp_perspective(img, H, dsize)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError):
        warp_perspective(img, np.zeros((3, 3)), (w, h))


def test_synthetic_mode_equals_the_jax_tool(monkeypatch):
    """3 frames at 240×320 on the trained weights, fp32 flax against the
    port's fp32 module: the JAX tool's frames (caught at its
    ``cv2.warpPerspective``) equal the port's byte for byte, every metric
    within 1%."""
    jax_tool = _script("eval_sequence")
    caught = []
    real = cv2.warpPerspective

    def catch(*args, **kwargs):
        caught.append(real(*args, **kwargs))
        return caught[-1]

    monkeypatch.setattr(cv2, "warpPerspective", catch)
    j_frames, j_rel = jax_tool.make_synthetic_frames(str(WEIGHTS), 133, n_frames=3)
    images, rel_H = eval_sequence.synthetic_images((240, 320), 3)
    assert len(caught) == 3
    for a, b in zip(images, caught):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    for a, b in zip(rel_H, j_rel):
        np.testing.assert_array_equal(a, b)

    frames, _ = eval_sequence.make_synthetic_frames(WEIGHTS, 133, n_frames=3, device="cpu")
    assert all(len(p) >= 8 for p, _ in frames)
    want = jax_tool.track_metrics(j_frames)
    want.update(jax_tool.reprojection_metrics(j_frames, j_rel))
    got = eval_sequence.track_metrics(frames)
    got.update(eval_sequence.reprojection_metrics(frames, rel_H))
    _close(got, want, BAR)


def test_pred_mode_over_an_export_tree(tmp_path, capsys):
    """``--pred``: one sequence per leaf directory, and ``--rel-h-root``'s
    motion files add the reprojection metrics, as the JAX tool does."""
    jax_tool = _script("eval_sequence")
    frames, rel_H = _tracks(2, n_frames=4)
    for drive in ("d0", "d1"):
        out = tmp_path / "pred" / drive
        out.mkdir(parents=True)
        for i, (p, d) in enumerate(frames):
            np.savez(out / f"{i:06d}.npz", pts=p, desc=d)
    (tmp_path / "gt" / "d1").mkdir(parents=True)
    (tmp_path / "gt" / "d1" / "rel_H.json").write_text(json.dumps([h.tolist() for h in rel_H]))
    got = eval_sequence.main(["--pred", str(tmp_path / "pred"), "--rel-h-root",
                              str(tmp_path / "gt"), "--out", str(tmp_path / "m.json")])
    assert json.loads((tmp_path / "m.json").read_text())["n_frames"] == 8
    assert got["n_sequences"] == 2 and "reproj_inlier3_mean" in got
    assert "reproj_pairs" in got["per_sequence"]["d1"]
    assert "reproj_pairs" not in got["per_sequence"]["d0"]
    want = jax_tool.track_metrics(frames)
    _close(got["per_sequence"]["d0"], want, 1e-6)
    capsys.readouterr()


def test_eval_semantic_equals_the_jax_tool(tmp_path, monkeypatch):
    """4 val images (one batch) at 120×160 through both tools at fp32 (each tool's
    default forward is bf16: flax's default dtype, the port's folded
    forward)."""
    import jax.numpy as jnp
    import ssp.models

    root = tmp_path / "coco"
    (root / "train2017").mkdir(parents=True)
    (root / "val2017").mkdir()
    for i in range(4):
        img, _ = generate_sample("draw_multiple_polygons", size=(240, 320), seed=100 + i)
        cv2.imwrite(str(root / "val2017" / f"{i:012d}.jpg"),
                    np.clip(img * 255.0, 0, 255).astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 96])
    monkeypatch.setattr(sys, "argv", ["make_coco_sem_labels.py", "--root", str(root)])
    runpy.run_path(str(ROOT / "scripts" / "make_coco_sem_labels.py"), run_name="__main__")

    build = ssp.models.build_model
    monkeypatch.setattr(ssp.models, "build_model",
                        lambda name, **kw: build(name, dtype=jnp.float32, **kw))
    args = ["--root", str(root), "--sem-labels", str(root / "annotations"), "--batch", "4",
            "--resize", "120", "160"]
    monkeypatch.setattr(sys, "argv", ["eval_wsem_semantic.py", str(WEIGHTS), *args, "--out",
                                      str(tmp_path / "jax.json")])
    _script("eval_wsem_semantic").main()
    want = json.loads((tmp_path / "jax.json").read_text())
    # the port's fp32 module in place of its folded bf16 forward, as flax at fp32 above
    from ssp_torch.models import fast_infer

    best = fast_infer.best_apply_fn
    monkeypatch.setattr(fast_infer, "best_apply_fn",
                        lambda model, **kw: best(model, **dict(kw, enable=False)))
    got = eval_semantic.main([str(WEIGHTS), *args, "--device", "cpu",
                              "--cm", str(tmp_path / "cm.npy")])
    assert got["images"] == want["images"] == 4
    cm = np.load(tmp_path / "cm.npy")
    assert cm.shape == (133, 133) and cm.sum() > 0
    for k in ("pixel_accuracy", "mean_class_accuracy", "mean_iou", "accuracy_within_1_bins",
              "accuracy_within_4_bins"):
        assert abs(got[k] - want[k]) <= BAR, (k, got[k], want[k])


def test_run_export_equals_export_then_evaluate(tmp_path, monkeypatch):
    tree = tmp_path / "hp"
    monkeypatch.setattr(sys, "argv", ["make_synth_hpatches.py", str(tree), "--n-seq", "2",
                                      "--pairs", "1", "--size", "240", "320"])
    runpy.run_path(str(ROOT / "scripts" / "make_synth_hpatches.py"), run_name="__main__")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "logs"))
    from ssp_torch.utils.config import load_config

    config = load_config(ROOT / run_export.DEFAULT_CONFIG)
    config["data"]["root"] = str(tree)
    config["pretrained"] = str(WEIGHTS)
    config["model"]["params"] = {"n_classes": 133}
    got = run_export.run_export(config, "tool", device="cpu")

    from ssp_torch.cli.evaluate import evaluate
    from ssp_torch.cli.export import export_descriptor

    assert export_descriptor(config, "direct", device="cpu") == 2
    want = evaluate(tmp_path / "logs" / "direct" / "predictions", do_rep=True, do_homo=True)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for name in ("result.txt",):
        assert (tmp_path / "logs" / "tool" / "predictions" / name).read_text() == \
            (tmp_path / "logs" / "direct" / "predictions" / name).read_text()
    shutil.rmtree(tree)
