"""The port's evaluation CLI and checkpoint sweep against the JAX package's
(``ssp_torch.cli.evaluate`` / ``ssp_torch.cli.export_eval`` against
``ssp.cli.evaluate`` / ``ssp.cli.export_eval``).

* **The same pair files, OpenCV's fit in the seam.**  24 seeded pair files
  with the export's keys (points under a known homography with noise,
  extra points, descriptors that mostly match, some scrambled), plus a
  file that is not a pair.  With ``cv2.findHomography`` put in place of
  ``homography_fit.find_homography``, the two evaluations meet in every
  column (rel 1e-12), in ``result.txt`` line for line and in
  ``result.npz``.
* **The port's own fit.**  Repeatability and localization error equal;
  matching score and NN mAP within 1% relative; each ``correctness_ε``
  within one pair.  The test prints how many pairs' correctness flips
  (measured: none; the fit draws OpenCV's sets, and every column is
  equal).
* **The sweep, fp32 against fp32.**  The JAX ``sweep`` over orbax
  checkpoints written from ``evidence/wsem_weights.npz`` (its model at
  ``dtype: float32``) against the port's ``sweep`` over the same weights
  as ``superPointNet_<it>.npz`` with ``fast_inference: false``, on the
  64×96 four-pair tree of ``tests/test_torch_export.py``: equal headers
  and iterations, equal repeatability, the other columns within the bars
  above; a broken checkpoint gives a zero row on both sides; a folder of
  orbax directories alone raises in the port before anything is written.
"""

import csv
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.cli import evaluate as j_eval
from ssp_torch.cli import evaluate as t_eval
from ssp_torch.cli import export_eval
from ssp_torch.evaluations import homography_fit
from ssp_torch.postprocess.tracker import PointTracker
from test_torch_export import NPZ, _config, _make_tree
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

N_PAIRS = 24
HW = (120, 160)
REL = 0.01  # matching score and NN mAP, the port's fit against OpenCV's


def _cv2_fit(src, dst):
    """``cv2.findHomography(src, dst, cv2.RANSAC)`` in the port's form."""
    H, mask = cv2.findHomography(src, dst, cv2.RANSAC)
    return H, None if mask is None else mask.ravel().astype(bool)


def _unit(x):
    return (x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)).astype(np.float32)


def _write_pairs(out, seed=0):
    """N_PAIRS pair files as the export writes them, and one file that is
    not a pair.  Pair i: 0-300 points; about 70% seen again in the warped
    image with 0.3-2.5 px of Gaussian noise, the rest new; descriptors of the
    re-seen points are noisy copies, 0-50% of them scrambled."""
    rng = np.random.default_rng(seed)
    h, w = HW
    out.mkdir(parents=True)
    for i in range(N_PAIRS):
        n = 3 if i == 5 else int(rng.integers(20, 300))  # pair 5: too few points
        Hm = np.eye(3)
        Hm[:2, :2] += rng.uniform(-0.08, 0.08, (2, 2))
        Hm[:2, 2] = rng.uniform(-8, 8, 2)
        Hm[2, :2] = rng.uniform(-3e-4, 3e-4, 2)
        p1 = np.c_[rng.uniform([0, 0], [w, h], (n, 2)), rng.uniform(0.015, 1, n)]
        seen = rng.uniform(size=n) < 0.7
        q = np.c_[p1[seen, :2], np.ones(seen.sum())] @ Hm.T
        p2_seen = q[:, :2] / q[:, 2:] + rng.normal(0, rng.uniform(0.3, 2.5), (seen.sum(), 2))
        extra = int(rng.integers(0, 60))
        p2 = np.r_[np.c_[p2_seen, rng.uniform(0.015, 1, seen.sum())],
                   np.c_[rng.uniform([0, 0], [w, h], (extra, 2)), rng.uniform(0.015, 1, extra)]]
        d1 = _unit(rng.normal(size=(n, 256)))
        d2_seen = d1[seen] + rng.normal(0, 0.04, (seen.sum(), 256))
        scramble = rng.uniform(size=seen.sum()) < rng.uniform(0, 0.5)
        d2_seen[scramble] = rng.normal(size=(scramble.sum(), 256))
        d2 = _unit(np.r_[d2_seen, rng.normal(size=(extra, 256))])
        order = rng.permutation(len(p2))
        p2, d2 = p2[order].astype(np.float32), d2[order]
        p1 = p1.astype(np.float32)
        tracker = PointTracker(max_length=2, nn_thresh=1.0)
        tracker.update(p1.T, d1.T)
        tracker.update(p2.T, d2.T)
        matches = tracker.get_matches()
        image = rng.uniform(size=HW).astype(np.float32)
        np.savez_compressed(out / f"{i}.npz", image=image, warped_image=image[::-1].copy(),
                            prob=p1, warped_prob=p2, desc=d1, warped_desc=d2, homography=Hm,
                            matches=matches.T if matches is not None else np.zeros((0, 4)))
    np.savez(out / "notes.npz", what=np.arange(3))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    _write_pairs(root / "files")
    return root / "files"


def _both(pairs, tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(pairs, jax_dir)
    shutil.copytree(pairs, port_dir)
    return jax_dir, port_dir


def test_same_files_with_cv2_in_the_seam(pairs, tmp_path, monkeypatch):
    jax_dir, port_dir = _both(pairs, tmp_path)
    want = j_eval.evaluate(jax_dir)
    monkeypatch.setattr(homography_fit, "find_homography", _cv2_fit)
    got = t_eval.evaluate(port_dir)
    assert list(got) == list(want) and got["n_files"] == want["n_files"] == N_PAIRS
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    assert 0 < want["correctness_3"] < want["correctness_50"] <= 1  # the columns vary
    assert (port_dir / "result.txt").read_text().splitlines() == \
        (jax_dir / "result.txt").read_text().splitlines()
    with np.load(jax_dir / "result.npz") as a, np.load(port_dir / "result.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if a[k].dtype.kind in "US":
                np.testing.assert_array_equal(b[k], a[k])
            else:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=0)


def test_same_files_with_the_ports_fit(pairs, tmp_path):
    jax_dir, port_dir = _both(pairs, tmp_path)
    want = j_eval.evaluate(jax_dir)
    got = t_eval.evaluate(port_dir)
    assert list(got) == list(want)
    for k in ("n_files", "repeatability", "localization_err"):
        assert got[k] == want[k], k
    for k in ("matching_score", "nn_map"):
        print(f"{k}: port {got[k]:.6f}, JAX with cv2 {want[k]:.6f}")
        assert got[k] == pytest.approx(want[k], rel=REL), k
    with np.load(jax_dir / "result.npz") as a, np.load(port_dir / "result.npz") as b:
        flips = int((a["correctness_per_file"] != b["correctness_per_file"]).any(1).sum())
        map_rel = np.abs(b["mAP_per_file"] - a["mAP_per_file"]).max()
    print(f"correctness flips in {flips} of {N_PAIRS} pairs; per-pair mAP differs by at most "
          f"{map_rel:.4f}")
    for eps in t_eval.HOMOGRAPHY_THRESH:
        k = f"correctness_{eps}"
        assert abs(got[k] - want[k]) <= 1 / N_PAIRS + 1e-12, k


def test_flags_and_output_images(pairs, tmp_path, capsys):
    _, port_dir = _both(pairs, tmp_path)
    rep = t_eval.evaluate(port_dir, do_rep=True, do_homo=False)
    assert set(rep) == {"n_files", "repeatability", "localization_err"}
    with np.load(port_dir / "result.npz") as z:
        assert "mAP_per_file" not in z.files and len(z["files"]) == N_PAIRS
    t_eval.main([str(port_dir), "-homo"])
    printed = capsys.readouterr().out
    assert "nn_map: " in printed and "repeatability" not in printed
    # -o: the JAX CLI's drawings (OpenCV), pixel for pixel
    jax_dir = tmp_path / "jax_img"
    shutil.copytree(pairs, jax_dir)
    j_eval.evaluate(jax_dir, do_rep=True, do_homo=False, output_img=True)
    t_eval.main([str(port_dir), "-r", "-o"])
    for sub in ("repeatibility3", "matching"):
        names = sorted(p.name for p in (jax_dir / sub).iterdir())
        assert names == sorted(p.name for p in (port_dir / sub).iterdir()) and names, sub
        for name in names:
            np.testing.assert_array_equal(cv2.imread(str(port_dir / sub / name)),
                                          cv2.imread(str(jax_dir / sub / name)), err_msg=name)
    with pytest.raises(FileNotFoundError):
        t_eval.evaluate(tmp_path / "nowhere")


# -- the sweep ----------------------------------------------------------------


def _rows(path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def _jax_checkpoints(folder):
    from ssp.models import build_model
    from ssp.train.checkpoint import load_weights_npz, save_checkpoint
    from ssp.train.state import create_train_state

    model = build_model("SuperPointNet_gauss2_ssmall", n_classes=133, dtype=jnp.float32)
    state = load_weights_npz(NPZ, jax.jit(lambda key: create_train_state(
        model, key, (1, 64, 96, 1)))(jax.random.key(0)))
    for it in (1000, 2000):
        save_checkpoint(folder, state, it)
    (folder / "superPointNet_1500").mkdir()  # an empty orbax directory: it fails


def _port_checkpoints(folder):
    folder.mkdir(parents=True)
    for it in (1000, 2000):
        shutil.copy(NPZ, folder / f"superPointNet_{it}.npz")
    from ssp_torch.models.weights import read_state_dict

    sd = read_state_dict(NPZ, "SuperPointNet_gauss2_ssmall")
    del sd["convDb.bias"]
    torch.save({"model_state_dict": sd, "n_iter": 1500},
               folder / "superPointNet_1500_checkpoint.pth.tar")


def test_sweep_matches_the_jax_sweep_at_fp32(tmp_path, monkeypatch):
    from ssp.cli import export_eval as j_sweep

    _make_tree(tmp_path / "hp")
    j_cfg = _config(tmp_path / "hp", False, dtype=jnp.float32)
    j_cfg["model"]["folder"] = str(tmp_path / "jax_ckpts")
    _jax_checkpoints(tmp_path / "jax_ckpts")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "jax"))
    j_csv = j_sweep.sweep(j_cfg, "exp")

    t_cfg = _config(tmp_path / "hp", False)
    t_cfg["model"]["folder"] = str(tmp_path / "port_ckpts")
    _port_checkpoints(tmp_path / "port_ckpts")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "port"))
    t_csv = export_eval.sweep(t_cfg, "exp", device="cpu")
    assert t_csv == tmp_path / "port" / "exp" / "checkpoints" / "results.csv"

    (j_head, j_rows), (t_head, t_rows) = _rows(j_csv), _rows(t_csv)
    assert t_head == j_head == export_eval.CSV_FIELDS
    assert [r["iter"] for r in t_rows] == [r["iter"] for r in j_rows] == ["1000", "1500", "2000"]
    j_ref, t_ref = _rows(j_csv.with_name("results_ref.csv")), _rows(t_csv.with_name(
        "results_ref.csv"))
    assert t_ref[0] == j_ref[0] == export_eval.REF_CSV_FIELDS and len(t_ref[1]) == 3
    assert sorted((tmp_path / "port" / "exp" / "predictions").iterdir()) == \
        [tmp_path / "port" / "exp" / "predictions" / f"ckpt_{it}" for it in (1000, 2000)]
    for j_row, t_row in zip(j_rows, t_rows):
        j_v = {k: float(v) for k, v in j_row.items()}
        t_v = {k: float(v) for k, v in t_row.items()}
        print(f"iter {t_row['iter']}: port {t_v}\n          JAX  {j_v}")
        if t_row["iter"] == "1500":
            assert all(v == 0.0 for k, v in t_v.items() if k != "iter")
            assert all(v == 0.0 for k, v in j_v.items() if k != "iter")
            continue
        assert t_v["repeatability"] == j_v["repeatability"] > 0
        assert t_v["localization_err"] == pytest.approx(j_v["localization_err"], rel=1e-4)
        for k in ("matching_score", "nn_map"):
            assert t_v[k] == pytest.approx(j_v[k], rel=REL), k
        for eps in t_eval.HOMOGRAPHY_THRESH:
            assert abs(t_v[f"correctness_{eps}"] - j_v[f"correctness_{eps}"]) <= 0.25 + 1e-12
    assert t_rows[0] == {**t_rows[2], "iter": "1000"}


def test_sweep_of_orbax_directories_alone_raises(tmp_path, monkeypatch):
    folder = tmp_path / "ckpts"
    for it in (1000, 2000):
        (folder / f"superPointNet_{it}").mkdir(parents=True)
    cfg = _config(tmp_path / "hp", False)
    cfg["model"]["folder"] = str(folder)
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "logs"))
    with pytest.raises(ValueError, match="save_weights_npz"):
        export_eval.sweep(cfg, "exp", device="cpu")
    assert not (tmp_path / "logs" / "exp" / "checkpoints" / "results.csv").exists()
    with pytest.raises(FileNotFoundError):
        export_eval.checkpoints(tmp_path)
    shutil.copy(NPZ, folder / "superPointNet_500.npz")
    assert [it for it, _ in export_eval.checkpoints(folder)] == [500, 1000, 2000]
