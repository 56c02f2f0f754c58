"""Port parity for the stage-4 HPatches descriptor export:
``ssp_torch.export.descriptors_export`` and ``ssp_torch.cli.export``
against ``ssp.export.descriptors_export`` and ``ssp.cli.export``, with the
trained weights of ``evidence/wsem_weights.npz`` on small seeded trees.

* **The same heatmap.**  Both exports get the same heatmap and coarse
  descriptors per image (the detector is replaced by a lookup, and
  ``flatten_detection``, held against JAX in ``test_torch_grid.py``, by the
  identity).  What follows is integer/compare work, one fp32 softmax
  expectation per point and a bilinear blend: points and validity exact,
  refined points and descriptors to atol 1e-5 (the bars of
  ``test_torch_process.py``), the npz files' keys, dtypes, images,
  homographies and matches exactly.
* **bf16 through the functions.**  The port's folded bf16 forward against
  the JAX package's (``fast_apply_fn``), both through
  ``make_detect_describe_fn``: the bars of ``test_torch_pipeline.py``.  The
  two forwards differ by flipped bf16 roundings, which reorder near-tied
  scores: ≥ 90% of the valid points of either side within 0.5 px of one of
  the other's, every JAX point scored ≥ 0.015 within 4 px (the NMS radius)
  of a port point, descriptor cosine ≥ 0.999 at shared points.
* **fp32 through both CLIs** (``fast_inference: false``), each under its
  own ``SSP_EXPER_PATH``: the port's ``nn.Module`` against the JAX CLI's
  flax module built with ``dtype: float32`` in the model params.  (The flax
  module's default compute dtype is bfloat16, so the JAX CLI's default
  forward at 240×320, which ``best_apply_fn`` does not fold, is a third
  forward, neither fp32 nor the folded bf16 one: the last test prints how
  far it is from the port's.)  The same files, keys, dtypes, images and
  homographies; the keypoints meet a tighter bar than bf16 does, because
  only fp32 summation order differs: ≥ 99% shared within 0.5 px, every
  point ≥ 0.015 within 0.5 px, cosine ≥ 0.9999; match counts within 2% of
  each other.  Measured on this tree: every point shared, cosine 1.000000,
  equal match counts.
"""

import os
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.export import descriptors_export as j_dd
from ssp.models.fast_infer import fast_apply_fn
from ssp_torch.bench import structured_images
from ssp_torch.cli import export as cli
from ssp_torch.export import descriptors_export as dd
from ssp_torch.models.fast_infer import best_apply_fn
from ssp_torch.models.weights import load_flax_npz
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "evidence" / "wsem_weights.npz"
H, W = 64, 96
KW = dict(top_k=200, conf_thresh=0.015, nms_radius=4, subpixel=True, patch_size=5)
SAME_PX = 0.5
# the CLI tests' detection threshold: the trained detector scores few points
# over the protocol's 0.015 on these small synthetic images, so a lower
# threshold puts more points under comparison
CLI_CONF = 0.001
KEYS = {"image", "warped_image", "prob", "warped_prob", "desc", "warped_desc", "homography",
        "matches"}


def _agreement(pts_a, desc_a, pts_b, desc_b):
    """(share of points with a partner within SAME_PX over the larger count,
    the largest distance from a ``b`` point ≥ 0.015 to its nearest ``a``
    point, the least descriptor cosine at partnered points)."""
    dist = np.abs(pts_a[:, None, :2] - pts_b[None, :, :2]).max(-1)  # [Na, Nb], inf-norm
    near = dist.argmin(1)
    paired = dist[np.arange(len(pts_a)), near] <= SAME_PX
    shared = paired.sum() / max(len(pts_a), len(pts_b))
    strong = pts_b[:, 2] >= 0.015
    far = dist[:, strong].min(0).max() if strong.any() else 0.0
    cos = (desc_a[paired] * desc_b[near[paired]]).sum(-1).min() if paired.any() else 1.0
    return float(shared), float(far), float(cos)


def _make_tree(root: Path, n_seq=2, hw=(160, 240)):
    """Two sequences of two pairs at 160×240 (2.5× the export's 64×96),
    written by OpenCV as HPatches ships them (P6 color), with known mild
    homographies (``tests/test_export_eval.py`` builds its tree alike)."""
    rng = np.random.default_rng(0)
    h, w = hw
    for s in range(n_seq):
        seq = root / (("i_seq" if s % 2 else "v_seq") + str(s))
        seq.mkdir(parents=True)
        base = (structured_images(1, h, w, 10 + s)[0, ..., 0] * 255).astype(np.uint8)
        cv2.imwrite(str(seq / "1.ppm"), cv2.cvtColor(base, cv2.COLOR_GRAY2BGR))
        for i in (2, 3):
            Hm = np.eye(3)
            Hm[:2, :2] += rng.uniform(-0.03, 0.03, (2, 2))
            Hm[:2, 2] = rng.uniform(-6, 6, 2)
            warped = cv2.warpPerspective(base, Hm, (w, h))
            cv2.imwrite(str(seq / f"{i}.ppm"), cv2.cvtColor(warped, cv2.COLOR_GRAY2BGR))
            np.savetxt(seq / f"H_1_{i}", Hm)


def _config(root, fast, **params):
    return {"data": {"name": "patches_dataset", "dataset": "hpatches", "alteration": "all",
                     "root": str(root), "preprocessing": {"resize": [H, W]}},
            "model": {"name": "SuperPointNet_gauss2_ssmall", "params": {"n_classes": 133, **params},
                      "detection_threshold": CLI_CONF, "nms": 4, "top_k": 1000, "nn_thresh": 1.0,
                      "fast_inference": fast, "subpixel": {"enable": True, "patch_size": 5}},
            "pretrained": str(NPZ)}


def _load(out_dir):
    files = sorted(os.listdir(out_dir))
    return files, [dict(np.load(Path(out_dir) / f)) for f in files]


# -- the same heatmap -------------------------------------------------------


def test_export_identical_on_the_same_heatmap(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    n = 6  # three pairs
    heats = (rng.uniform(size=(n, H, W)) ** 6).astype(np.float32)
    heats[0, 20:24, 30:34] = 0.5  # a plateau of ties
    coarse = rng.normal(size=(n, H // 8, W // 8, 256)).astype(np.float32)
    coarse /= np.linalg.norm(coarse, axis=-1, keepdims=True)
    images = [np.full((H, W), (i + 1) / (n + 1), np.float32) for i in range(n)]
    means = np.array([img.mean() for img in images], np.float32)
    pairs = [{"image": images[2 * p], "warped_image": images[2 * p + 1],
              "homography": rng.normal(size=(3, 3)), "name": f"s/1_{p}"} for p in range(n // 2)]

    # the detector as a lookup of the image's heatmap (and the identity for
    # flatten_detection), so both exports start from the same heatmap
    monkeypatch.setattr(j_dd, "flatten_detection", lambda semi: semi)
    monkeypatch.setattr(dd, "flatten_detection", lambda semi: semi)

    def j_apply(variables, x, train=False):
        i = jnp.argmin(jnp.abs(x.mean() - jnp.asarray(means)))
        return {"semi": jnp.asarray(heats)[i][None, ..., None],
                "desc": jnp.asarray(coarse)[i][None]}

    def t_apply(x):
        i = int(np.argmin(np.abs(float(x.mean()) - means)))
        return {"semi": torch.from_numpy(heats[i])[None, ..., None],
                "desc": torch.from_numpy(coarse[i])[None]}

    j_fn = j_dd.make_detect_describe_fn(j_apply, {}, **KW)
    t_fn = dd.make_detect_describe_fn(t_apply, device="cpu", **KW)
    for img in images:
        want = [np.asarray(a) for a in j_fn(jnp.asarray(img))]
        got = [t.numpy() for t in t_fn(img)]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[0][:, 2], want[0][:, 2])
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
        assert got[1].sum() > 10  # the comparison is not among empty sets
    # unrefined points: exact
    kw0 = {**KW, "subpixel": False}
    for img in images[:2]:
        want = np.asarray(j_dd.make_detect_describe_fn(j_apply, {}, **kw0)(jnp.asarray(img))[0])
        np.testing.assert_array_equal(
            dd.make_detect_describe_fn(t_apply, device="cpu", **kw0)(img)[0].numpy(), want)

    assert dd.run_descriptor_export(t_fn, pairs, tmp_path / "port") == len(pairs)
    assert j_dd.run_descriptor_export(j_fn, pairs, tmp_path / "jax") == len(pairs)
    files, got = _load(tmp_path / "port")
    assert files == _load(tmp_path / "jax")[0] == [f"{i}.npz" for i in range(len(pairs))]
    for a, b in zip(got, _load(tmp_path / "jax")[1]):
        assert set(a) == set(b) == KEYS
        for key in KEYS:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        for key in ("image", "warped_image", "homography", "matches"):
            np.testing.assert_array_equal(a[key], b[key])
        for key in ("prob", "warped_prob", "desc", "warped_desc"):
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5)
        assert a["matches"].shape[1] == 4


def test_export_resumes_and_keeps_the_zero_match_layout(tmp_path, monkeypatch):
    """A second run writes nothing; a removed file is written again, equal to
    the first; a pair without a valid point on one side has matches
    ``[0, 4]``."""
    rng = np.random.default_rng(1)
    heats = [rng.uniform(size=(H, W)).astype(np.float32) ** 6, np.zeros((H, W), np.float32)]
    coarse = torch.nn.functional.normalize(torch.randn(1, H // 8, W // 8, 16), dim=-1)

    def apply(x):
        return {"semi": torch.from_numpy(heats[int(x.mean() > 0.5)])[None, ..., None],
                "desc": coarse}

    monkeypatch.setattr(dd, "flatten_detection", lambda semi: semi)
    fn = dd.make_detect_describe_fn(apply, device="cpu", **KW)
    pairs = [{"image": np.zeros((H, W), np.float32),
              "warped_image": np.full((H, W), v, np.float32), "homography": np.eye(3)}
             for v in (0.0, 1.0)]
    assert dd.run_descriptor_export(fn, pairs, tmp_path) == 2
    first = dict(np.load(tmp_path / "0.npz"))
    assert dd.run_descriptor_export(fn, pairs, tmp_path) == 0
    (tmp_path / "0.npz").unlink()
    assert dd.run_descriptor_export(fn, pairs, tmp_path) == 1
    again = dict(np.load(tmp_path / "0.npz"))
    assert set(again) == KEYS and all(np.array_equal(again[k], first[k]) for k in KEYS)
    assert len(again["matches"]) > 0
    with np.load(tmp_path / "1.npz") as b:
        assert b["matches"].shape == (0, 4) and b["warped_prob"].shape == (0, 3)


# -- bf16 through the functions ----------------------------------------------


@pytest.fixture(scope="module")
def weights():
    tree = {}
    with np.load(NPZ) as data:
        for key in data.files:
            if key.split("/")[1] in ("convDS", "convSout"):
                continue
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(data[key])
    return tree, load_flax_npz(NPZ, "SuperPointNet_gauss2", device="cpu")


def test_bf16_functions_agree(weights):
    variables, model = weights
    j_fn = j_dd.make_detect_describe_fn(fast_apply_fn, variables, **KW)
    t_fn = dd.make_detect_describe_fn(best_apply_fn(model, input_hw=(H, W), device="cpu"),
                                      device="cpu", **KW)
    images = structured_images(3, H, W, 5)[..., 0]
    batch = t_fn(images)
    assert [tuple(t.shape) for t in batch] == [(3, KW["top_k"], 3), (3, KW["top_k"]),
                                               (3, KW["top_k"], 256)]
    for b, img in enumerate(images):
        want = [np.asarray(a) for a in j_fn(jnp.asarray(img))]
        got = [t.numpy() for t in t_fn(img)]
        pa, pb = got[0][got[1]], want[0][want[1]]
        shared, far, cos = _agreement(pa, got[2][got[1]], pb, want[2][want[1]])
        print(f"bf16 image {b}: {len(pa)} / {len(pb)} valid points, {shared:.4f} shared, "
              f"strong within {far:.2f} px, cosine {cos:.6f}")
        assert len(pb) >= 10 and shared >= 0.9 and far <= 4 and cos >= 0.999


# -- fp32 through both CLIs --------------------------------------------------


def test_fp32_clis_agree(tmp_path, monkeypatch):
    from ssp.cli.export import export_descriptor as j_export_descriptor

    _make_tree(tmp_path / "hp")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "jax"))
    j_export_descriptor(_config(tmp_path / "hp", False, dtype=jnp.float32), "exp")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "port"))
    assert cli.export_descriptor(_config(tmp_path / "hp", False), "exp", device="cpu") == 4

    files, got = _load(tmp_path / "port" / "exp" / "predictions")
    want_files, want = _load(tmp_path / "jax" / "exp" / "predictions")
    assert files == want_files == ["0.npz", "1.npz", "2.npz", "3.npz"]
    counts = []
    for a, b in zip(got, want):
        assert set(a) == set(b) == KEYS
        for key in KEYS:
            assert a[key].dtype == b[key].dtype, key
        for key in ("image", "warped_image", "homography"):
            np.testing.assert_array_equal(a[key], b[key])
        for side in ("", "warped_"):
            shared, far, cos = _agreement(a[f"{side}prob"], a[f"{side}desc"],
                                          b[f"{side}prob"], b[f"{side}desc"])
            print(f"fp32 {side or 'ref '}: {len(a[side + 'prob'])} / {len(b[side + 'prob'])} "
                  f"points, {shared:.4f} shared, strong within {far:.2f} px, cosine {cos:.6f}")
            assert len(b[f"{side}prob"]) >= 10
            assert shared >= 0.99 and far <= SAME_PX and cos >= 0.9999
        counts.append((len(a["matches"]), len(b["matches"])))
    print(f"fp32 matches per pair, port / JAX: {counts}")
    assert all(abs(p - j) <= 0.02 * j for p, j in counts) and sum(j for _, j in counts) > 10


def test_default_clis_run_different_bf16_forwards(tmp_path, monkeypatch):
    """With the configs' defaults the two CLIs run different bf16 forwards:
    the JAX CLI the flax module at its default compute dtype, bfloat16
    (``best_apply_fn`` passes the folded forward over at 240×320 and at this
    size), the port its folded bf16 forward.  Their outputs are not
    interchangeable; this test prints how far apart they are and holds only
    the files' layout and the inputs equal."""
    from ssp.cli.export import export_descriptor as j_export_descriptor

    _make_tree(tmp_path / "hp")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "jax"))
    j_export_descriptor(_config(tmp_path / "hp", True), "exp")
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "port"))
    assert cli.export_descriptor(_config(tmp_path / "hp", True), "exp", device="cpu") == 4
    files, got = _load(tmp_path / "port" / "exp" / "predictions")
    want_files, want = _load(tmp_path / "jax" / "exp" / "predictions")
    assert files == want_files
    for a, b in zip(got, want):
        assert set(a) == set(b) == KEYS and all(a[k].dtype == b[k].dtype for k in KEYS)
        for key in ("image", "warped_image", "homography"):
            np.testing.assert_array_equal(a[key], b[key])
        for side in ("", "warped_"):
            shared, far, cos = _agreement(a[f"{side}prob"], a[f"{side}desc"],
                                          b[f"{side}prob"], b[f"{side}desc"])
            print(f"default {side or 'ref '}: {len(a[side + 'prob'])} / {len(b[side + 'prob'])} "
                  f"points, {shared:.4f} shared, strong within {far:.2f} px, cosine {cos:.6f}")
        print(f"default matches, port / JAX: {len(a['matches'])} / {len(b['matches'])}")


def test_cli_main_on_the_cpu_resumes(tmp_path, monkeypatch):
    """``python -m ssp_torch.cli.export export_descriptor <config> <exper>
    --device cpu`` through ``main``: the bf16 forward by default, every
    pair written once, nothing on the second run."""
    import yaml

    _make_tree(tmp_path / "hp", n_seq=1)
    config = _config(tmp_path / "hp", True)
    del config["model"]["fast_inference"]
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(config))
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "logs"))
    argv = ["export_descriptor", str(path), "cli", "--device", "cpu"]
    cli.main(argv)
    out = tmp_path / "logs" / "cli" / "predictions"
    assert sorted(os.listdir(out)) == ["0.npz", "1.npz"]
    stamp = {f: (out / f).stat().st_mtime_ns for f in os.listdir(out)}
    cli.main(argv)
    assert {f: (out / f).stat().st_mtime_ns for f in os.listdir(out)} == stamp
    with pytest.raises(SystemExit):
        cli.main(["export_everything", str(path), "cli"])
