"""The classical baselines of the port (``ssp_torch/export/features.py``,
``ssp_torch/export/classical.py``, ``ssp_torch/kernels/bfmatch.py``,
``ssp_torch/cli/export_classical.py``) against OpenCV 5.0 and the JAX
package's ``ssp.export.classical`` / ``ssp.cli.export_classical``.

* **The primitives** of ``features_host.cpp`` against the ``cv2`` call each
  reproduces, on OpenCV's portable path: ``getGaussianKernel``, the float
  ``GaussianBlur``, the float separable filter on 8-bit images, ``resize``
  (``INTER_LINEAR`` and ``INTER_NEAREST`` on float, ``INTER_LINEAR_EXACT``
  on 8-bit), ``copyMakeBorder``, ``fastAtan2`` through ``cv2.phase`` and
  ``exp32f`` through ``cv2.exp``: equal, bit for bit.
* **ORB** against ``cv2.ORB_create`` on OpenCV's default path at nfeatures
  1000 and 500 on seven seeded images (synthetic shapes, textured noise, a
  blank image): equal keypoints (x, y, size, angle, response, octave) and
  descriptor bytes.
* **SIFT** against ``cv2.SIFT_create`` with ``cv2.setUseOptimized(False)``
  on one thread: equal keypoints, order and descriptors.  (With several
  threads OpenCV's own orientations move by a few ulps from run to run,
  measured: up to 3e-5 degrees on ~1% of the keypoints; one thread makes
  OpenCV deterministic.)  Against OpenCV's default path (AVX2/AVX-512 with
  FMA, IPP) the port is no further than OpenCV's own portable path.
* **The matcher**'s plain version against ``cv2.BFMatcher(norm,
  crossCheck=True)``, exact, ties and empty sides included; the kernel's
  cases on the card are in ``tests/test_torch_cuda.py``.
* **The fixtures** of ``tests/data/torch_classical`` (written by
  ``scripts/make_classical_fixtures.py``) still equal what OpenCV gives
  where the tests run, and the port equals them.
* **The export CLI** against ``ssp.cli.export_classical`` on a tree from
  ``scripts/make_synth_hpatches.py`` (4 pairs, both methods): every npz key
  equal, SIFT against the JAX CLI run on OpenCV's portable path; and the
  port's ``evaluate`` against the JAX one on those files: the same columns.

``cv2.setUseOptimized`` and ``cv2.setNumThreads`` are global: every test
that changes them restores them (:func:`opencv`).
"""

import contextlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from ssp.cli import evaluate as j_eval
from ssp.cli import export_classical as j_cli
from ssp.export import classical as j_classical
from ssp_torch.cli import evaluate as t_eval
from ssp_torch.cli import export_classical as t_cli
from ssp_torch.data.synthetic_shapes import generate_sample
from ssp_torch.evaluations import homography_fit
from ssp_torch.export import classical as t_classical
from ssp_torch.export import _cv_primitives as P
from ssp_torch.export import features as F
from ssp_torch.kernels import bfmatch

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "torch_classical"
sys.path.insert(0, str(ROOT / "scripts"))
import make_classical_fixtures as fixtures  # noqa: E402

HW = (240, 320)
# SIFT's Gaussian sigmas at OpenCV's defaults: the base blur of the doubled
# image (in float), then the five increments between the layers of an octave
_K = 2.0 ** (1 / 3)
SIFT_SIGMAS = (float(np.sqrt(np.float32(1.6) ** 2 - np.float32(0.5) ** 2 * 4)),) + tuple(
    float(np.sqrt((_K ** i * 1.6) ** 2 - (_K ** (i - 1) * 1.6) ** 2)) for i in range(1, 6))


@contextlib.contextmanager
def opencv(optimized: bool, threads: int = 1):
    """OpenCV's global state for the block: its portable path or its
    default one, on ``threads`` threads; restored after."""
    saved = cv2.useOptimized(), cv2.getNumThreads()
    cv2.setUseOptimized(optimized)
    cv2.setNumThreads(threads)
    try:
        yield
    finally:
        cv2.setUseOptimized(saved[0])
        cv2.setNumThreads(saved[1])


def _images():
    """Seven seeded 240x320 uint8 images: five synthetic-shapes scenes,
    textured noise and a blank image (no keypoints)."""
    out = {}
    for i, prim in enumerate(("draw_checkerboard", "draw_cube", "draw_multiple_polygons",
                              "draw_star", "draw_stripes")):
        img, _ = generate_sample(prim, size=HW, seed=i)
        out[prim] = (img * 255).astype(np.uint8)
    rng = np.random.default_rng(5)
    out["noise"] = cv2.GaussianBlur((rng.random(HW) * 255).astype(np.uint8), (5, 5), 1.0)
    out["blank"] = np.full(HW, 128, np.uint8)
    return out


IMAGES = _images()


def _cv_keypoints(kps):
    return (np.array([k.pt for k in kps], np.float32).reshape(-1, 2),
            np.array([k.size for k in kps], np.float32),
            np.array([k.angle for k in kps], np.float32),
            np.array([k.response for k in kps], np.float32),
            np.array([k.octave for k in kps], np.int32))


def _assert_same(kps, desc, got, got_desc):
    pt, size, angle, response, octave = _cv_keypoints(kps)
    if desc is None:
        desc = np.zeros((0, got_desc.shape[1]), got_desc.dtype)
    assert len(got.pt) == len(pt)
    np.testing.assert_array_equal(got.pt, pt)
    np.testing.assert_array_equal(got.size, size)
    np.testing.assert_array_equal(got.angle, angle)
    np.testing.assert_array_equal(got.response, response)
    np.testing.assert_array_equal(got.octave, octave)
    assert got_desc.dtype == desc.dtype
    np.testing.assert_array_equal(got_desc, desc)


# -- the primitives --------------------------------------------------------


@pytest.mark.parametrize("sigma", SIFT_SIGMAS + (2.0, 0.7, 5.3))
def test_gaussian_kernel(sigma):
    n = int(round(sigma * 8 + 1)) | 1
    np.testing.assert_array_equal(P.gaussian_kernel_f32(n, sigma),
                                  cv2.getGaussianKernel(n, sigma, cv2.CV_32F).ravel())


@pytest.mark.parametrize("shape", [(480, 640), (61, 83), (3, 5), (7, 2)])
def test_gaussian_blur_f32(shape):
    rng = np.random.default_rng(shape[0])
    img = cv2.GaussianBlur(np.round(rng.random(shape) * 255).astype(np.float32), (3, 3), 0.8)
    with opencv(optimized=False):
        for sigma in SIFT_SIGMAS:
            np.testing.assert_array_equal(P.gaussian_blur_f32(img, sigma),
                                          cv2.GaussianBlur(img, (0, 0), sigma), err_msg=str(sigma))


def test_gaussian_blur_u8_float():
    """ORB's 7x7, sigma 2 blur of a pyramid level: OpenCV blurs a sub-matrix,
    which its fixed-point 8-bit path does not take, so the float separable
    filter runs (``cv2.sepFilter2D`` with the float kernel gives its bytes)."""
    rng = np.random.default_rng(1)
    img = (rng.random((67, 91)) * 255).astype(np.uint8)
    k = cv2.getGaussianKernel(7, 2.0, cv2.CV_32F)
    with opencv(optimized=False):
        np.testing.assert_array_equal(P.gaussian_blur_u8_float(img, 7, 2.0),
                                      cv2.sepFilter2D(img, -1, k, k))


@pytest.mark.parametrize("size", [(90, 62), (15, 7), (22, 15), (45, 31), (30, 21)])
def test_resize(size):
    """SIFT's doubling (INTER_LINEAR to twice the size) and halving of odd
    sides (INTER_NEAREST to half), ORB's pyramid steps (INTER_LINEAR_EXACT)."""
    w, h = size
    rng = np.random.default_rng(w)
    img = np.round(rng.random((h // 2, w // 2)) * 255).astype(np.float32)
    u8 = (rng.random((240, 320)) * 255).astype(np.uint8)
    with opencv(optimized=False):
        np.testing.assert_array_equal(
            P.resize_f32(img, (w // 2 * 2, h // 2 * 2)),
            cv2.resize(img, (w // 2 * 2, h // 2 * 2), interpolation=cv2.INTER_LINEAR))
        img = np.round(rng.random((31, 45)) * 255).astype(np.float32)
        np.testing.assert_array_equal(P.resize_f32(img, (w, h), nearest=True),
                                      cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))
        big = (int(round(320 / 1.2 ** (w % 7 + 1))), int(round(240 / 1.2 ** (w % 7 + 1))))
        for wh in (big, size):
            np.testing.assert_array_equal(
                P.resize_linear_exact_u8(u8, wh),
                cv2.resize(u8, wh, interpolation=cv2.INTER_LINEAR_EXACT), err_msg=str(wh))


def test_copy_make_border():
    rng = np.random.default_rng(2)
    for shape, b in (((20, 30), 32), ((240, 320), 32), ((3, 4), 7)):
        img = (rng.random(shape) * 255).astype(np.uint8)
        np.testing.assert_array_equal(P.copy_make_border_u8(img, b),
                                      cv2.copyMakeBorder(img, b, b, b, b, cv2.BORDER_REFLECT_101))


def test_fast_atan2():
    rng = np.random.default_rng(3)
    y = (rng.standard_normal(200_000) * 50).astype(np.float32)
    x = (rng.standard_normal(200_000) * 50).astype(np.float32)
    y[:100], x[50:150] = 0, 0  # the axes and the origin
    with opencv(optimized=False):
        want = cv2.phase(x[None], y[None], angleInDegrees=True)[0]
    np.testing.assert_array_equal(P.fast_atan2(y, x), want)


def test_exp32f():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(200_000) * 20).astype(np.float32)
    with opencv(optimized=False):
        np.testing.assert_array_equal(P.exp32f(x), cv2.exp(x[None])[0])
        for n in (1, 3, 7, 9, 33):  # the scalar and the vector code of OpenCV
            small = -np.abs(x[:n] / 4)
            inplace = small[None].copy()
            cv2.exp(inplace, inplace)
            np.testing.assert_array_equal(P.exp32f(small), inplace[0])


# -- ORB and SIFT ----------------------------------------------------------


@pytest.mark.parametrize("nfeatures", [1000, 500])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_orb_equals_opencv(name, nfeatures):
    img = IMAGES[name]
    with opencv(optimized=True, threads=4):
        kps, desc = cv2.ORB_create(nfeatures=nfeatures).detectAndCompute(img, None)
    got, got_desc = F.orb(img, nfeatures)
    _assert_same(kps, desc, got, got_desc)
    assert len(got.pt) > 0 or name in ("blank", "draw_stripes")  # two images without corners


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_sift_equals_opencv_portable_path(name):
    img = IMAGES[name]
    with opencv(optimized=False):
        kps, desc = cv2.SIFT_create(nfeatures=1000).detectAndCompute(img, None)
    got, got_desc = F.sift(img, 1000)
    _assert_same(kps, desc, got, got_desc)


def test_sift_nfeatures_and_odd_sizes():
    """All keypoints (nfeatures 0), a cut that keeps the keypoints tied at
    the boundary, and image sizes whose octaves halve odd sides."""
    rng = np.random.default_rng(6)
    odd = cv2.GaussianBlur((rng.random((97, 131)) * 255).astype(np.uint8), (3, 3), 1.0)
    for img, nfeatures in ((IMAGES["noise"], 0), (IMAGES["noise"], 50), (odd, 1000), (odd, 50)):
        with opencv(optimized=False):
            kps, desc = cv2.SIFT_create(nfeatures=nfeatures).detectAndCompute(img, None)
        got, got_desc = F.sift(img, nfeatures)
        _assert_same(kps, desc, got, got_desc)


@pytest.mark.parametrize("shape", [(0, 0), (1, 1), (1, 40), (40, 1), (3, 3), (17, 40), (33, 300)])
def test_small_images_and_refusals(shape):
    """Small images give OpenCV's keypoints; where OpenCV raises (ORB on a
    side of one pixel: a pyramid level of none; SIFT on an empty image) the
    port raises too."""
    rng = np.random.default_rng(sum(shape))
    img = (cv2.GaussianBlur((rng.random(shape) * 255).astype(np.uint8), (3, 3), 1)
           if min(shape) else np.zeros(shape, np.uint8))
    for nfeatures in (0, 500):
        for make, detect, optimized in ((cv2.ORB_create, F.orb, True),
                                        (cv2.SIFT_create, F.sift, False)):
            with opencv(optimized=optimized):
                try:
                    want = make(nfeatures=max(nfeatures, 1) if make is cv2.ORB_create
                                else nfeatures).detectAndCompute(img, None)
                except cv2.error:
                    want = None
            if want is None:
                with pytest.raises(ValueError, match="OpenCV refuses"):
                    detect(img, nfeatures)
            else:
                got, got_desc = detect(img, max(nfeatures, 1) if detect is F.orb else nfeatures)
                _assert_same(*want, got, got_desc)


def _envelope(ref, other):
    """(count difference, share of ``ref``'s keypoints with one of ``other``
    within 0.1 px, share of differing descriptor entries over the pairs)."""
    (pa, da), (pb, db) = ref, other
    if not len(pa) or not len(pb):
        return abs(len(pa) - len(pb)), float(len(pa) == len(pb)), 0.0
    dist = np.linalg.norm(pa[:, None] - pb[None], axis=-1)
    j = dist.argmin(1)
    paired = dist[np.arange(len(pa)), j] < 0.1
    differ = float((da[paired] != db[j[paired]]).mean()) if paired.any() else 0.0
    return abs(len(pa) - len(pb)), float(paired.mean()), differ


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_sift_within_opencvs_own_envelope(name):
    """Against OpenCV's default path the port is no further than OpenCV's
    portable path is: keypoint count, share paired within 0.1 px, share of
    differing descriptor entries."""
    img = IMAGES[name]
    runs = {}
    for opt in (True, False):
        with opencv(optimized=opt):
            kps, desc = cv2.SIFT_create(nfeatures=1000).detectAndCompute(img, None)
        runs[opt] = (_cv_keypoints(kps)[0], np.zeros((0, 128)) if desc is None else desc)
    got, got_desc = F.sift(img, 1000)
    port = _envelope(runs[True], (got.pt, got_desc))
    own = _envelope(runs[True], runs[False])
    print(f"{name}: port vs default path {port}, OpenCV portable vs default {own}")
    assert port[0] <= own[0] and port[1] >= own[1] and port[2] <= own[2]


def test_detect_describe_equals_jax():
    """``classical_detect_describe``: the same pts (float64) and descriptors
    (float32 SIFT, uint8 ORB) as the JAX function, order included; the
    empty case's zeros."""
    for name in ("draw_checkerboard", "noise", "blank"):
        img = IMAGES[name].astype(np.float32) / 255
        for method in ("sift", "orb"):
            with opencv(optimized=method == "orb"):
                want = j_classical.classical_detect_describe(img, method, 1000)
            got = t_classical.classical_detect_describe(img, method, 1000)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape, (name, method)
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        t_classical.classical_detect_describe(img, "surf")


# -- the matcher -------------------------------------------------------------


def _bf(desc1, desc2, norm):
    m = cv2.BFMatcher(norm, crossCheck=True).match(desc1, desc2)
    return np.array([[x.queryIdx, x.trainIdx, x.distance] for x in m]).reshape(-1, 3)


@pytest.mark.parametrize("seed", range(6))
def test_match_plain_equals_bfmatcher(seed):
    """Ties everywhere: few distinct values per entry, planted duplicate rows
    on both sides (equal distances to several rows) and shared rows."""
    rng = np.random.default_rng(seed)
    nq, nt = rng.integers(1, 400, 2)
    levels = int(rng.integers(2, 9))
    q = (rng.integers(0, levels, (nq, 128)) * (255 // (levels - 1))).astype(np.float32)
    t = (rng.integers(0, levels, (nt, 128)) * (255 // (levels - 1))).astype(np.float32)
    n = min(nq, nt, 7)
    t[:n] = q[:n]
    if nt > 12:
        t[8:11] = t[7]
    if nq > 12:
        q[8:11] = q[7]
    qb = rng.integers(0, 256, (nq, 32), dtype=np.uint8) & rng.integers(1, 256, dtype=np.uint8)
    tb = rng.integers(0, 256, (nt, 32), dtype=np.uint8) & rng.integers(1, 256, dtype=np.uint8)
    tb[:min(nq, nt, 3)] = qb[:min(nq, nt, 3)]
    for method, a, b, norm in (("sift", q, t, cv2.NORM_L2), ("orb", qb, tb, cv2.NORM_HAMMING)):
        got = t_classical.match_classical(a, b, method, device="cpu")
        want = _bf(a, b, norm)
        assert got.dtype == np.float64 and got.shape == want.shape, method
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, j_classical.match_classical(a, b, method))


def test_match_plain_at_full_size_and_edges():
    """1000 x 1000 SIFT-like rows (integers over [0, 255]: distinct squared
    sums that round to the same float distance), an empty side, one row."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (1000, 128)).astype(np.float32)
    b = rng.integers(0, 256, (1000, 128)).astype(np.float32)
    b[:20] = a[:20]
    np.testing.assert_array_equal(t_classical.match_classical(a, b, "sift", device="cpu"),
                                  _bf(a, b, cv2.NORM_L2))
    assert t_classical.match_classical(a[:0], b, "sift", device="cpu").shape == (0, 3)
    assert t_classical.match_classical(a, b[:0], "sift", device="cpu").shape == (0, 3)
    np.testing.assert_array_equal(t_classical.match_classical(a[:1], b, "sift", device="cpu"),
                                  _bf(a[:1], b, cv2.NORM_L2))


def _root_tie(s: int = 4_197_200):
    """One query row of zeros and two train rows at squared distances
    ``s + 1`` (train row 0) and ``s`` (train row 1), whose float roots are
    equal (2048.707 for the default)."""
    q = np.zeros((1, 128), np.float32)
    t = np.zeros((2, 128), np.float32)
    t[:, :64] = 255.0
    t[:, 64:66] = (188.0, 16.0)  # 64·255² + 188² + 16² = 4,197,200
    t[0, 66] = 1.0
    assert [int((r.astype(np.int64) ** 2).sum()) for r in t] == [s + 1, s]
    assert np.sqrt(np.float32(s)) == np.sqrt(np.float32(s + 1))
    return q, t


def test_match_root_tie_keeps_the_lower_index():
    """Two squared distances with one float root: OpenCV keeps the lower
    train index (the larger sum), as do the plain version, the CPU
    ``match_classical`` and the JAX package's; a minimum over the integer
    sums would take train row 1."""
    q, t = _root_tie()
    want = _bf(q, t, cv2.NORM_L2)
    np.testing.assert_array_equal(want, [[0.0, 0.0, np.float32(np.sqrt(np.float32(4_197_200)))]])
    np.testing.assert_array_equal(bfmatch.bfmatch_plain(torch.from_numpy(q),
                                                        torch.from_numpy(t)).numpy(), want)
    np.testing.assert_array_equal(t_classical.match_classical(q, t, "sift", device="cpu"), want)
    np.testing.assert_array_equal(j_classical.match_classical(q, t, "sift"), want)


def test_match_refuses_inexact_descriptors():
    a = np.full((3, 128), 10.0, np.float32)
    for bad in (0.5, -1.0, 256.0, np.nan):
        b = a.copy()
        b[1, 5] = bad
        with pytest.raises(ValueError, match="integers in"):
            bfmatch.bfmatch(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(ValueError):
        bfmatch.bfmatch(torch.zeros(2, 32, dtype=torch.uint8), torch.zeros(2, 32))


def test_matches_from_keys():
    """The kernel's output, a key per query row (distance bits above the
    train row, -1 for none), decoded into the plain version's rows."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.integers(0, 256, (90, 128)).astype(np.float32))
    t = q[torch.from_numpy(rng.permutation(90))[:70]].clone()
    t[:5] = 255 - t[:5]
    want = bfmatch.bfmatch_plain(q, t)
    keys = torch.full((90,), -1, dtype=torch.int64)
    bits = want[:, 2].float().view(torch.int32).long()
    keys[want[:, 0].long()] = (bits << 32) | want[:, 1].long()
    assert 0 < len(want) < 90
    assert torch.equal(bfmatch.matches_from_keys(keys), want)


def test_sqrt_rn_is_ieee():
    """The plain version's float square root, over every squared distance
    two SIFT rows can have, against numpy's IEEE float32 sqrt."""
    s = np.arange(0, 128 * 255 * 255 + 1, dtype=np.int32)
    np.testing.assert_array_equal(bfmatch.sqrt_rn(torch.from_numpy(s)).numpy(),
                                  np.sqrt(s.astype(np.float32)))


# -- the fixtures ------------------------------------------------------------


def _fixture(name):
    with np.load(FIXTURES / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


FIXTURE_NAMES = sorted(json.loads((FIXTURES / "manifest.json").read_text())["keypoints"])


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixtures_are_opencvs(name):
    """The committed fixtures still equal the installed OpenCV: the portable
    SIFT and ORB exactly; the default SIFT exactly where the CPU has the
    dispatch levels of the machine that wrote them, else within OpenCV's
    envelope."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    fx = _fixture(name)
    assert fx["image"].shape == HW and manifest["nfeatures"] == fixtures.NFEATURES
    runs = fixtures.opencv_runs(fx["image"])
    same_cpu = manifest["cpu_features"] == cv2.getCPUFeaturesLine()
    for run, (kp, octave, desc) in runs.items():
        if run == "sift_default" and not same_cpu:
            ref = (fx["sift_plain_kp"][:, :2], fx["sift_plain_desc"])
            assert _envelope((kp[:, :2], desc), ref)[1] >= 0.99
            continue
        np.testing.assert_array_equal(kp, fx[f"{run}_kp"], err_msg=run)
        np.testing.assert_array_equal(octave, fx[f"{run}_octave"], err_msg=run)
        np.testing.assert_array_equal(desc, fx[f"{run}_desc"], err_msg=run)


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_port_equals_fixtures(name):
    fx = _fixture(name)
    for run, detect in (("sift_plain", F.sift), ("orb", F.orb)):
        kps, desc = detect(fx["image"], fixtures.NFEATURES)
        kp = np.concatenate([kps.pt, kps.size[:, None], kps.angle[:, None],
                             kps.response[:, None]], axis=1)
        np.testing.assert_array_equal(kp, fx[f"{run}_kp"], err_msg=run)
        np.testing.assert_array_equal(kps.octave, fx[f"{run}_octave"], err_msg=run)
        np.testing.assert_array_equal(desc.astype(np.uint8), fx[f"{run}_desc"], err_msg=run)
        assert (desc == fx[f"{run}_desc"]).all()


# -- the export CLI and the evaluation -----------------------------------------


@pytest.fixture(scope="module")
def synth_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("classical") / "hp"
    subprocess.run([sys.executable, str(ROOT / "scripts" / "make_synth_hpatches.py"), str(root),
                    "--n-seq", "4", "--pairs", "1", "--size", "240", "320"],
                   check=True, capture_output=True, timeout=300)
    return root


def _config(root, method):
    return {"data": {"dataset": "hpatches", "alteration": "all", "root": str(root),
                     "preprocessing": {"resize": [240, 320]}},
            "model": {"name": method, "top_k": 1000, "nn_thresh": 1.0}}


@pytest.mark.parametrize("method", ["sift", "orb"])
def test_export_equals_jax_cli(synth_tree, tmp_path, monkeypatch, method):
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path))
    config = _config(synth_tree, method)
    with opencv(optimized=method == "orb"):
        assert j_cli.export_classical(config, "jax") == 4
    seconds = {}
    assert t_cli.export_classical(config, "port", device="cpu", seconds=seconds) == 4
    assert set(seconds) == {"read", "detect", "match", "write"}
    jax_dir, port_dir = tmp_path / "jax" / "predictions", tmp_path / "port" / "predictions"
    names = sorted(p.name for p in jax_dir.glob("*.npz"))
    assert names == sorted(p.name for p in port_dir.glob("*.npz")) == [f"{i}.npz" for i in range(4)]
    matched = 0
    for f in names:
        with np.load(jax_dir / f) as a, np.load(port_dir / f) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (f, k)
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{f} {k}")
            matched += len(a["matches"])
    assert matched > 0
    # a second call writes nothing
    before = {f: (port_dir / f).stat().st_mtime_ns for f in names}
    assert t_cli.export_classical(config, "port", device="cpu") == 4
    assert before == {f: (port_dir / f).stat().st_mtime_ns for f in names}

    # the evaluation of those files: the same columns (OpenCV's RANSAC in the
    # port's seam, as tests/test_torch_evaluate.py holds it)
    def cv2_fit(src, dst):
        H, mask = cv2.findHomography(src, dst, cv2.RANSAC)
        return H, None if mask is None else mask.ravel().astype(bool)

    shutil.copytree(jax_dir, tmp_path / "eval_jax")
    shutil.copytree(port_dir, tmp_path / "eval_port")
    want = j_eval.evaluate(tmp_path / "eval_jax")
    monkeypatch.setattr(homography_fit, "find_homography", cv2_fit)
    got = t_eval.evaluate(tmp_path / "eval_port")
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


def test_cli_main_on_the_cpu(synth_tree, tmp_path, monkeypatch):
    import yaml

    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(_config(synth_tree, "orb")))
    t_cli.main([str(cfg), "exper", "--device", "cpu"])
    assert len(list((tmp_path / "exper" / "predictions").glob("*.npz"))) == 4
