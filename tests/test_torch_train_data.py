"""Port parity: the training data path of ``ssp_torch.data`` against the JAX
package's ``ssp.data`` on the same numpy inputs.

* each photometric primitive, the Gaussian blur and ``photometric_augment``
  with the flagship's primitives, fed the JAX package's own draws
  (recomputed here from the same ``jax.random`` key by the JAX functions'
  own splits): within 1e-5 (fp32 convolutions summed in another order);
* ``splat_labels`` exactly and ``splat_residuals`` within 1e-6;
* ``prepare_batch`` on the gather route (the route off the card), with the
  JAX package's homographies and photometric draws fed in, against the JAX
  package's CPU ``prepare_batch`` for every output key: floats within
  1e-4, masks and points' validity exactly, the warped class ids (bilinear
  floats truncated) equal on all but 0.1% of the pixels inside the mask;
* the two-pass route on the CPU (the ``vresample_coef`` kernel's plain
  version) against the JAX two-pass warp with ``vresample_coef_pallas`` in
  interpret mode, as ``tests/test_torch_vresample.py`` holds it: images
  within 2e-4 of max|img|, class ids equal on all but 0.5% of the pixels;
* ``Coco_sem`` against ``ssp.data.coco.CocoSemDataset`` on a tree the test
  writes, with an ``INTER_NEAREST`` resize of the label PNG: equal
  samples, the class ids exactly; ``resize_nearest`` against ``cv2.resize``;
* the device corpus against ``ssp.data.device_corpus.DeviceCorpus``: the
  same arrays and dtypes (uint8 exactly when the images are 255-grids or
  when forced), the size guard, and sampled rows that are corpus rows
  (within an ulp of the ``/255``), reproducible from the generator.
"""

import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.core.homography import sample_homography as j_sample_homography
from ssp.data import photometric as jp
from ssp.data.coco import CocoSemDataset as JCocoSem
from ssp.data.device_corpus import DeviceCorpus as JDeviceCorpus
from ssp.data.pipeline import prepare_batch as j_prepare_batch
from ssp.data.pipeline import splat_labels as j_splat_labels
from ssp.data.pipeline import splat_residuals as j_splat_residuals
from ssp.core.homography import inv3 as j_inv3
from ssp.kernels import warp_twopass as jt
from ssp_torch.data import photometric as tp
from ssp_torch.data.coco import CocoSemDataset, resize_nearest
from ssp_torch.data.device_corpus import DeviceCorpus
from ssp_torch.data.pipeline import pad_points, prepare_batch, splat_labels, splat_residuals
from ssp_torch.data.prefetch import Prefetcher
from ssp_torch.kernels import vresample as vm
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

B, H, W = 2, 64, 96
# the flagship's augmentation (configs/pipeline240_wsem_200k.yaml)
PHOTO = {
    "enable": True,
    "primitives": ["random_brightness", "random_contrast", "additive_speckle_noise",
                   "additive_gaussian_noise", "additive_shade", "motion_blur"],
    "params": {
        "random_brightness": {"max_abs_change": 50},
        "random_contrast": {"strength_range": [0.5, 1.5]},
        "additive_gaussian_noise": {"stddev_range": [0, 10]},
        "additive_speckle_noise": {"prob_range": [0, 0.0035]},
        "additive_shade": {"transparency_range": [-0.5, 0.5], "kernel_size_range": [50, 100]},
        "motion_blur": {"max_kernel_size": 3},
    },
}
PAIR = {"enable": True, "valid_border_margin": 3, "params": {
    "translation": True, "rotation": True, "scaling": True, "perspective": True,
    "scaling_amplitude": 0.2, "perspective_amplitude_x": 0.2, "perspective_amplitude_y": 0.2,
    "patch_ratio": 0.85, "max_angle": 0.785, "allow_artifacts": True}}
HOMO = {"enable": True, "valid_border_margin": 2, "params": {
    "translation": True, "rotation": True, "scaling": True, "perspective": True,
    "scaling_amplitude": 0.1, "perspective_amplitude_x": 0.1, "perspective_amplitude_y": 0.1,
    "patch_ratio": 0.9, "max_angle": 0.3}}


def _jax_primitive_draws(name, key, shape, kw):
    """The random values ``ssp.data.photometric.<name>`` draws from ``key``."""
    Bn, Hn, Wn = shape
    u = jax.random.uniform
    if name == "random_brightness":
        m = kw["max_abs_change"] / 255.0
        return {"delta": u(key, (Bn, 1, 1), minval=-m, maxval=m)}
    if name == "random_contrast":
        lo, hi = kw["strength_range"]
        return {"f": u(key, (Bn, 1, 1), minval=lo, maxval=hi)}
    if name == "additive_gaussian_noise":
        k_std, k_noise = jax.random.split(key)
        lo, hi = kw["stddev_range"]
        return {"std": u(k_std, (Bn, 1, 1), minval=lo / 255.0, maxval=hi / 255.0),
                "noise": jax.random.normal(k_noise, shape)}
    if name == "additive_speckle_noise":
        k_p, k_u = jax.random.split(key)
        lo, hi = kw["prob_range"]
        return {"p": u(k_p, (Bn, 1, 1), minval=lo, maxval=hi), "u": u(k_u, shape)}
    if name == "additive_shade":
        k_t, k_geo, k_ks = jax.random.split(key, 3)
        kc, kr, ka = jax.random.split(k_geo, 3)
        n, min_dim = int(kw["nb_ellipses"]), min(Hn, Wn)
        return {
            "t": u(k_t, (Bn, 1, 1), minval=kw["transparency_range"][0],
                   maxval=kw["transparency_range"][1]),
            "centers": u(kc, (Bn, n, 2)) * jnp.array([Wn, Hn], jnp.float32),
            "radii": u(kr, (Bn, n, 2), minval=min_dim / 12.0, maxval=min_dim / 3.0),
            "theta": u(ka, (Bn, n), maxval=math.pi),
            "ks": u(k_ks, (Bn, 1), minval=kw["kernel_size_range"][0],
                    maxval=kw["kernel_size_range"][1]),
        }
    assert name == "motion_blur"
    K = int(kw["max_kernel_size"]) | 1
    k_ang, k_len = jax.random.split(key)
    return {"theta": u(k_ang, (Bn,), maxval=math.pi),
            "half": u(k_len, (Bn,), minval=0.5, maxval=K / 2.0)}


def _merged(name, params):
    kw = dict(jp.DEFAULT_PARAMS.get(name, {}))
    kw.update((params or {}).get(name, {}) or {})
    return kw


def jax_photo_draws(key, shape, primitives, params):
    """The draws of ``ssp.data.photometric.photometric_augment(key, ...)``:
    one subkey per listed primitive, split off in order."""
    out = []
    for name in primitives:
        key, sub = jax.random.split(key)
        d = _jax_primitive_draws(name, sub, shape, _merged(name, params))
        out.append({k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    return out


def _images(seed, b=B):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(b, H, W)).astype(np.float32)
    img[:, 10:30, 20:50] = 0.9  # structure for the blurs
    return img


@pytest.mark.parametrize("name", PHOTO["primitives"])
def test_photometric_primitive_with_jax_draws(name):
    imgs = _images(1)
    key = jax.random.key(11)
    kw = _merged(name, PHOTO["params"])
    want = np.asarray(getattr(jp, name)(key, jnp.asarray(imgs), **kw))
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in _jax_primitive_draws(name, key, imgs.shape, kw).items()}
    got = getattr(tp, name)(torch.from_numpy(imgs), draws, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the port's own draws have the shapes and ranges of the JAX ones
    own = getattr(tp, f"draw_{name}")(imgs.shape, torch.Generator().manual_seed(0), "cpu", **kw)
    assert own.keys() == draws.keys()
    for k in own:
        assert own[k].shape == draws[k].shape, k


def test_photometric_augment_and_blur_with_jax_draws():
    imgs = _images(2)
    key = jax.random.key(12)
    want = np.asarray(jp.photometric_augment(key, jnp.asarray(imgs), PHOTO["primitives"],
                                             PHOTO["params"]))
    draws = jax_photo_draws(key, imgs.shape, PHOTO["primitives"], PHOTO["params"])
    got = tp.photometric_augment(torch.from_numpy(imgs), PHOTO["primitives"], PHOTO["params"],
                                 draws=draws).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for sigma in (0.2, 1.5):
        np.testing.assert_allclose(
            tp.gaussian_blur(torch.from_numpy(imgs), sigma).numpy(),
            np.asarray(jp.gaussian_blur(jnp.asarray(imgs), sigma)), atol=1e-6, rtol=0)
    # the port's own draws: brightness within ±50/255, contrast in its range
    g = torch.Generator().manual_seed(3)
    own = tp.draw_photometric((64, H, W), PHOTO["primitives"], PHOTO["params"], g)
    assert float(own[0]["delta"].abs().max()) <= 50 / 255.0
    assert 0.5 <= float(own[1]["f"].min()) and float(own[1]["f"].max()) <= 1.5
    out = tp.photometric_augment(torch.from_numpy(_images(3, 64)), PHOTO["primitives"],
                                 PHOTO["params"], draws=own)
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0


def _points(seed, k=40):
    rng = np.random.default_rng(seed)
    pts = [rng.uniform([-2, -2], [W + 1, H + 1], size=(n, 2)) for n in (k, k // 2)]
    pts[0][:4] = [[3.5, 2.5], [3.5, 2.5], [10.4, 20.6], [94.6, 63.4]]  # halves, duplicates, edge
    return pad_points(pts, k)


def test_splats_match_jax():
    points, valid = _points(4)
    want_l = np.stack([np.asarray(j_splat_labels(jnp.asarray(p), jnp.asarray(v), (H, W)))
                       for p, v in zip(points, valid)])
    want_r = np.stack([np.asarray(j_splat_residuals(jnp.asarray(p), jnp.asarray(v), (H, W)))
                       for p, v in zip(points, valid)])
    got_l = splat_labels(torch.from_numpy(points), torch.from_numpy(valid), (H, W)).numpy()
    got_r = splat_residuals(torch.from_numpy(points), torch.from_numpy(valid), (H, W)).numpy()
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_allclose(got_r, want_r, atol=1e-6, rtol=0)
    assert set(np.unique(got_l)) == {0.0, 1.0}


def _sem(seed):
    rng = np.random.default_rng(seed)
    sem = np.full((B, H, W), 133, np.int32)
    for b in range(B):
        for _ in range(12):
            y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
            sem[b, y:y + rng.integers(6, 30), x:x + rng.integers(6, 40)] = rng.integers(0, 133)
    return sem


def _jax_homographies(key, cfg):
    params = {k: v for k, v in cfg["params"].items() if k != "valid_border_margin"}
    H_inv = jax.jit(jax.vmap(lambda k: j_sample_homography(k, **params)))(
        jax.random.split(key, B))
    return torch.from_numpy(np.array(H_inv.astype(jnp.float32)))


@pytest.fixture(scope="module")
def jax_batch():
    """The JAX package's CPU ``prepare_batch`` (gather warp) with homographic
    augmentation, the warped pair, photometric augmentation, Gaussian labels
    and semantics; and the draws it made, recomputed from its key."""
    imgs, sem = _images(5), _sem(6)
    points, valid = _points(7)
    key = jax.random.key(21)
    cfg = dict(photometric=PHOTO, homographic=HOMO, warped_pair=PAIR, gaussian_label_sigma=0.2,
               ignore_class=133)
    prep = jax.jit(lambda k, i, p, v, s: j_prepare_batch(k, i, p, v, sem=s, **cfg))
    want = {k: np.asarray(v) for k, v in prep(key, imgs, points, valid, sem).items()}
    _, k_homo, k_photo1, k_pair, k_photo2 = jax.random.split(key, 5)
    draws = {"homographic": _jax_homographies(k_homo, HOMO),
             "pair": _jax_homographies(k_pair, PAIR),
             "photo": jax_photo_draws(k_photo1, imgs.shape, PHOTO["primitives"],
                                      PHOTO["params"]),
             "photo_warped": jax_photo_draws(k_photo2, imgs.shape, PHOTO["primitives"],
                                             PHOTO["params"])}
    inputs = dict(images=torch.from_numpy(imgs), points=torch.from_numpy(points),
                  points_valid=torch.from_numpy(valid), sem=torch.from_numpy(sem))
    return want, draws, inputs, cfg


def test_prepare_batch_gather_route_matches_jax(jax_batch):
    want, draws, inputs, cfg = jax_batch
    x = inputs
    got = prepare_batch(x["images"], x["points"], x["points_valid"], sem=x["sem"],
                        draws=draws, **cfg)
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        assert g.shape == want[k].shape, k
        if k in ("valid_mask", "warped_valid_mask", "points_valid", "sem"):
            np.testing.assert_array_equal(g, want[k], err_msg=k)
        elif k == "warped_sem":
            inside = want["warped_valid_mask"] > 0
            assert ((g != want[k]) & inside).mean() <= 1e-3, k
            np.testing.assert_array_equal(g[~inside], want[k][~inside])
        else:
            np.testing.assert_allclose(g, want[k], atol=1e-4, rtol=0, err_msg=k)
    assert got["warped_sem"].dtype == torch.int32 and float(got["labels_2d"].max()) == 1.0


def _jax_coef_twopass(img, Hm):
    """The JAX two-pass warp on its coef route with ``vresample_coef_pallas``
    in interpret mode (``tests/test_torch_vresample.py``'s wrapper)."""
    H_px, W_px = img.shape
    S = max(H_px, W_px)
    sx, sy = (S - 1) / (W_px - 1), (S - 1) / (H_px - 1)
    T = jnp.array([[sx, 0.0, sx - 1.0], [0.0, sy, sy - 1.0], [0.0, 0.0, 1.0]])
    Hc = j_inv3(T) @ jnp.asarray(Hm) @ T
    canvas = jnp.pad(jnp.asarray(img), ((0, S - H_px), (0, S - W_px)))
    k = jt._mean_rotation_bucket(Hc)
    Hres = Hc @ jnp.stack([jt._rot_k((4 - kk) % 4) for kk in range(4)])[k]
    rlo = jnp.array([0, 0, S - H_px, S - W_px])[k]
    rhi = jnp.array([H_px, W_px, S, S])[k]
    clo = jnp.array([0, S - H_px, S - W_px, 0])[k]
    chi = jnp.array([W_px, S, S, H_px])[k]
    mid = jt._twopass_square_coef(canvas, Hres, rlo, rhi, clo, chi, interpret=True)
    return np.asarray(jnp.rot90(mid, k=int(k))[:H_px, :W_px])


def test_prepare_batch_twopass_route_matches_jax_twopass(jax_batch):
    """The warped pair on the two-pass route (photometric off, so the warped
    image is the warp itself), against the JAX two-pass warp in interpret
    mode image by image; the rest of the batch equals the gather route's."""
    _, draws, x, cfg = jax_batch
    cfg = dict(cfg, photometric=None, homographic=None)
    before = vm.coef_launches
    got = prepare_batch(x["images"], x["points"], x["points_valid"], sem=x["sem"], draws=draws,
                        warp="twopass", **cfg)
    assert vm.coef_launches == before  # CPU tensors run the plain version, never a launch
    gather = prepare_batch(x["images"], x["points"], x["points_valid"], sem=x["sem"],
                           draws=draws, warp="gather", **cfg)
    mask = got["warped_valid_mask"].numpy() > 0
    for b in range(B):
        Hm = draws["pair"][b].numpy()
        want = _jax_coef_twopass(x["images"][b].numpy(), Hm)
        np.testing.assert_allclose(got["warped_image"][b, ..., 0].numpy(), want,
                                   atol=2e-4 * np.abs(want).max(), rtol=0)
        wsem = _jax_coef_twopass(x["sem"][b].numpy().astype(np.float32), Hm)
        want_sem = np.where(mask[b], wsem.astype(np.int32), 133)
        assert (got["warped_sem"][b].numpy() != want_sem).mean() <= 5e-3
    for k in ("labels_2d", "warped_labels_2d", "warped_valid_mask", "H_pair", "points_valid"):
        torch.testing.assert_close(got[k], gather[k], rtol=0, atol=0)


def test_coco_sem_matches_jax(tmp_path):
    """The same tree through both readers: a 75×110 JPEG and panoptic PNG per
    image (raw ids, some outside the 133-class table), pseudo-labels, both
    splits, resized to 48×64 (INTER_AREA for the image, INTER_NEAREST for the
    ids)."""
    rng = np.random.default_rng(8)
    root, ann, labels = tmp_path / "COCO", tmp_path / "ann", tmp_path / "labels"
    for split in ("train2017", "val2017"):
        for d in (root / split, ann / f"semantic_{split}", labels / split):
            d.mkdir(parents=True)
        for i in range(3):
            stem = f"{i + 7:012d}"
            cv2.imwrite(str(root / split / f"{stem}.jpg"),
                        rng.uniform(0, 255, (75, 110)).astype(np.uint8))
            raw = rng.integers(0, 256, (75, 110)).astype(np.uint8)
            raw[:20] = 1
            cv2.imwrite(str(ann / f"semantic_{split}" / f"{stem}.png"), raw)
            np.savez(labels / split / f"{stem}.npz", pts=rng.uniform(0, 60, (9, 3)))
    for task in ("train", "val"):
        kw = dict(task=task, root=root, labels=labels, sem_labels=ann,
                  preprocessing={"resize": [48, 64]})
        want, got = JCocoSem(**kw), CocoSemDataset(**kw)
        assert len(got) == len(want) == 3
        for i in range(3):
            a, b = got[i], want[i]
            assert a.keys() == b.keys()
            np.testing.assert_array_equal(a["sem"], b["sem"])
            assert a["sem"].dtype == np.int32 and set(np.unique(a["sem"])) > {0, 133}
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["points"], b["points"])
            np.testing.assert_array_equal(a["points_valid"], b["points_valid"])
        batch = next(got.batches(2, seed=0))
        assert batch["sem"].shape == (2, 48, 64) and "name" not in batch


@pytest.mark.parametrize("src,dst", [((75, 110), (48, 64)), ((480, 640), (240, 320)),
                                     ((427, 640), (240, 320)), ((100, 90), (240, 320)),
                                     ((613, 411), (240, 320))])
def test_resize_nearest_matches_cv2(src, dst):
    img = np.random.default_rng(9).integers(0, 256, src).astype(np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest(img, dst), want)


def test_prefetcher_order_and_errors():
    assert list(Prefetcher(iter(range(50)), depth=3)) == list(range(50))

    def broken():
        yield 1
        raise OSError("disk")

    it = Prefetcher(broken())
    assert next(it) == 1
    with pytest.raises(OSError, match="disk"):
        next(it)


class _Grid:
    """Three samples whose images are exact k/255 grids (as decoded files
    are), with points and class ids; ``offset`` moves them off the grid."""

    def __init__(self, offset=0.0):
        self.offset = offset

    def __len__(self):
        return 3

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        img = rng.integers(0, 256, (H, W)).astype(np.float32) / 255.0 + self.offset
        return {"image": img, "points": rng.uniform(0, 60, (5, 2)).astype(np.float32),
                "points_valid": np.arange(5) < 3 + i, "sem": rng.integers(0, 134, (H, W))
                .astype(np.int32), "name": f"{i}"}


@pytest.mark.parametrize("offset,quantize", [(0.0, False), (1e-3, False), (1e-3, True)])
def test_device_corpus_matches_jax(offset, quantize):
    ds = _Grid(offset)
    want = JDeviceCorpus.from_dataset(ds, quantize=quantize)
    got = DeviceCorpus.from_dataset(ds, device="cpu", quantize=quantize)
    assert got.n == want.n == 3 and set(got.arrays) == set(want.arrays)
    for k, v in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[k].numpy(), np.asarray(v), err_msg=k)
        assert str(got.arrays[k].dtype).split(".")[-1] == str(v.dtype), k
    assert (got.arrays["image"].dtype == torch.uint8) == (offset == 0.0 or quantize)
    a = got.sample(8, torch.Generator().manual_seed(1))
    b = got.sample(8, torch.Generator().manual_seed(1))
    assert a["image"].dtype == torch.float32 and a["image"].shape == (8, H, W)
    assert all(torch.equal(a[k], b[k]) for k in a)
    rows = np.stack([ds[i]["image"] for i in range(3)])
    bar = 1.0 / 510.0 + 1e-6 if quantize else 1e-6
    for img, sem in zip(a["image"].numpy(), a["sem"].numpy()):
        i = int(np.argmin(np.abs(rows - img).reshape(3, -1).max(1)))
        assert np.abs(rows[i] - img).max() <= bar
        np.testing.assert_array_equal(sem, ds[i]["sem"])
    with pytest.raises(ValueError, match="streaming loader"):
        DeviceCorpus.from_dataset(ds, device="cpu", max_bytes=16)
