"""Port parity for the host-side readers: ``ssp_torch.data.base`` against
OpenCV, and ``ssp_torch.data.hpatches.PatchesDataset`` against the JAX
package's, on seeded files that OpenCV writes.

Bars: exact.  ``read_gray`` must return what the JAX package computes from
``cv2.imread(..., IMREAD_GRAYSCALE)`` and ``cv2.resize(..., INTER_AREA)``
(uint8, then /255), for P5 and P6 files, at the same size, integer factors,
non-integer downscales (HPatches' 600×800 → 240×320 is 2.5×), non-uniform
ratios, enlargements and mixed axes.  Homographies: allclose 1e-12 (the
same float64 arithmetic).
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

from ssp.data.hpatches import PatchesDataset as JPatchesDataset
from ssp_torch import registry
from ssp_torch.data.base import read_gray, read_pnm_header, resize_area, rgb_to_gray, write_pnm
from ssp_torch.data.hpatches import PatchesDataset

RESIZES = [
    ((48, 64), (48, 64)),       # identity
    ((96, 128), (48, 64)),      # 2× (OpenCV's 2×2 block path)
    ((144, 192), (48, 64)),     # 3× (integer factor, fp32 mean)
    ((240, 640), (240, 320)),   # 1× × 2×
    ((120, 160), (48, 64)),     # 2.5×
    ((600, 800), (240, 320)),   # 2.5×, HPatches at the protocol's size
    ((480, 640), (240, 320)),   # non-uniform source, 2×
    ((375, 1242), (240, 320)),  # KITTI-like, non-uniform non-integer
    ((481, 643), (240, 320)),   # odd sizes
    ((60, 80), (240, 320)),     # enlargement
    ((37, 53), (48, 64)),       # enlargement by a non-integer ratio
    ((50, 300), (100, 120)),    # enlarged rows, reduced columns
]


def _image(shape, seed):
    """Seeded uint8 content: noise with a smooth ramp and blocks."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    ramp = (np.add.outer(np.arange(h), 2 * np.arange(w)) % 256).astype(np.int32)
    img = (ramp + rng.integers(0, 64, shape[:2])) % 256
    if len(shape) == 3:
        img = np.stack([img, 255 - img, rng.integers(0, 256, (h, w))], axis=-1)
    return img.astype(np.uint8)


@pytest.mark.parametrize("src,dst", RESIZES, ids=lambda s: "x".join(map(str, s)))
def test_resize_area_equals_cv2(src, dst):
    for seed in range(2):
        img = _image(src, seed)
        want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area(img, dst), want)


@pytest.mark.parametrize("shape,suffix", [((37, 53, 3), ".ppm"), ((600, 800, 3), ".ppm"),
                                          ((64, 96), ".pgm")])
@pytest.mark.parametrize("resize", [None, (240, 320)])
def test_read_gray_equals_cv2(tmp_path, shape, suffix, resize):
    """Files that OpenCV writes (P6 from its BGR image, P5 from gray) read
    as ``ssp.data.base.read_gray`` reads them through OpenCV."""
    path = tmp_path / f"img{suffix}"
    cv2.imwrite(str(path), _image(shape, 3))
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert read_pnm_header(path)[:3] == (shape[0], shape[1], 3 if len(shape) == 3 else 1)
    if resize is not None:
        want = cv2.resize(want, (resize[1], resize[0]), interpolation=cv2.INTER_AREA)
    got = read_gray(path, resize)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32) / 255.0)


def test_rgb_to_gray_equals_cv2_on_every_channel_value(tmp_path):
    rgb = np.stack(np.meshgrid(np.arange(256), np.arange(0, 256, 5), np.arange(0, 256, 7),
                               indexing="ij"), axis=-1).reshape(256, -1, 3).astype(np.uint8)
    path = tmp_path / "all.ppm"
    cv2.imwrite(str(path), rgb[..., ::-1])  # OpenCV writes BGR as RGB
    np.testing.assert_array_equal(rgb_to_gray(rgb), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("shape", [(20, 30), (20, 30, 3)])
def test_write_pnm_reads_back_in_cv2(tmp_path, shape):
    img = _image(shape, 5)
    path = tmp_path / ("a.ppm" if len(shape) == 3 else "a.pgm")
    write_pnm(path, img)
    back = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1] if len(shape) == 3 else back, img)


def test_pnm_header_with_comments(tmp_path):
    img = _image((7, 9), 6)
    path = tmp_path / "c.pgm"
    path.write_bytes(b"P5\n# a comment\n9 # width\n7\n255\n" + img.tobytes())
    np.testing.assert_array_equal(read_gray(path), img.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(read_gray(path), cv2.imread(str(path), 0) / np.float32(255))


@pytest.mark.parametrize("content,message", [
    (b"\xff\xd8\xff\xe0" + bytes(64), "truncated JPEG"),
    (b"\x89PNG\r\n\x1a\n" + bytes(64), "bad CRC"),
    (b"P2\n2 2\n255\n1 2 3 4\n", "not a JPEG, PNG or binary netpbm"),
    (b"P5\n2 2\n65535\n" + bytes(8), "maxval"),
    (b"P5\n2 2\n255\n" + bytes(3), "truncated"),
])
def test_other_formats_raise_naming_the_file(tmp_path, content, message):
    path = tmp_path / "bad.img"
    path.write_bytes(content)
    with pytest.raises(ValueError, match=message) as err:
        read_gray(path)
    assert str(path) in str(err.value)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_gray(tmp_path / "none.ppm")


def _make_tree(root: Path, hw=(60, 80), n_seq=3, views=(2, 3)):
    """HPatches-layout tree as ``tests/test_export_eval.py`` builds one:
    textured ``1.ppm``, translated views, ``H_1_<i>`` homographies (the
    views here differ in size from the reference, as in HPatches)."""
    rng = np.random.default_rng(0)
    for s in range(n_seq):
        seq = root / (("i_seq" if s % 2 else "v_seq") + str(s))
        seq.mkdir(parents=True)
        h, w = hw
        base = cv2.GaussianBlur(rng.uniform(0, 255, (h, w)).astype(np.uint8), (5, 5), 0)
        cv2.imwrite(str(seq / "1.ppm"), cv2.cvtColor(base, cv2.COLOR_GRAY2BGR))
        for i in views:
            H = np.eye(3)
            H[:2, 2] = rng.uniform(-3, 3, 2)
            size = (w + 4 * i, h + 2 * i)
            warped = cv2.warpPerspective(base, H, size)
            color = np.stack([warped, np.roll(warped, 1, 0), 255 - warped], axis=-1)
            cv2.imwrite(str(seq / f"{i}.ppm"), color)
            np.savetxt(seq / f"H_1_{i}", H)


@pytest.mark.parametrize("resize", [None, [48, 64]])
@pytest.mark.parametrize("alteration", ["all", "i", "v"])
def test_patches_dataset_matches_jax(tmp_path, resize, alteration):
    _make_tree(tmp_path)
    pre = {"resize": resize} if resize else None
    want = JPatchesDataset(root=tmp_path, alteration=alteration, preprocessing=pre)
    got = registry.get("dataset", "patches_dataset")(root=tmp_path, alteration=alteration,
                                                     preprocessing=pre)
    assert isinstance(got, PatchesDataset)
    assert len(got) == len(want) == {"all": 6, "i": 2, "v": 4}[alteration]
    for a, b in zip(got, want):
        assert a["name"] == b["name"]
        for key in ("image", "warped_image"):
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_allclose(a["homography"], b["homography"], rtol=0, atol=1e-12)
    assert [n for n, _ in got.images()] == [n for n, _ in want.images()]


def test_patches_dataset_default_root_and_names(tmp_path, monkeypatch):
    _make_tree(tmp_path / "HPatches", n_seq=1)
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path))
    ds = registry.get("dataset", "hpatches")(preprocessing={"resize": [48, 64]})
    assert registry.get("dataset", "PatchesDataset") is PatchesDataset
    assert [p["name"] for p in ds.pairs] == ["v_seq0/1_2", "v_seq0/1_3"]
    batch = next(ds.batches(2, shuffle=False))
    assert batch["warped_image"].shape == (2, 48, 64) and "name" not in batch
