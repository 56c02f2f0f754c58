"""Port parity for the sequence and COCO readers: ``ssp_torch.data.kitti``
(``KittiDataset`` as ``Kitti``/``Kitti_inh``, ``TumDataset``,
``ApolloDataset``) and ``ssp_torch.data.coco.CocoDataset`` against the JAX
package's classes, on trees OpenCV writes.

Bars: exact.  The same length, names, ``split_dir`` and label join, the
same padded points, and bit-identical images: the JAX readers decode with
OpenCV and resize with its INTER_AREA, the port with its own decoder and
resize, including KITTI's 375×1242 PNG enlarged to the sequence export's
384×1248 and a 480×640 JPEG reduced to 240×320.
"""

from pathlib import Path

import numpy as np
import pytest

from ssp_torch import registry
from ssp_torch.data.coco import CocoDataset
from ssp_torch.data.kitti import ApolloDataset, KittiDataset, TumDataset

cv2 = pytest.importorskip("cv2")
j_coco = pytest.importorskip("ssp.data.coco")
j_kitti = pytest.importorskip("ssp.data.kitti")


def _scene_rgb(h, w, seed):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.stack([100 + 80 * np.sin(xs / (7.0 + c) + ys / (19.0 + c)) for c in range(3)], -1)
    img += rng.normal(0, 10, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _labels(path: Path, n: int, seed: int):
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    np.savez_compressed(path, pts=rng.uniform(0, 100, (n, 3)).astype(np.float32))


def _same(port, jax_ds):
    assert len(port) == len(jax_ds) > 0
    for i in range(len(port)):
        a, b = port[i], jax_ds[i]
        assert set(a) == set(b) and a["name"] == b["name"]
        for key in ("image", "points", "points_valid"):
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{a['name']}: {key}")
    return [port[i]["name"] for i in range(len(port))]


SEQUENCES = {  # port class, JAX class, frame subpath
    "Kitti": (KittiDataset, "KittiDataset", "image_02/data"),
    "Tum": (TumDataset, "TumDataset", "rgb"),
    "Apollo": (ApolloDataset, "ApolloDataset", ""),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sequence_readers_match_jax(tmp_path, name):
    """Two scenes: one of KITTI-size color PNG frames, one of JPEG frames
    (with a stray text file); labels for all but one frame; 384×1248."""
    port_cls, jax_name, sub = SEQUENCES[name]
    root, split_dir, labels = tmp_path / "data", tmp_path / "splits", tmp_path / "labels"
    frames = {"drive_0001": [(f"{i:010d}.png", (375, 1242)) for i in range(2)],
              "drive_0002": [(f"{i:010d}.jpg", (120, 160)) for i in range(3)]}
    for s, (scene, files) in enumerate(frames.items()):
        d = root / scene / sub
        d.mkdir(parents=True)
        (d / "timestamps.txt").write_text("0\n")
        for i, (f, (h, w)) in enumerate(files):
            cv2.imwrite(str(d / f), _scene_rgb(h, w, 10 * s + i),
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
            if (scene, f) != ("drive_0002", "0000000001.jpg"):
                _labels(labels / "train" / scene / f"{Path(f).stem}.npz", 40 + s, s)
    split_dir.mkdir()
    (split_dir / "train.txt").write_text("drive_0001\n\ndrive_0002\n")
    kw = dict(task="train", root=root, root_split_txt=split_dir,
              preprocessing={"resize": [384, 1248]}, max_points=32)
    assert registry.get("dataset", name) is port_cls
    jax_cls = getattr(j_kitti, jax_name)
    names = _same(port_cls(**kw), jax_cls(**kw))
    assert names == ["drive_0001/0000000000", "drive_0001/0000000001",
                     "drive_0002/0000000000", "drive_0002/0000000001",
                     "drive_0002/0000000002"]
    joined = _same(port_cls(labels=labels, **kw), jax_cls(labels=labels, **kw))
    assert "drive_0002/0000000001" not in joined and len(joined) == 4
    assert port_cls.split_dir("train") == jax_cls.split_dir("train") == "train"


def test_kitti_aliases_and_missing_split():
    assert registry.get("dataset", "Kitti_inh") is registry.get("dataset", "Kitti") is KittiDataset
    with pytest.raises(FileNotFoundError, match="split list"):
        KittiDataset(root=Path("/nonexistent-kitti"))


@pytest.mark.parametrize("task,folder", [("train", "train2017"), ("val", "val2017")])
def test_coco_reader_matches_jax(tmp_path, task, folder):
    """480×640 JPEGs, a 1-component JPEG and a PNG, reduced to 240×320; the
    label join keeps only images with a pseudo-label file."""
    d = tmp_path / "COCO" / folder
    d.mkdir(parents=True)
    stems = [f"{i:012d}" for i in (9, 25, 30, 42)]
    for i, stem in enumerate(stems):
        img = _scene_rgb(480, 640, i)
        if i == 1:
            cv2.imwrite(str(d / f"{stem}.jpg"), img[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 96])
        elif i == 3:
            cv2.imwrite(str(d / f"{stem}.png"), img)
        else:
            cv2.imwrite(str(d / f"{stem}.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    (d / "notes.txt").write_text("not an image\n")
    labels = tmp_path / "labels"
    for i, stem in enumerate(stems[:3]):
        _labels(labels / folder / f"{stem}.npz", 1200 if i == 0 else 10, i)  # > max_points
    kw = dict(task=task, root=tmp_path / "COCO", preprocessing={"resize": [240, 320]})
    assert registry.get("dataset", "Coco") is CocoDataset
    assert CocoDataset.split_dir(task) == j_coco.CocoDataset.split_dir(task) == folder
    assert _same(CocoDataset(**kw), j_coco.CocoDataset(**kw)) == stems
    joined = _same(CocoDataset(labels=labels, **kw), j_coco.CocoDataset(labels=labels, **kw))
    assert joined == stems[:3]
    assert CocoDataset(labels=labels, **kw)[0]["points_valid"].all()


def test_coco_batches_with_workers_equal_serial(tmp_path):
    """The loader's thread pool gives the batches of a serial read."""
    d = tmp_path / "COCO" / "train2017"
    d.mkdir(parents=True)
    for i in range(5):
        cv2.imwrite(str(d / f"{i:012d}.jpg"), _scene_rgb(96, 128, i))
    ds = CocoDataset(root=tmp_path / "COCO", preprocessing={"resize": [48, 64]})
    serial, threaded = ds.batches(4, seed=1), ds.batches(4, seed=1, workers=3)
    for _ in range(3):
        a, b = next(serial), next(threaded)
        assert a["image"].shape == (4, 48, 64)
        np.testing.assert_array_equal(a["image"], b["image"])
