"""The port's drawing helpers and PNG writer against OpenCV 5.0, byte for
byte: ``ssp_torch.utils.draw`` against ``ssp.utils.draw`` (which draws with
``cv2``) and the C++ ``LINE_AA`` line and colour circle of
``ssp_torch.data.raster`` against ``cv2.line``/``cv2.circle`` on seeded
sweeps (1, 3 and 4 channels; end points off the canvas, steep, degenerate);
``write_png`` read back by ``cv2.imread`` equal to what ``cv2.imwrite``
then ``cv2.imread`` give."""

import sys

import cv2
import numpy as np
import pytest

import ssp.utils.draw as j_draw
from ssp_torch.data import raster
from ssp_torch.data.imageio import decode_gray, write_png
from ssp_torch.postprocess.tracker import PointTracker
from ssp_torch.utils import draw
from test_torch_threads import _one_thread  # noqa: F401  (autouse)


def _sweep_line(rng, h, w, i):
    span = 3 * max(h, w)
    p1, p2 = (tuple(int(v) for v in rng.integers(-span, span, 2)) for _ in range(2))
    if i % 4 == 0:  # both ends on the canvas
        p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        p2 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
    if i % 7 == 0:  # steep
        p2 = (p1[0] + int(rng.integers(-2, 3)), p1[1] + int(rng.integers(-50, 50)))
    if i % 11 == 0:  # a point
        p2 = p1
    return p1, p2


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_line_aa_and_circle_match_opencv(channels):
    rng = np.random.default_rng(channels)
    for i in range(1500):
        h, w = (int(v) for v in rng.integers(2, 80, 2))
        shape = (h, w) if channels == 1 else (h, w, channels)
        base = rng.integers(0, 256, shape, dtype=np.uint8)
        color = tuple(int(v) for v in rng.integers(0, 256, channels))
        p1, p2 = _sweep_line(rng, h, w, i)
        want, got = base.copy(), base.copy()
        cv2.line(want, p1, p2, color, 1, cv2.LINE_AA)
        raster.line_aa(got, p1, p2, color)
        np.testing.assert_array_equal(got, want, err_msg=f"line {h}x{w} {p1} {p2} {color}")
        c = (int(rng.integers(-10, w + 10)), int(rng.integers(-10, h + 10)))
        r = int(rng.integers(0, 9))
        want, got = base.copy(), base.copy()
        cv2.circle(want, c, r, color, -1)
        raster.circle_color(got, c, r, color)
        np.testing.assert_array_equal(got, want, err_msg=f"circle {h}x{w} {c} {r}")


def test_draw_keypoints_and_matches_match_opencv():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(48, 64)).astype(np.float32)
    img2 = (rng.uniform(size=(40, 72)) * 255).astype(np.uint8)
    pts = np.concatenate([rng.uniform(-6, 70, (80, 2)), rng.uniform(size=(80, 1))], axis=1)
    pts[:4, :2] = [[2.5, 3.5], [3.5, 4.5], [0.0, 0.0], [63.0, 47.0]]  # ties of the round
    for scale, radius in ((1, 3), (3, 2)):
        np.testing.assert_array_equal(draw.draw_keypoints(img, pts, radius, (10, 200, 30), scale),
                                      j_draw.draw_keypoints(img, pts, radius, (10, 200, 30), scale))
    np.testing.assert_array_equal(draw.draw_keypoints(img2, pts[:0]),
                                  j_draw.draw_keypoints(img2, pts[:0]))
    steep = np.array([[5.0, -20.0, 6.0, 70.0], [70.0, 1.0, -5.0, 39.0], [1.0, 1.0, 1.0, 1.0]])
    matches = np.concatenate([np.concatenate([rng.uniform(-10, 75, (300, 1)),
                                              rng.uniform(-10, 60, (300, 1)),
                                              rng.uniform(-10, 80, (300, 1)),
                                              rng.uniform(-10, 60, (300, 1))], axis=1), steep])
    for max_draw in (200, 400):
        np.testing.assert_array_equal(draw.draw_matches(img, None, img2, None, matches, max_draw),
                                      j_draw.draw_matches(img, None, img2, None, matches, max_draw))
    np.testing.assert_array_equal(draw.img_overlap(img, img[::-1], img * 0.5),
                                  j_draw.img_overlap(img, img[::-1], img * 0.5))
    np.testing.assert_array_equal(draw.to_u8(img), j_draw.to_u8(img))


def test_draw_tracks_matches_opencv():
    rng = np.random.default_rng(1)
    tracker = PointTracker(max_length=4, nn_thresh=0.9)
    base = rng.normal(size=(32, 60))
    pts = rng.uniform([0, 0, 0], [96, 64, 1], size=(60, 3))
    for _ in range(5):
        pts = pts + np.array([rng.normal(scale=3.0), rng.normal(scale=3.0), 0.0])
        desc = base + 0.05 * rng.normal(size=base.shape)
        tracker.update(pts.T.copy(), desc / np.linalg.norm(desc, axis=0))
    assert len(tracker.get_tracks(2))
    canvas = (rng.uniform(size=(64, 96, 3)) * 255).astype(np.uint8)
    got = draw.draw_tracks(canvas.copy(), tracker)
    np.testing.assert_array_equal(got, j_draw.draw_tracks(canvas.copy(), tracker))
    assert (got != canvas).any()


@pytest.mark.parametrize("channels", [1, 3])
def test_write_png_reads_back_as_opencv_writes(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53) if channels == 1 else (37, 53, 3), dtype=np.uint8)
    write_png(tmp_path / "port.png", img)
    cv2.imwrite(str(tmp_path / "cv.png"), img)
    want = cv2.imread(str(tmp_path / "cv.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED),
                                  want)
    np.testing.assert_array_equal(decode_gray(tmp_path / "port.png"),
                                  cv2.imread(str(tmp_path / "cv.png"), cv2.IMREAD_GRAYSCALE))
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "bad.png", img.astype(np.float32))


def test_plot_imgs(tmp_path, monkeypatch):
    img = np.random.default_rng(2).uniform(size=(16, 24))
    draw.plot_imgs([img, img], titles=["a"], path=str(tmp_path / "grid.png"))
    assert cv2.imread(str(tmp_path / "grid.png")) is not None
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        draw.plot_imgs([img])
