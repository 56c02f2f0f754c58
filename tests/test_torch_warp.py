"""Port parity: ``ssp_torch.core.warp`` against ``ssp.core.warp``.

The samplers are fp32 gathers and blends on both sides: atol 1e-5 (the
source coordinate is computed with sums in another order, a few 1e-7 of a
pixel, times the image's slope).  The valid mask is four comparisons and an
integer-valued erosion: pixel-exact.  The structuring element is held
against ``cv2`` itself, which only the tests import.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.core import warp as jw
from ssp.core.homography import sample_homographies as j_sample
from ssp_torch.core import warp as tw

HA_PARAMS = dict(scaling_amplitude=0.2, perspective_amplitude_x=0.2,
                 perspective_amplitude_y=0.2, allow_artifacts=True, patch_ratio=0.85)


def _smooth(shape, seed):
    img = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    return cv2.GaussianBlur(img, (7, 7), 0)


def _homographies(seed, n):
    return np.array(j_sample(jax.random.key(seed), n, shift=-1.0, **HA_PARAMS))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_inv_warp_image_matches_jax(mode):
    img = np.stack([_smooth((48, 64), 0), _smooth((48, 64), 1)], axis=-1)
    Hs = _homographies(0, 5)
    want = np.asarray(jax.vmap(lambda Hm: jw.inv_warp_image(jnp.asarray(img), Hm, mode))(
        jnp.asarray(Hs)))
    # one image shared by the batch of homographies
    got = tw.inv_warp_image(torch.from_numpy(img), torch.from_numpy(Hs), mode).numpy()
    assert got.shape == want.shape == (5, 48, 64, 2)
    if mode == "bilinear":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        # a coordinate within 1e-6 of a half may round to the other pixel
        assert (np.abs(got - want) > 1e-6).mean() < 1e-3
    # a batch of images, one homography each
    imgs = np.stack([img, img[::-1].copy()])
    got2 = tw.inv_warp_image(torch.from_numpy(imgs), torch.from_numpy(Hs[:2]), mode).numpy()
    if mode == "bilinear":
        np.testing.assert_allclose(got2[0], want[0], atol=1e-5)


def test_nearest_sample_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(20, 30, 3)).astype(np.float32)
    # integers, halves (round to even on both sides) and points outside
    coords = np.concatenate([rng.uniform(-3, 33, (200, 2)),
                             np.array([[0.5, 1.5], [2.5, 3.5], [-0.5, 19.5], [29.5, 0.0]])])
    coords = coords.astype(np.float32)
    want = np.asarray(jw.nearest_sample(jnp.asarray(img), jnp.asarray(coords)))
    got = tw.nearest_sample(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6])
def test_ellipse_element_matches_cv2(radius):
    want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * radius, 2 * radius))
    np.testing.assert_array_equal(tw._ellipse_element(radius), want)
    np.testing.assert_array_equal(tw._ellipse_offsets(radius), jw._ellipse_offsets(radius))


@pytest.mark.parametrize("radius", [0, 1, 2, 3, 4])
def test_compute_valid_mask_pixel_exact(radius):
    Hs = _homographies(10 + radius, 12)
    want = np.asarray(jax.vmap(lambda Hm: jw.compute_valid_mask((60, 80), Hm, radius))(
        jnp.asarray(Hs)))
    got = tw.compute_valid_mask((60, 80), torch.from_numpy(Hs), radius).numpy()
    assert got.shape == (12, 60, 80) and got.dtype == np.float32
    assert 0.05 < want.mean() < 0.98  # the masks are neither empty nor full
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [1, 3])
def test_erode_mask_matches_jax_and_cv2(radius):
    rng = np.random.default_rng(radius)
    mask = (cv2.GaussianBlur(rng.uniform(size=(40, 56)).astype(np.float32), (9, 9), 0) > 0.48)
    mask = mask.astype(np.float32)
    got = tw.erode_mask(torch.from_numpy(mask), radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(jw.erode_mask(jnp.asarray(mask), radius)))
    k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * radius, 2 * radius))
    np.testing.assert_array_equal(got, cv2.erode(mask, k, iterations=1))
