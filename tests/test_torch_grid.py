"""Port parity: ``ssp_torch.core`` grid ops and ``bilinear_sample`` vs the
JAX package's ``ssp.core`` on the same numpy inputs.

Tolerance: fp32, atol 1e-6.  The grid ops are pure reshapes (exact); the
softmax and the bilinear weights are a few fp32 operations whose
evaluation order may differ by an ulp or two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.core import grid as jgrid
from ssp.core.warp import bilinear_sample as j_bilinear_sample
from ssp_torch.core import grid as tgrid
from ssp_torch.core.warp import bilinear_sample

ATOL = 1e-6


def _both(fn_j, fn_t, x, **kw):
    want = np.asarray(fn_j(jnp.asarray(x), **kw))
    got = fn_t(torch.from_numpy(np.array(x)), **kw).numpy()
    return got, want


@pytest.mark.parametrize("block", [2, 8])
def test_space_depth_roundtrip(block):
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 3)).astype(np.float32)
    got, want = _both(jgrid.space_to_depth, tgrid.space_to_depth, x, block=block)
    np.testing.assert_array_equal(got, want)
    got2, want2 = _both(jgrid.depth_to_space, tgrid.depth_to_space, want, block=block)
    np.testing.assert_array_equal(got2, want2)
    np.testing.assert_array_equal(got2, x)


@pytest.mark.parametrize("add_dustbin", [True, False])
def test_labels_to_cells(add_dustbin):
    rng = np.random.default_rng(1)
    labels = (rng.uniform(size=(2, 32, 48, 1)) > 0.97).astype(np.float32)
    got, want = _both(jgrid.labels_to_cells, tgrid.labels_to_cells, labels,
                      add_dustbin=add_dustbin)
    assert got.shape == want.shape == (2, 4, 6, 65 if add_dustbin else 64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("channels", [65, 64])
def test_flatten_detection(channels):
    semi = np.random.default_rng(2).normal(0, 3, size=(2, 6, 8, channels)).astype(np.float32)
    got, want = _both(jgrid.flatten_detection, tgrid.flatten_detection, semi)
    assert got.shape == want.shape == (2, 48, 64, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bilinear_sample_zero_padding():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(6, 8, 5)).astype(np.float32)
    # in-bounds, on-grid, and out-of-bounds (partly and wholly) samples
    coords = np.stack([rng.uniform(-2, 10, 200), rng.uniform(-2, 8, 200)], -1).astype(np.float32)
    coords[:4] = [[0, 0], [7, 5], [3.5, 2.25], [-1.5, -1.5]]
    want = np.asarray(j_bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))
    got = bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bilinear_sample_batched_matches_per_image():
    """The port's leading batch dimension equals JAX's vmap over images."""
    import jax

    rng = np.random.default_rng(4)
    img = rng.normal(size=(3, 6, 8, 4)).astype(np.float32)
    coords = np.stack([rng.uniform(-1, 9, (3, 50)), rng.uniform(-1, 7, (3, 50))], -1)
    coords = coords.astype(np.float32)
    want = np.asarray(jax.vmap(j_bilinear_sample)(jnp.asarray(img), jnp.asarray(coords)))
    got = bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("scale", [8, 2])
def test_linear_upsample_matches_jax_resize(scale):
    """The semantic head's ×8 upsample: ``jax.image.resize(..., "linear")``
    equals ``F.interpolate(mode="bilinear", align_corners=False)`` when
    upsampling (half-pixel centres, edge clamping, no antialias term)."""
    import jax
    import torch.nn.functional as F

    x = np.random.default_rng(5).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 5 * scale, 7 * scale, 3), "linear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=scale,
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
