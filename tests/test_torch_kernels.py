"""Port parity: each kernel's plain PyTorch version (what its wrapper runs
for a CPU tensor) against the JAX package's Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it.

Bars: stem and down1 within ``ssp_torch.kernels.stem.assert_bf16_close``
(two bf16 ulps of the value plus 2⁻⁸ of the largest output, at most 1%
of the elements differing: fp32 sums in another order flip bf16
roundings); NMS exact (max and == only).  The kernels themselves run on
the card only, in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ssp.kernels.down1_pallas import down1_pallas_packed
from ssp.kernels.nms_pallas import nms_pallas
from ssp.kernels.stem_pallas_v2 import stem_pallas_packed
from ssp_torch.kernels import down1 as down1_mod
from ssp_torch.kernels import nms as nms_mod
from ssp_torch.kernels import stem as stem_mod


def _conv_bn(rng, cin):
    """Random conv weights and non-trivial BN statistics, folded."""
    w = rng.normal(0, (2.0 / (9 * cin)) ** 0.5, (3, 3, cin, 64)).astype(np.float32)
    g, b = rng.normal(1, 0.2, 64), rng.normal(0, 0.2, 64)
    m, v = rng.normal(0, 0.2, 64), rng.uniform(0.5, 1.5, 64)
    s = (g / np.sqrt(v + 1e-5)).astype(np.float32)
    return w, s, (b - m * s).astype(np.float32)


def _torch_params(p, device="cpu"):
    w1, s1, b1, w2, s2, b2 = (torch.from_numpy(a).to(device) for a in p)
    return w1.to(torch.bfloat16), s1, b1, w2.to(torch.bfloat16), s2, b2


@pytest.mark.parametrize("pool", [True, False])
def test_stem_plain_matches_pallas(pool):
    rng = np.random.default_rng(0)
    B, H, W = 2, 32, 48
    x = rng.uniform(size=(B, H, W, 1)).astype(np.float32)
    p = _conv_bn(rng, 1) + _conv_bn(rng, 64)
    want = np.asarray(stem_pallas_packed(jnp.asarray(x), *map(jnp.asarray, p),
                                         pool=pool, interpret=True), np.float32)
    if not pool:
        want = want.reshape(B, H, W, 64)  # the packed layout's row-major unpack
    before = stem_mod.launches
    got = stem_mod.stem(torch.from_numpy(x), *_torch_params(p), pool=pool)
    assert stem_mod.launches == before  # CPU tensors never count a launch
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    stem_mod.assert_bf16_close(got, torch.from_numpy(want))


@pytest.mark.parametrize("pool", [True, False])
def test_down1_plain_matches_pallas(pool):
    rng = np.random.default_rng(1)
    B, H2, W2 = 2, 32, 48
    x = torch.from_numpy(rng.uniform(size=(B, H2, W2, 64)).astype(np.float32)).to(torch.bfloat16)
    p = _conv_bn(rng, 64) + _conv_bn(rng, 64)
    want = np.asarray(down1_pallas_packed(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                          *map(jnp.asarray, p), pool=pool, interpret=True),
                      np.float32)
    if not pool:
        want = want.reshape(B, H2, W2, 64)
    got = down1_mod.down1(x, *_torch_params(p), pool=pool)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    stem_mod.assert_bf16_close(got, torch.from_numpy(want))


@pytest.mark.parametrize("shape", [(2, 48, 64), (2, 256, 320)], ids=["whole", "tiled"])
@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("border", [0, 4])
def test_nms_plain_matches_pallas_exactly(shape, radius, border):
    """48×64 takes the Pallas whole-image path, 256×320 its row tiles."""
    rng = np.random.default_rng(radius * 10 + border)
    heat = (rng.uniform(size=shape) ** 4).astype(np.float32)
    want = np.asarray(nms_pallas(jnp.asarray(heat), radius=radius, border=border, interpret=True))
    got = nms_mod.nms(torch.from_numpy(heat), radius=radius, border=border).numpy()
    np.testing.assert_array_equal(got, want)


def test_stem_unpooled_matches_pallas_v1():
    """``stem(..., pool=False)`` is the function of the JAX package's first
    stem kernel, ``ssp/kernels/stem_pallas.py::stem_pallas`` (conv1a → BN →
    ReLU → conv1b → BN → ReLU, no pool, bf16 NHWC), held here against that
    kernel in interpret mode at 2×32×128 with the inputs of
    ``tests/test_kernels.py::TestStemPallas._setup``."""
    from ssp.kernels.stem_pallas import fold_bn, stem_pallas

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 32, 128, 1)).astype(np.float32)
    w1 = rng.normal(0, 0.3, (3, 3, 1, 64)).astype(np.float32)
    w2 = rng.normal(0, 0.1, (3, 3, 64, 64)).astype(np.float32)
    bn = []
    for _ in range(2):
        g, b = np.abs(rng.normal(1, 0.2, 64)), rng.normal(0, 0.2, 64)
        m, v = rng.normal(0, 0.2, 64), np.abs(rng.normal(1, 0.2, 64)) + 0.1
        bn.append([np.array(a, np.float32) for a in
                   fold_bn(*(jnp.asarray(a, jnp.float32) for a in (g, b, m, v)))])
    p = (w1, *bn[0], w2, *bn[1])
    want = np.asarray(stem_pallas(jnp.asarray(x), *map(jnp.asarray, p), interpret=True), np.float32)
    got = stem_mod.stem(torch.from_numpy(x), *_torch_params(p), pool=False)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, 32, 128, 64)
    stem_mod.assert_bf16_close(got, torch.from_numpy(want))


def test_wrappers_check_inputs():
    rng = np.random.default_rng(2)
    p = _torch_params(_conv_bn(rng, 1) + _conv_bn(rng, 64))
    x = torch.zeros(1, 16, 16, 1)
    with pytest.raises(ValueError, match="float32"):
        stem_mod.stem(x.double(), *p)
    with pytest.raises(ValueError, match="w1"):
        stem_mod.stem(x, p[0].float(), *p[1:])
    with pytest.raises(ValueError, match="even"):
        stem_mod.stem(torch.zeros(1, 15, 16, 1), *p)
    with pytest.raises(ValueError, match="bfloat16"):
        down1_mod.down1(torch.zeros(1, 16, 16, 64), *p)
    with pytest.raises(ValueError, match="float32"):
        nms_mod.nms(torch.zeros(8, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        nms_mod.nms(torch.zeros(8, 8, device="meta"))
