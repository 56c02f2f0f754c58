"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up.)  Without a card
every test skips.

Bars: stem and down1 within ``ssp_torch.kernels.stem.assert_bf16_close``
(fp32 sums in another order flip bf16 roundings); NMS exact.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssp_torch.kernels import down1 as down1_mod
from ssp_torch.kernels import nms as nms_mod
from ssp_torch.kernels import stem as stem_mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(rng, cin, device):
    """Random conv pair weights (bf16 HWIO) with non-trivial folded BN."""
    out = []
    for c in (cin, 64):
        w = rng.normal(0, (2.0 / (9 * c)) ** 0.5, (3, 3, c, 64)).astype(np.float32)
        g, b = rng.normal(1, 0.2, 64), rng.normal(0, 0.2, 64)
        m, v = rng.normal(0, 0.2, 64), rng.uniform(0.5, 1.5, 64)
        s = (g / np.sqrt(v + 1e-5)).astype(np.float32)
        out += [torch.from_numpy(w).to(device, torch.bfloat16),
                torch.from_numpy(s).to(device),
                torch.from_numpy((b - m * s).astype(np.float32)).to(device)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(480, 640), (120, 168), (40, 56)])
@pytest.mark.parametrize("pool", [True, False])
def test_stem_kernel_matches_plain(cuda, hw, pool):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(size=(2, *hw, 1)).astype(np.float32)).to(cuda)
    p = _params(rng, 1, cuda)
    before = stem_mod.launches
    got = stem_mod.stem(x, *p, pool=pool)
    torch.cuda.synchronize()
    assert stem_mod.launches == before + 1
    stem_mod.assert_bf16_close(got, stem_mod.stem_plain(x, *p, pool=pool))


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(240, 320), (60, 84), (20, 28)])
@pytest.mark.parametrize("pool", [True, False])
def test_down1_kernel_matches_plain(cuda, hw, pool):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(size=(2, *hw, 64)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    p = _params(rng, 64, cuda)
    before = down1_mod.launches
    got = down1_mod.down1(x, *p, pool=pool)
    torch.cuda.synchronize()
    assert down1_mod.launches == before + 1
    stem_mod.assert_bf16_close(got, down1_mod.down1_plain(x, *p, pool=pool))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 480, 640), (3, 120, 168), (1, 37, 53)])
@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("border", [0, 4])
def test_nms_kernel_matches_plain_exactly(cuda, shape, radius, border):
    rng = np.random.default_rng(5)
    heat = torch.from_numpy((rng.uniform(size=shape) ** 4).astype(np.float32)).to(cuda)
    before = nms_mod.launches
    got = nms_mod.nms(heat, radius=radius, border=border)
    torch.cuda.synchronize()
    assert nms_mod.launches == before + 1
    assert torch.equal(got, nms_mod.nms_plain(heat, radius=radius, border=border))


@pytest.mark.cuda
def test_nms_kernel_exact_on_ties(cuda):
    """Plateaus of equal scores (a quantised heatmap) take every branch
    of the suppression rounds."""
    rng = np.random.default_rng(6)
    heat = torch.from_numpy(rng.integers(0, 4, size=(2, 96, 136)).astype(np.float32)).to(cuda)
    assert torch.equal(nms_mod.nms(heat, radius=4, border=4),
                       nms_mod.nms_plain(heat, radius=4, border=4))


def _fp64_pair(x, w1, s1, b1, w2, s2, b2, pool):
    """The conv pair in fp64 with the kernels' bf16 roundings (input,
    weights, intermediate, output): what both the kernel and its plain
    version approximate."""
    def conv(h, w, s, b):
        y = F.conv2d(h, w.double().permute(3, 2, 0, 1), padding=1)
        return torch.relu(y * s.double()[:, None, None] + b.double()[:, None, None])

    h = conv(x.to(torch.bfloat16).double().permute(0, 3, 1, 2), w1, s1, b1)
    h = conv(h.to(torch.bfloat16).double(), w2, s2, b2)
    if pool:
        h = F.max_pool2d(h, 2)
    return h.to(torch.bfloat16).permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("which", ["stem", "down1"])
def test_conv_kernels_near_fp64(cuda, which, pool):
    """Tensor cores do not add fp32 products in IEEE order, so the kernels
    flip some bf16 roundings; against fp64 they stay within the same bars
    as against their plain versions."""
    rng = np.random.default_rng(7)
    cin, hw = (1, (480, 640)) if which == "stem" else (64, (240, 320))
    x = torch.from_numpy(rng.uniform(size=(2, *hw, cin)).astype(np.float32)).to(cuda)
    p = _params(rng, cin, cuda)
    if which == "stem":
        got = stem_mod.stem(x, *p, pool=pool)
    else:
        got = down1_mod.down1(x.to(torch.bfloat16), *p, pool=pool)
    stem_mod.assert_bf16_close(got, _fp64_pair(x, *p, pool))
