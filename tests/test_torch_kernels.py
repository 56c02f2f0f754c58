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
from test_torch_threads import _one_thread  # noqa: F401  (autouse)


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


@pytest.mark.parametrize("iterations", [1, 2, 3, 4])
@pytest.mark.parametrize("radius", range(nms_mod.RADIUS_MAX + 1))
def test_nms_geometry_fits_and_covers_the_chain(radius, iterations):
    """The tile ``csrc/nms.cu`` is launched with: a core the kernel takes,
    the chain's receptive field as halo, float4-aligned rows of an odd
    number of 16-byte units, mask words over the tile, and shared memory
    within what a block may use."""
    g = nms_mod.geometry(radius, iterations)
    assert g.smem <= 232448
    assert g.halo == radius * (2 * iterations - 1)
    assert g.halo_w >= g.halo and g.halo_w % 4 == 0
    assert g.core_h >= 8 and g.core_w % 32 == 0
    assert (g.tile_h, g.tile_w) == (g.core_h + 2 * g.halo, g.core_w + 2 * g.halo_w)
    assert g.pitch >= g.tile_w and g.pitch % 8 == 4
    assert 32 * g.words >= g.tile_w > 32 * (g.words - 1)
    smem = 4 * (3 * (g.tile_h * g.pitch + 64) + 2 * g.tile_h * g.words)
    assert g.smem == smem
    if (radius, iterations) == (4, 3):  # the main path's: 64 × 128, double-buffered
        assert (g.core_h, g.core_w, g.smem) == (64, 128, 220416)


@pytest.mark.parametrize("radius,iterations", [(9, 1), (-1, 3), (4, 0), (8, 5)])
def test_nms_geometry_refuses_what_the_kernel_cannot_take(radius, iterations):
    """Raised by ``nms`` before any launch: a radius the kernel is not
    instantiated for, no iterations, or a chain whose tile does not fit."""
    with pytest.raises(ValueError, match="radius"):
        nms_mod.geometry(radius, iterations)


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


def _fp64_pair(x, w1, s1, b1, w2, s2, b2, pool):
    """The conv pair in fp64 with the kernels' bf16 roundings (input, weights,
    intermediate, output), independent of ``conv_pair_plain``'s fp32 convs."""
    import torch.nn.functional as F

    def conv(h, w, s, b):
        y = F.conv2d(h, w.double().permute(3, 2, 0, 1), padding=1)
        return torch.relu(y * s.double()[:, None, None] + b.double()[:, None, None])

    h = conv(x.to(torch.bfloat16).double().permute(0, 3, 1, 2), w1, s1, b1)
    h = conv(h.to(torch.bfloat16).double(), w2, s2, b2)
    if pool:
        h = F.max_pool2d(h, 2)
    return h.to(torch.bfloat16).permute(0, 2, 3, 1)


@pytest.mark.parametrize("B,H,W", [(1, 16, 16), (3, 16, 32), (1, 32, 48), (3, 48, 16)])
@pytest.mark.parametrize("pool", [True, False])
def test_stem_plain_matches_pallas_at_tile_multiples(B, H, W, pool):
    """One, two and three of the CUDA kernel's 16×16 tiles along either axis,
    B = 1 and 3 (the Pallas kernel takes multiples of 16 only)."""
    rng = np.random.default_rng(B * 1000 + H * 10 + W)
    x = rng.uniform(size=(B, H, W, 1)).astype(np.float32)
    p = _conv_bn(rng, 1) + _conv_bn(rng, 64)
    want = np.asarray(stem_pallas_packed(jnp.asarray(x), *map(jnp.asarray, p),
                                         pool=pool, interpret=True), np.float32)
    if not pool:
        want = want.reshape(B, H, W, 64)
    got = stem_mod.stem(torch.from_numpy(x), *_torch_params(p), pool=pool)
    assert got.shape == want.shape
    stem_mod.assert_bf16_close(got, torch.from_numpy(want))


@pytest.mark.parametrize("B,H,W,pool", [(1, 14, 14, True), (3, 16, 16, True), (1, 18, 18, True),
                                        (3, 14, 18, True), (1, 15, 17, False),
                                        (3, 17, 15, False)])
def test_stem_plain_matches_fp64_around_the_tile_size(B, H, W, pool):
    """H and W one under, at and one over the CUDA kernel's 16×16 tile (two
    under and over where the pool needs even sizes), which the Pallas kernel
    does not take: the plain version against the same function in fp64."""
    rng = np.random.default_rng(H * 100 + W + B)
    x = torch.from_numpy(rng.uniform(size=(B, H, W, 1)).astype(np.float32))
    p = _torch_params(_conv_bn(rng, 1) + _conv_bn(rng, 64))
    got = stem_mod.stem(x, *p, pool=pool)
    assert got.shape == ((B, H // 2, W // 2, 64) if pool else (B, H, W, 64))
    stem_mod.assert_bf16_close(got, _fp64_pair(x, *p, pool))


@pytest.mark.parametrize("B,H2,W2", [(1, 16, 16), (3, 16, 32), (1, 32, 48), (3, 48, 16)])
@pytest.mark.parametrize("pool", [True, False])
def test_down1_plain_matches_pallas_at_tile_multiples(B, H2, W2, pool):
    """One, two and three of the CUDA kernel's 16×16 tiles along either axis,
    B = 1 and 3 (the Pallas kernel takes H2 % 16 == 0 only)."""
    rng = np.random.default_rng(B * 1000 + H2 * 10 + W2 + 7)
    x = torch.from_numpy(rng.uniform(size=(B, H2, W2, 64)).astype(np.float32)).to(torch.bfloat16)
    p = _conv_bn(rng, 64) + _conv_bn(rng, 64)
    want = np.asarray(down1_pallas_packed(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                          *map(jnp.asarray, p), pool=pool, interpret=True),
                      np.float32)
    if not pool:
        want = want.reshape(B, H2, W2, 64)
    got = down1_mod.down1(x, *_torch_params(p), pool=pool)
    assert got.shape == want.shape
    stem_mod.assert_bf16_close(got, torch.from_numpy(want))


@pytest.mark.parametrize("B,H2,W2,pool", [(1, 14, 14, True), (3, 16, 16, True),
                                          (1, 18, 18, True), (3, 14, 18, True),
                                          (1, 15, 17, False), (3, 17, 15, False)])
def test_down1_plain_matches_fp64_around_the_tile_size(B, H2, W2, pool):
    """H2 and W2 one under, at and one over the CUDA kernel's 16×16 tile (two
    under and over where the pool needs even sizes), which the Pallas kernel
    does not take: the plain version against the same function in fp64."""
    rng = np.random.default_rng(H2 * 100 + W2 + B + 5)
    x = torch.from_numpy(rng.uniform(size=(B, H2, W2, 64)).astype(np.float32)).to(torch.bfloat16)
    p = _torch_params(_conv_bn(rng, 64) + _conv_bn(rng, 64))
    got = down1_mod.down1(x, *p, pool=pool)
    assert got.shape == ((B, H2 // 2, W2 // 2, 64) if pool else (B, H2, W2, 64))
    stem_mod.assert_bf16_close(got, _fp64_pair(x, *p, pool))


def test_swizzled_weight_images():
    """The weight images that ``stem.cu`` copies into shared memory: a
    permutation of the weights, element (tap, out, in) at the byte the
    kernel's header gives, undone by the same XOR."""
    rng = np.random.default_rng(11)
    w2 = torch.from_numpy(rng.normal(size=(3, 3, 64, 64)).astype(np.float32)).to(torch.bfloat16)
    image = stem_mod.swizzle_w2(w2)
    assert image.shape == (9 * 64 * 64,) and image.dtype == torch.bfloat16
    assert image.is_contiguous()
    k = stem_mod.kernel_layout(w2)  # [3, 3, out, in]
    assert torch.equal(k, w2.permute(0, 1, 3, 2))
    assert torch.equal(torch.sort(image.float())[0], torch.sort(w2.float().reshape(-1))[0])
    tap, n, kk = np.meshgrid(np.arange(9), np.arange(64), np.arange(64), indexing="ij")
    byte = tap * 8192 + n * 128 + (((kk >> 3) ^ (n & 7)) << 4) + (kk & 7) * 2
    assert torch.equal(image[torch.from_numpy(byte // 2)], k.reshape(9, 64, 64))
    back = stem_mod._xor_chunks(image.reshape(9, 64, 8, 8)).reshape(3, 3, 64, 64)
    assert torch.equal(back, w2.permute(0, 1, 3, 2))

    w1 = torch.from_numpy(rng.normal(size=(3, 3, 1, 64)).astype(np.float32)).to(torch.bfloat16)
    image1 = stem_mod.swizzle_w1(w1)
    assert image1.shape == (64 * 64,)
    rows = stem_mod._xor_chunks(image1.reshape(1, 64, 8, 8)).reshape(64, 64)
    assert torch.equal(rows[:, :9], w1.reshape(9, 64).t())  # row: channel, column: tap
    assert not rows[:, 9:].any()


def test_prepared_weights_equal_weights_per_call():
    """``prepare_stem`` / ``prepare_down1`` once and ``stem`` / ``down1`` with
    HWIO weights per call are the same function, and the prepared tensors are
    what the kernels read: the swizzled weight images, contiguous."""
    rng = np.random.default_rng(12)
    ps = _torch_params(_conv_bn(rng, 1) + _conv_bn(rng, 64))
    pd = _torch_params(_conv_bn(rng, 64) + _conv_bn(rng, 64))
    x = torch.from_numpy(rng.uniform(size=(2, 16, 24, 1)).astype(np.float32))
    prep_s, prep_d = stem_mod.prepare_stem(*ps), down1_mod.prepare_down1(*pd)
    for pool in (True, False):
        a = stem_mod.stem_prepared(x, prep_s, pool=pool)
        assert torch.equal(a, stem_mod.stem(x, *ps, pool=pool))
        assert torch.equal(down1_mod.down1_prepared(a, prep_d, pool=pool),
                           down1_mod.down1(a, *pd, pool=pool))
    assert all(t.is_contiguous() for t in prep_s.kernel + prep_d.kernel)
    assert torch.equal(prep_s.kernel[0], stem_mod.swizzle_w1(ps[0]))
    assert torch.equal(prep_s.kernel[3], stem_mod.swizzle_w2(ps[3]))
    assert torch.equal(prep_d.kernel[0], stem_mod.swizzle_w2(pd[0]))
    assert torch.equal(prep_d.kernel[3], stem_mod.swizzle_w2(pd[3]))
    for i in (1, 2, 4, 5):
        assert torch.equal(prep_s.kernel[i], ps[i]) and torch.equal(prep_d.kernel[i], pd[i])
    with pytest.raises(ValueError, match="w2"):
        stem_mod.prepare_stem(*ps[:3], ps[3].float(), *ps[4:])
    with pytest.raises(ValueError, match="one device"):
        stem_mod.stem_prepared(x.to("meta"), prep_s)


def test_fast_apply_prepares_the_kernel_weights_once():
    """``make_fast_apply`` lays the stem's and down1's weights out where it
    puts them on the device, not per call."""
    from ssp_torch.models import build_model
    from ssp_torch.models.fast_infer import _to_device, fold_variables

    model = build_model("SuperPointNet_gauss2", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    folded = fold_variables(model)
    dev = _to_device(folded, torch.device("cpu"))
    assert "inc0" not in dev and "d1a" not in dev
    assert torch.equal(dev["stem"].kernel[3], stem_mod.swizzle_w2(folded["inc1"][0]))
    assert torch.equal(dev["down1"].kernel[0], stem_mod.swizzle_w2(folded["d1a"][0]))
    assert torch.equal(dev["down1"].kernel[3], stem_mod.swizzle_w2(folded["d1b"][0]))
    assert all(torch.equal(a, b) for a, b in zip(dev["stem"].params,
                                                 (*folded["inc0"], *folded["inc1"])))
