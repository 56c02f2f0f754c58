"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up.)  Without a card
every test skips.

Bars: stem and down1 within ``ssp_torch.kernels.stem.assert_bf16_close``
(fp32 sums in another order flip bf16 roundings); NMS exact; the resample
kernels within 1e-6·max|img| of their plain versions and of an fp64 hat sum
(fp32 blends of two taps; the kernel may contract the blend to an FMA);
the folded convs' accumulators within 2⁻¹⁴·max|want| of an fp32 conv with
TF32 off; the cross-checked matcher (SIFT and ORB rows) exact.  The CUDA
graphs (``ssp_torch.graphs``): the HA group's replay equal to its eager call
and within the JAX package's one_dispatch bar of the staged group; three
replayed training steps (the flagship's, dense, accumulated and
SubpixelNet's) equal to three eager ones under
``torch.use_deterministic_algorithms`` (which needs cuBLAS's workspace
setting below before cuBLAS starts), and the flagship's without it.  The
ordered scatter-add exact.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from ssp_torch.kernels import down1 as down1_mod  # noqa: E402
from ssp_torch.kernels import nms as nms_mod  # noqa: E402
from ssp_torch.kernels import stem as stem_mod  # noqa: E402
from ssp_torch.kernels import vresample as vres_mod  # noqa: E402
from ssp_torch.kernels import warp_twopass  # noqa: E402


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
@pytest.mark.parametrize("shape,pool", [
    ((1, 16, 16), True),     # one tile: fewer tiles than the persistent grid has blocks
    ((3, 14, 18), True),     # one under and one over the 16x16 tile
    ((1, 18, 14), True),
    ((3, 15, 17), False),    # odd sizes, unpooled
    ((1, 17, 15), False),
    ((1, 2, 2), True),       # smaller than a tile's halo
    ((7, 112, 112), True),   # 343 tiles: no multiple of the grid
    ((100, 240, 320), True),  # the export path's chunk
    ((100, 240, 320), False),
])
def test_stem_kernel_edge_shapes_match_plain_and_fp64(cuda, shape, pool):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.uniform(size=(*shape, 1)).astype(np.float32)).to(cuda)
    p = _params(rng, 1, cuda)
    got = stem_mod.stem(x, *p, pool=pool)
    torch.cuda.synchronize()
    stem_mod.assert_bf16_close(got, stem_mod.stem_plain(x, *p, pool=pool))
    if x.numel() <= 7 * 112 * 112:  # fp64 convs of the large shapes take minutes
        stem_mod.assert_bf16_close(got, _fp64_pair(x, *p, pool))


@pytest.mark.cuda
def test_stem_kernel_launches_in_a_row_on_different_shapes(cuda):
    """Nothing of one launch (weights, buffers, barriers in shared memory) is
    left for the next: large, small, other weights, large again."""
    rng = np.random.default_rng(13)
    big = torch.from_numpy(rng.uniform(size=(4, 240, 320, 1)).astype(np.float32)).to(cuda)
    small = torch.from_numpy(rng.uniform(size=(1, 16, 16, 1)).astype(np.float32)).to(cuda)
    pa, pb = _params(rng, 1, cuda), _params(rng, 1, cuda)
    prep_a, prep_b = stem_mod.prepare_stem(*pa), stem_mod.prepare_stem(*pb)
    outs = [stem_mod.stem_prepared(big, prep_a), stem_mod.stem_prepared(small, prep_b),
            stem_mod.stem_prepared(small, prep_a, pool=False),
            stem_mod.stem_prepared(big, prep_b), stem_mod.stem_prepared(big, prep_a)]
    torch.cuda.synchronize()
    stem_mod.assert_bf16_close(outs[0], stem_mod.stem_plain(big, *pa))
    stem_mod.assert_bf16_close(outs[1], stem_mod.stem_plain(small, *pb))
    stem_mod.assert_bf16_close(outs[2], stem_mod.stem_plain(small, *pa, pool=False))
    stem_mod.assert_bf16_close(outs[3], stem_mod.stem_plain(big, *pb))
    assert torch.equal(outs[4], outs[0])  # the same launch twice: the same bits


@pytest.mark.cuda
def test_prepared_weights_equal_weights_per_call_on_the_card(cuda):
    rng = np.random.default_rng(14)
    ps, pd = _params(rng, 1, cuda), _params(rng, 64, cuda)
    x = torch.from_numpy(rng.uniform(size=(2, 120, 168, 1)).astype(np.float32)).to(cuda)
    before = stem_mod.launches, down1_mod.launches
    a = stem_mod.stem_prepared(x, stem_mod.prepare_stem(*ps))
    b = down1_mod.down1_prepared(a, down1_mod.prepare_down1(*pd))
    assert (stem_mod.launches, down1_mod.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(a, stem_mod.stem(x, *ps))
    assert torch.equal(b, down1_mod.down1(a, *pd))


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
@pytest.mark.parametrize("shape,pool", [
    ((1, 16, 16), True),     # one tile: fewer tiles than the persistent grid has blocks
    ((3, 14, 18), True),     # one under and one over the 16x16 tile
    ((1, 18, 14), True),
    ((3, 15, 17), False),    # odd sizes, unpooled
    ((1, 17, 15), False),
    ((1, 2, 2), True),       # smaller than a tile's halo
    ((7, 56, 56), True),     # 112 tiles, ragged on both axes: no multiple of the grid
    ((100, 120, 160), True),  # the export path's chunk
    ((100, 120, 160), False),
])
def test_down1_kernel_edge_shapes_match_plain_and_fp64(cuda, shape, pool):
    rng = np.random.default_rng(sum(shape) + 1)
    x = torch.from_numpy(rng.uniform(size=(*shape, 64)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    p = _params(rng, 64, cuda)
    before = down1_mod.launches
    got = down1_mod.down1(x, *p, pool=pool)
    torch.cuda.synchronize()
    assert down1_mod.launches == before + 1
    stem_mod.assert_bf16_close(got, down1_mod.down1_plain(x, *p, pool=pool))
    if x[..., 0].numel() <= 7 * 56 * 56:  # fp64 convs of the large shapes take minutes
        stem_mod.assert_bf16_close(got, _fp64_pair(x, *p, pool))


@pytest.mark.cuda
def test_down1_kernel_launches_in_a_row_on_different_shapes(cuda):
    """Nothing of one call (weights, buffers, barriers in shared memory, the
    intermediate) is left for the next: large, small, other weights, large
    again."""
    rng = np.random.default_rng(16)
    big = torch.from_numpy(rng.uniform(size=(4, 120, 160, 64)).astype(np.float32))
    big = big.to(cuda, torch.bfloat16)
    small = torch.from_numpy(rng.uniform(size=(1, 16, 16, 64)).astype(np.float32))
    small = small.to(cuda, torch.bfloat16)
    pa, pb = _params(rng, 64, cuda), _params(rng, 64, cuda)
    prep_a, prep_b = down1_mod.prepare_down1(*pa), down1_mod.prepare_down1(*pb)
    outs = [down1_mod.down1_prepared(big, prep_a), down1_mod.down1_prepared(small, prep_b),
            down1_mod.down1_prepared(small, prep_a, pool=False),
            down1_mod.down1_prepared(big, prep_b), down1_mod.down1_prepared(big, prep_a)]
    torch.cuda.synchronize()
    stem_mod.assert_bf16_close(outs[0], down1_mod.down1_plain(big, *pa))
    stem_mod.assert_bf16_close(outs[1], down1_mod.down1_plain(small, *pb))
    stem_mod.assert_bf16_close(outs[2], down1_mod.down1_plain(small, *pa, pool=False))
    stem_mod.assert_bf16_close(outs[3], down1_mod.down1_plain(big, *pb))
    assert torch.equal(outs[4], outs[0])  # the same call twice: the same bits


def _heat(kind, shape, seed=5):
    """A heatmap of one kind: uniform**4 (what a softmax leaves), all zero,
    constant, quantised plateaus (every branch of the suppression rounds)
    or normal (negative scores too)."""
    rng = np.random.default_rng(seed)
    return {"pow4": lambda: rng.uniform(size=shape) ** 4,
            "zeros": lambda: np.zeros(shape),
            "const": lambda: np.full(shape, 0.25),
            "plateaus": lambda: rng.integers(0, 4, size=shape),
            "normal": lambda: rng.normal(size=shape)}[kind]().astype(np.float32)


_NMS_CASES = (
    # shape, radius, iterations, border, heatmap
    [(shape, r, 3, b, "pow4") for shape in [(2, 480, 640), (3, 120, 168), (1, 37, 53)]
     for r in (2, 4) for b in (0, 4)]
    # widths at the 32-bit mask words' edges; W % 4 != 0 takes 4-byte copies
    + [((1, 40, w), 4, 3, 4, "pow4") for w in (31, 32, 33, 63, 65, 127, 129, 168, 320, 640)]
    + [((2, 17, 70), 4, 3, 4, "pow4"),      # fewer rows than the halo
       ((2, 45, 77), 1, 1, 0, "pow4"), ((2, 45, 77), 1, 2, 0, "pow4"),
       ((2, 45, 77), 1, 3, 4, "pow4"), ((2, 45, 77), 2, 1, 4, "pow4"),
       ((2, 45, 77), 2, 2, 0, "pow4"), ((2, 45, 77), 4, 1, 4, "pow4"),
       ((2, 45, 77), 4, 2, 0, "pow4"),
       ((1, 33, 40), 0, 2, 3, "pow4"), ((1, 60, 90), 8, 1, 0, "pow4"),
       ((1, 60, 90), 8, 4, 2, "plateaus"),  # the smallest core, 8 × 32
       ((1, 30, 50), 4, 3, 16, "pow4"),     # border over H/2: all zero
       ((16, 96, 136), 4, 3, 4, "pow4"), ((16, 480, 640), 4, 3, 4, "pow4"),
       ((1, 240, 320), 4, 3, 4, "pow4")]
    + [((2, 96, 136), 4, 3, 4, kind) for kind in ("zeros", "const", "plateaus", "normal")]
    + [((2, 95, 131), 2, 3, 0, kind) for kind in ("plateaus", "normal")])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius,iterations,border,kind", _NMS_CASES)
def test_nms_kernel_matches_plain_exactly(cuda, shape, radius, iterations, border, kind):
    heat = torch.from_numpy(_heat(kind, shape)).to(cuda)
    before = nms_mod.launches
    got = nms_mod.nms(heat, radius=radius, iterations=iterations, border=border)
    torch.cuda.synchronize()
    assert nms_mod.launches == before + 1
    assert torch.equal(got, nms_mod.nms_plain(heat, radius=radius, iterations=iterations,
                                              border=border))


@pytest.mark.cuda
def test_nms_kernel_exact_on_ties(cuda):
    """Plateaus of equal scores (a quantised heatmap) take every branch
    of the suppression rounds."""
    rng = np.random.default_rng(6)
    heat = torch.from_numpy(rng.integers(0, 4, size=(2, 96, 136)).astype(np.float32)).to(cuda)
    assert torch.equal(nms_mod.nms(heat, radius=4, border=4),
                       nms_mod.nms_plain(heat, radius=4, border=4))


@pytest.mark.cuda
def test_nms_kernel_launches_in_a_row_on_different_shapes(cuda):
    """Nothing a persistent block carries from tile to tile (the masks, the
    buffer of the next tile) leaks into the next launch: large, small,
    another radius, large again."""
    big = torch.from_numpy(_heat("pow4", (4, 240, 320), seed=17)).to(cuda)
    small = torch.from_numpy(_heat("plateaus", (1, 37, 53), seed=18)).to(cuda)
    calls = [(big, 4, 3, 4), (small, 4, 3, 0), (small, 2, 2, 1), (big, 4, 3, 4)]
    outs = [nms_mod.nms(h, radius=r, iterations=i, border=b) for h, r, i, b in calls]
    torch.cuda.synchronize()
    for out, (h, r, i, b) in zip(outs, calls):
        assert torch.equal(out, nms_mod.nms_plain(h, radius=r, iterations=i, border=b))
    assert torch.equal(outs[3], outs[0])


@pytest.mark.cuda
def test_nms_kernel_unfit_radius_raises_before_a_launch(cuda):
    heat = torch.zeros(1, 32, 32, device=cuda)
    before = nms_mod.launches
    for radius, iterations in ((nms_mod.RADIUS_MAX + 1, 1), (8, 5)):
        with pytest.raises(ValueError, match="radius"):
            nms_mod.nms(heat, radius=radius, iterations=iterations)
    assert nms_mod.launches == before


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


def _coords(rng, shape, L):
    """Coordinates over and beyond [0, L − 1], with the cases no int can
    hold, the kill value, and a row exactly at L − 1."""
    c = rng.uniform(-3, L + 2, size=shape).astype(np.float32)
    c.reshape(-1)[:8] = [-10.0, 1e9, -1e9, L - 1.0, np.inf, -np.inf, np.nan, -1.0]
    return c


def _hat_fp64(img, coords, axis):
    """Σ_i max(0, 1 − |r − i|)·img[i] along ``axis`` in fp64, NaN → 0."""
    L = img.shape[1 + axis]
    i = torch.arange(L, device=img.device, dtype=torch.float64)
    r = torch.nan_to_num(coords.double(), nan=-10.0, posinf=1e12, neginf=-1e12)
    w = (1.0 - (r[..., None] - i).abs()).clamp(min=0.0)  # [N, Ro, Co, L]
    per = coords.shape[0] // img.shape[0]
    src = img.double().repeat_interleave(per, dim=0)
    if axis == 0:
        return torch.einsum("noxi,nix->nox", w, src)
    return torch.einsum("nyoi,nyi->nyo", w, src)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n_imgs,n_warps,hw", [(1, 6, (96, 96)), (6, 6, (64, 64)),
                                               (2, 6, (40, 56)), (1, 3, (120, 168))])
def test_vresample_kernel_matches_plain_and_fp64(cuda, axis, n_imgs, n_warps, hw):
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.uniform(size=(n_imgs, *hw)).astype(np.float32)).to(cuda)
    coords = torch.from_numpy(_coords(rng, (n_warps, *hw), hw[axis])).to(cuda)
    before = vres_mod.launches
    got = vres_mod.vresample(img, coords, axis=axis)
    torch.cuda.synchronize()
    assert vres_mod.launches == before + 1
    assert bool(torch.isfinite(got).all())
    want = vres_mod.vresample_plain(img, coords, axis=axis)
    tol = 1e-6 * float(img.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert float((got.double() - _hat_fp64(img, coords, axis)).abs().max()) <= tol
    assert float(got.reshape(-1)[:8].abs().max()) <= 1.0  # the planted cases: 0 or one tap


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n_imgs,hw", [(1, (96, 96)), (5, (64, 64)), (1, (40, 56))])
def test_vresample_coef_kernel_matches_plain(cuda, axis, n_imgs, hw):
    """The kernel's coordinate arithmetic is rounded operation by operation,
    as the plain version's tensor ops are, so the two agree to the blend's
    last bit even next to the kill test's boundary."""
    rng = np.random.default_rng(9)
    N, S = 5, max(hw)
    img = torch.from_numpy(rng.uniform(size=(n_imgs, *hw)).astype(np.float32)).to(cuda)
    Hm = torch.from_numpy((np.eye(3) + rng.normal(0, 0.1, (N, 3, 3))).astype(np.float32))
    coefs = warp_twopass._pass_coefs(Hm, 2.0, hw[0] - 3.0, 1.0, hw[1] - 2.0, S)[axis].to(cuda)
    before = vres_mod.coef_launches
    got = vres_mod.vresample_coef(img, coefs, axis=axis)
    torch.cuda.synchronize()
    assert vres_mod.coef_launches == before + 1
    want = vres_mod.vresample_coef_plain(img, coefs, axis=axis)
    assert 0.05 < float((want != 0).float().mean())
    assert float((got - want).abs().max()) <= 1e-6 * float(img.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("bounds", [(10.0, 10.0, 0.0, 1e4), (0.0, 1e4, 50.0, 50.0),
                                    (31.0, 32.0, 0.0, 1e4), (0.0, 1e4, 64.0, 65.0),
                                    (40.0, 80.0, 20.0, 70.0), (float("nan"), 1e4, 0.0, 1e4)],
                         ids=["empty_along_axis", "empty_along_line", "one_row", "one_column",
                              "cuts_tiles_in_two", "nan_bound"])
@pytest.mark.parametrize("n_imgs,hw", [(1, (96, 96)), (3, (100, 70)), (1, (40, 136))])
def test_vresample_coef_kernel_keep_bounds_and_rectangles(cuda, axis, bounds, n_imgs, hw):
    """Keep bounds that are empty, one row or column wide, across the kernel's
    64×64 tiles, or NaN (nothing kept); sizes that are no multiple of the tile,
    square and not; shared and per-warp images."""
    rng = np.random.default_rng(15)
    N, S = 6, max(hw)
    img = torch.from_numpy(rng.uniform(size=(n_imgs, *hw)).astype(np.float32)).to(cuda)
    Hm = torch.from_numpy((np.eye(3) + rng.normal(0, 0.1, (N, 3, 3))).astype(np.float32))
    coefs = warp_twopass._pass_coefs(Hm, 0.0, 1e4, 0.0, 1e4, S)[axis].clone()
    coefs[:, 16:] = torch.tensor(bounds)
    coefs = coefs.to(cuda)
    got = vres_mod.vresample_coef(img, coefs, axis=axis)
    torch.cuda.synchronize()
    want = vres_mod.vresample_coef_plain(img, coefs, axis=axis)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-6 * float(img.abs().max())
    o = torch.arange(hw[axis], device=cuda, dtype=torch.float32)
    line = torch.arange(hw[1 - axis], device=cuda, dtype=torch.float32)
    kept = ((o >= bounds[0]) & (o < bounds[1]))[:, None] & ((line >= bounds[2])
                                                            & (line < bounds[3]))[None, :]
    kept = kept if axis == 0 else kept.t()
    assert not bool(got[:, ~kept].any())


@pytest.mark.cuda
@pytest.mark.parametrize("coef", [False, True], ids=["rows", "coef"])
def test_twopass_warp_on_card_matches_cpu(cuda, coef, monkeypatch):
    """The whole two-pass warp at an odd rectangular size, all four rotation
    buckets, kernels on the card against the plain versions on the CPU:
    1e-4 (the coordinate grids are built by tensor ops on two devices, whose
    divisions and ``linspace`` may differ in the last bit, times a slope of
    up to 1 per pixel)."""
    rng = np.random.default_rng(10)
    img = torch.from_numpy(rng.uniform(size=(120, 168)).astype(np.float32))
    Hs = []
    for ang in (-170.0, -95.0, 10.0, 80.0):
        a = np.radians(ang)
        Hm = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
        Hm[:2, 2] = rng.uniform(-0.2, 0.2, 2)
        Hm[2, :2] = rng.uniform(-0.05, 0.05, 2)
        Hs.append(Hm)
    Hs = torch.from_numpy(np.stack(Hs).astype(np.float32))
    monkeypatch.setattr(warp_twopass, "COEF_GRIDS", coef)
    want = warp_twopass.inv_warp_image_twopass(img, Hs)
    got = warp_twopass.inv_warp_image_twopass(img.to(cuda), Hs)        # Hm on the host
    got_dev = warp_twopass.inv_warp_image_twopass(img.to(cuda), Hs.to(cuda))
    assert got.shape == (4, 120, 168) and float(want.abs().mean()) > 0.05
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert float((got_dev.cpu() - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("image_shape", [(16, 480, 640), (100, 240, 320), (2, 120, 168)])
def test_folded_convs_keep_the_fp32_accumulator(cuda, image_shape):
    """down2, down3 and the heads: the epilogue reads an fp32 accumulator
    that was never rounded to bf16 (that would miss this bar by a factor of
    about 30; another summation order does not)."""
    from ssp_torch.models import build_model
    from ssp_torch.models.fast_infer import accumulator_errors

    model = build_model("SuperPointNet_gauss2_ssmall", device=cuda,
                        generator=torch.Generator().manual_seed(0))
    errors = accumulator_errors(model, image_shape, device=cuda)
    assert set(errors) == {"d2a", "d2b", "d3a", "d3b", "pa", "pb", "da", "db", "ds"}
    assert max(errors.values()) <= 2.0 ** -14, errors


@pytest.mark.cuda
@pytest.mark.parametrize("radius,border", [(4, 4), (4, 0), (2, 4)])
def test_extract_keypoints_launches_the_nms_kernel(cuda, radius, border, monkeypatch):
    """``extract_keypoints`` on a CUDA tensor suppresses through the NMS
    kernel (one launch for all leading dimensions), never through the plain
    max-pool chain, and gives exactly what the plain chain gives; so does
    ``SuperPointProcess.heatmap_to_nms``."""
    import ssp_torch.postprocess.nms as post_nms
    from ssp_torch.postprocess.points import extract_keypoints, top_k
    from ssp_torch.postprocess.process import SuperPointProcess

    heat = torch.from_numpy(_heat("pow4", (2, 3, 64, 96), seed=21)).to(cuda)
    heat[0, 1, 10:14, 20:24] = 0.5  # a plateau of ties
    want_nms = nms_mod.nms_plain(heat.reshape(6, 64, 96), radius=radius, border=border)
    scores, idx = top_k(want_nms.reshape(2, 3, -1), 50)
    want = torch.stack([(idx % 96).float(), (idx // 96).float(), scores], dim=-1)
    want_process = nms_mod.nms_plain(heat[0], radius=radius)

    def plain_chain(*args, **kwargs):
        raise AssertionError("the plain max-pool chain ran on a CUDA tensor")

    monkeypatch.setattr(post_nms, "simple_nms", plain_chain)
    before = nms_mod.launches
    pts, valid = extract_keypoints(heat, k=50, nms_radius=radius, border=border)
    suppressed = SuperPointProcess(nms_dist=radius).heatmap_to_nms(heat[0])
    torch.cuda.synchronize()
    assert nms_mod.launches == before + 2
    assert pts.shape == (2, 3, 50, 3) and torch.equal(pts, want)
    assert torch.equal(valid, scores >= 0.015)
    assert torch.equal(suppressed, want_process)


@pytest.mark.cuda
def test_descriptor_export_on_the_card_matches_plain_versions(cuda, tmp_path):
    """``make_detect_describe_fn`` on the card against the same function on
    the kernels' plain versions (``reference=True``), with the trained
    weights at 240×320: one launch of the stem, of down1 and of NMS per
    image; the bars of ``chip_smoke.py``'s main path (≥ 90% of the valid
    points shared within 0.5 px, cosine ≥ 0.999); the npz files written by
    ``run_descriptor_export`` carry the same keys and point counts within
    the same bar."""
    from pathlib import Path

    from ssp_torch.bench import structured_images
    from ssp_torch.export import make_detect_describe_fn, run_descriptor_export
    from ssp_torch.models.fast_infer import best_apply_fn, make_fast_apply
    from ssp_torch.models.weights import load_flax_npz

    npz = Path(__file__).resolve().parents[1] / "evidence" / "wsem_weights.npz"
    model = load_flax_npz(npz, "SuperPointNet_gauss2_ssmall", device=cuda)
    fn = make_detect_describe_fn(best_apply_fn(model, input_hw=(240, 320), device=cuda),
                                 device=cuda)
    plain = make_detect_describe_fn(make_fast_apply(model, device=cuda, reference=True),
                                    device=cuda, reference=True)
    images = structured_images(4, 240, 320, 31)[..., 0]
    before = (stem_mod.launches, down1_mod.launches, nms_mod.launches)
    outs = [fn(img) for img in images]
    torch.cuda.synchronize()
    after = (stem_mod.launches, down1_mod.launches, nms_mod.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (4, 4, 4)
    for img, (pts, valid, desc) in zip(images, outs):
        ref_pts, ref_valid, ref_desc = plain(img)
        a, r = pts[valid], ref_pts[ref_valid]
        assert len(r) > 20 and torch.isfinite(desc).all()
        dist = torch.cdist(a[:, :2], r[:, :2], p=float("inf"))
        near = dist.min(dim=1)
        paired = near.values <= 0.5
        assert int(paired.sum()) >= 0.9 * max(len(a), len(r))
        cos = (desc[valid][paired] * ref_desc[ref_valid][near.indices[paired]]).sum(-1)
        assert float(cos.min()) >= 0.999
    pairs = [{"image": images[i], "warped_image": images[i + 1], "homography": np.eye(3)}
             for i in (0, 2)]
    assert run_descriptor_export(fn, pairs, tmp_path / "card") == 2
    assert run_descriptor_export(plain, pairs, tmp_path / "plain") == 2
    for i in range(2):
        with np.load(tmp_path / "card" / f"{i}.npz") as a, \
                np.load(tmp_path / "plain" / f"{i}.npz") as b:
            assert set(a.files) == set(b.files)
            assert abs(len(a["prob"]) - len(b["prob"])) <= 0.1 * len(b["prob"])


@pytest.mark.cuda
def test_magicleap_forward_on_the_card_matches_the_cpu(cuda):
    """``SuperPointNet_pretrained`` with seeded weights at 1×240×320: the
    module on the card (TF32 off) against the same module on the CPU, atol
    2e-4 on ``semi`` and ``desc``."""
    from ssp_torch.models.superpoint import build_model

    model = build_model("SuperPointNet_pretrained", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(4).uniform(size=(1, 240, 320, 1))
                         .astype(np.float32))
    with torch.no_grad():
        want = model(x)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            got = model.to(cuda)(x.to(cuda))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    for key in ("semi", "desc"):
        assert float((got[key].cpu() - want[key]).abs().max()) <= 2e-4, key


@pytest.mark.cuda
def test_sweep_of_one_checkpoint_on_the_card(cuda, tmp_path, monkeypatch):
    """``ssp_torch.cli.export_eval.sweep`` on the card over one flax npz
    checkpoint (the trained weights) and a tree of two sequences with two
    views each: the stem, down1 and NMS kernels launch twice per pair, no
    resample kernel does, and the row is scored."""
    import csv
    import shutil
    from pathlib import Path

    from ssp_torch.bench import structured_images
    from ssp_torch.cli.export_eval import CSV_FIELDS, sweep
    from ssp_torch.data.base import write_pnm

    root = Path(__file__).resolve().parents[1]
    for s in range(2):
        seq = tmp_path / "hp" / f"v_seq{s}"
        seq.mkdir(parents=True)
        base = (structured_images(1, 240, 320, 40 + s)[0, ..., 0] * 255).astype(np.uint8)
        write_pnm(seq / "1.ppm", np.repeat(base[..., None], 3, -1))
        for i, (dx, dy) in ((2, (3, 2)), (3, (-4, 5))):
            view = np.roll(base, (dy, dx), (0, 1))
            write_pnm(seq / f"{i}.ppm", np.repeat(view[..., None], 3, -1))
            np.savetxt(seq / f"H_1_{i}", np.array([[1.0, 0, dx], [0, 1, dy], [0, 0, 1]]))
    (tmp_path / "ckpts").mkdir()
    shutil.copy(root / "evidence" / "wsem_weights.npz",
                tmp_path / "ckpts" / "superPointNet_1000.npz")
    config = {"data": {"name": "patches_dataset", "dataset": "hpatches", "alteration": "all",
                       "root": str(tmp_path / "hp"), "preprocessing": {"resize": [240, 320]}},
              "model": {"name": "SuperPointNet_gauss2_ssmall", "params": {"n_classes": 133},
                        "folder": str(tmp_path / "ckpts"), "detection_threshold": 0.015,
                        "nms": 4, "top_k": 1000, "nn_thresh": 1.0,
                        "subpixel": {"enable": True, "patch_size": 5}}}
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "logs"))
    counts = (stem_mod, down1_mod, nms_mod)
    before = [m.launches for m in counts] + [vres_mod.launches, vres_mod.coef_launches]
    csv_path = sweep(config, "card", device=cuda)
    torch.cuda.synchronize()
    after = [m.launches for m in counts] + [vres_mod.launches, vres_mod.coef_launches]
    assert [a - b for a, b in zip(after, before)] == [8, 8, 8, 0, 0]
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == CSV_FIELDS and rows[0]["iter"] == "1000"
    assert float(rows[0]["repeatability"]) > 0 and float(rows[0]["correctness_50"]) > 0


def _train_batch(device, n=4, hw=(64, 96), seed=0):
    """A prepared warped-pair batch on ``device`` (gather warp on the CPU,
    moved over, so both devices see the same numbers)."""
    from ssp_torch.data.pipeline import prepare_batch

    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    batch = prepare_batch(torch.from_numpy(rng.uniform(size=(n, *hw)).astype(np.float32)),
                          torch.from_numpy(rng.uniform(0, 60, (n, 40, 2)).astype(np.float32)),
                          torch.ones(n, 40, dtype=torch.bool), generator=g, host_generator=g,
                          warped_pair={"enable": True, "params": {}})
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.cuda
def test_dense_and_accumulated_steps_on_the_card_match_the_cpu(cuda):
    """One dense-loss step and one accumulated (r = 2) step of gauss2 at fp32
    with TF32 off, on the card against the CPU from the same weights: every
    metric within rel 1e-3 (fp32 sums in another order through a forward
    and a backward)."""
    from ssp_torch.models.superpoint import build_model
    from ssp_torch.train import TrainState, accum_train_step, train_step

    kw = dict(semantic=False, warped_pair=True, desc_loss="dense",
              desc_params={"lambda_d": 800, "descriptor_dist": 4}, multi_task=True)
    cpu_batch = _train_batch(torch.device("cpu"))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for step in (lambda st, b: train_step(st, b, **kw),
                     lambda st, b: accum_train_step(st, b, 2, **kw)):
            got = {}
            for dev in (torch.device("cpu"), cuda):
                model = build_model("SuperPointNet_gauss2", device=dev,
                                    generator=torch.Generator().manual_seed(0))
                st = TrainState.create(model.train(), max_steps=10)
                got[dev.type] = {k: float(v) for k, v in
                                 step(st, {k: v.to(dev) for k, v in cpu_batch.items()}).items()}
            for k, v in got["cpu"].items():
                assert abs(got["cuda"][k] - v) <= 1e-3 * max(abs(v), 1e-6), (k, got)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
def test_subpixel_net_and_agents_on_the_card(cuda):
    """SubpixelNet's fp32 forward on the card (TF32 off) within 2e-4 of the
    CPU's; one subpixel train step on the card finite; ``refine_points``
    adds the offsets read on the card."""
    from ssp_torch.models.superpoint import build_model
    from ssp_torch.train import TrainState
    from ssp_torch.train.subpixel_agent import SubpixelValAgent, subpixel_train_step

    model = build_model("SubpixelNet", device="cpu", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(5).uniform(size=(2, 64, 96, 1))
                         .astype(np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = model(x)
            got = model.to(cuda)(x.to(cuda))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for k in ("semi", "desc", "subpixel"):
        assert float((got[k].cpu() - want[k]).abs().max()) <= 2e-4, k
    st = TrainState.create(model.train(), max_steps=10)
    metrics = subpixel_train_step(st, _train_batch(cuda, n=2))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    agent = SubpixelValAgent(model, device=cuda)
    pts = torch.tensor([[[10.0, 20.0, 0.5], [95.0, 63.0, 0.9]]] * 2)
    off = agent.run(x)["subpixel"]
    refined = agent.refine_points(x, pts)
    torch.testing.assert_close(refined[0, 0, :2].cpu(), pts[0, 0, :2] + off[0, 20, 10].cpu())


@pytest.mark.cuda
def test_val_agent_launches_the_kernels_once_per_image(cuda):
    """``Val_model_heatmap`` on the trained weights at 240×320: the stem,
    down1 and NMS kernels launch once per image, and its points and
    descriptors agree with the same agent on the plain versions (at least
    90% of the points at the same pixel, cosine ≥ 0.999 where shared)."""
    from pathlib import Path

    from ssp_torch.bench import structured_images
    from ssp_torch.train.val_agent import ValAgent

    npz = Path(__file__).resolve().parents[1] / "evidence" / "wsem_weights.npz"
    cfg = {"model": {"name": "SuperPointNet_gauss2_ssmall", "params": {"n_classes": 133},
                     "nms": 4, "top_k": 1000, "detection_threshold": 0.015},
           "pretrained": str(npz)}
    agent = ValAgent(cfg, device=cuda)
    plain = ValAgent(cfg, device=cuda, reference=True)
    counts = (stem_mod, down1_mod, nms_mod)
    for img in structured_images(2, 240, 320, 7)[..., 0]:
        before = [m.launches for m in counts]
        agent.run(img)
        assert [m.launches - b for m, b in zip(counts, before)] == [1, 1, 1]
        plain.run(img)
        got = {tuple(p[:2]): i for i, p in enumerate(agent.heatmap_to_pts().tolist())}
        want = {tuple(p[:2]): i for i, p in enumerate(plain.heatmap_to_pts().tolist())}
        shared = set(got) & set(want)
        assert len(shared) >= 0.9 * max(len(got), len(want)) > 0
        d, dp = agent.desc_to_sparse_desc(), plain.desc_to_sparse_desc()
        cos = [float(d[got[k]] @ dp[want[k]]) for k in shared]
        assert min(cos) >= 0.999


def _match_inputs(rng, nq, nt, hamming, levels):
    """Descriptor rows with ties: few distinct values per entry (SIFT) or
    masked bits (ORB), planted duplicate rows on both sides and rows shared
    by the two sides."""
    if hamming:
        q = rng.integers(0, 256, (nq, 32), dtype=np.uint8) & np.uint8(levels)
        t = rng.integers(0, 256, (nt, 32), dtype=np.uint8) & np.uint8(levels)
    else:
        step = 255 // (levels - 1)
        q = (rng.integers(0, levels, (nq, 128)) * step).astype(np.float32)
        t = (rng.integers(0, levels, (nt, 128)) * step).astype(np.float32)
    n = min(nq, nt, 7)
    t[:n] = q[:n]
    if nt > 12:
        t[8:11] = t[7]
    if nq > 12:
        q[8:11] = q[7]
    return torch.from_numpy(q), torch.from_numpy(t)


@pytest.mark.cuda
@pytest.mark.parametrize("hamming", [False, True])
def test_bfmatch_kernel_equals_plain_version(cuda, hamming):
    """The cross-checked matcher, exactly: ties to the lowest index, odd row
    counts (partial tiles), one row, 1000 x 1000 rows of 0..255."""
    from ssp_torch.kernels import bfmatch

    rng = np.random.default_rng(int(hamming))
    cases = [_match_inputs(rng, nq, nt, hamming, lv)
             for nq, nt, lv in ((1, 1, 3), (1, 70, 2), (65, 1, 4), (131, 97, 3), (300, 257, 8),
                                (64, 64, 255 if hamming else 2))]
    full = rng.integers(0, 256, (2, 1000, 32 if hamming else 128))
    dtype = np.uint8 if hamming else np.float32
    cases.append((torch.from_numpy(full[0].astype(dtype)), torch.from_numpy(full[1].astype(dtype))))
    for q, t in cases:
        before = bfmatch.launches
        got = bfmatch.bfmatch(q.to(cuda), t.to(cuda))
        assert bfmatch.launches == before + 1
        want = bfmatch.bfmatch_plain(q.to(cuda), t.to(cuda))
        assert torch.equal(got, want), (q.shape, t.shape)
        assert torch.equal(got.cpu(), bfmatch.bfmatch_plain(q, t)), (q.shape, t.shape)
        assert len(got) > 0


@pytest.mark.cuda
def test_bfmatch_kernel_edges(cuda):
    from ssp_torch.kernels import bfmatch

    q = torch.full((3, 128), 7.0, device=cuda)
    before = bfmatch.launches
    assert bfmatch.bfmatch(q[:0], q).shape == (0, 3) and bfmatch.bfmatch(q, q[:0]).shape == (0, 3)
    assert bfmatch.launches == before  # nothing to match: no launch
    bad = q.clone()
    bad[1, 3] = 0.5
    with pytest.raises(ValueError, match="integers in"):
        bfmatch.bfmatch(q, bad)
    # three equal rows on each side: query 0 takes train 0, the others none
    np.testing.assert_array_equal(bfmatch.bfmatch(q, q).cpu().numpy(), [[0.0, 0.0, 0.0]])


@pytest.mark.cuda
def test_ha_one_dispatch_graph_on_the_card(cuda):
    """The HA group (2×64×96, 20 warps, chunk 10: five warps of each image per
    chunk) as one CUDA graph: its replay equal bit for bit to an eager call of
    the same chain on the same inputs, and against the staged group on the
    same homographies valid equal, points within 1e-4 (the JAX package's bar
    for its two modes)."""
    from pathlib import Path

    from ssp_torch.bench import structured_images
    from ssp_torch.export import make_ha_fn
    from ssp_torch.models.fast_infer import best_apply_fn
    from ssp_torch.models.weights import load_flax_npz

    npz = Path(__file__).resolve().parents[1] / "evidence" / "wsem_weights.npz"
    model = load_flax_npz(npz, "SuperPointNet_gauss2", device=cuda)
    apply_fn = best_apply_fn(model, input_hw=(64, 96), device=cuda)
    common = dict(device=cuda, num_h=20, chunk=10, top_k=100, subpixel=True)
    images = torch.from_numpy(structured_images(2, 64, 96, 9)[..., 0]).to(cuda)

    def gens():
        return [torch.Generator().manual_seed(40 + g) for g in range(2)]

    graphed = make_ha_fn(apply_fn, one_dispatch=True, **common)
    pts, valid = graphed(images, generator=gens())
    region = graphed.regions[(2, 64, 96)]
    assert region.graph is not None and region.replays == 1
    assert region.launches_per_replay["vresample_coef"] == 2 + 2 * 4
    eager_pts, eager_valid = region.eager()
    assert torch.equal(pts, eager_pts) and torch.equal(valid, eager_valid)
    want_pts, want_valid = make_ha_fn(apply_fn, **common)(images, generator=gens())
    assert valid.sum() >= 10 and torch.equal(valid, want_valid)
    torch.testing.assert_close(pts, want_pts, atol=1e-4, rtol=0)


def _variant_config(variant: str) -> dict:
    """A training configuration at 2×64×96, fp32, 3 steps per dispatch: the
    flagship (ssmall-133, warped pair, photometric, the sparse loss cut to
    100×10, Kendall), the flagship with the dense loss or with exact
    accumulation over r = 2, or stage 1 (gauss2, homographic) on SubpixelNet
    through ``Train_model_subpixel``."""
    from pathlib import Path

    import yaml

    root = Path(__file__).resolve().parents[1] / "configs"
    name = "pipeline240_magicpoint.yaml" if variant == "subpixel" else "pipeline240_wsem_200k.yaml"
    cfg = yaml.safe_load((root / name).read_text())
    cfg["data"]["preprocessing"]["resize"] = [64, 96]
    cfg["model"].update(batch_size=2, real_batch_size=2)
    cfg["model"]["params"]["dtype"] = "float32"
    cfg.update(steps_per_dispatch=3, pretrained=None)
    if variant == "subpixel":
        cfg["front_end_model"] = "Train_model_subpixel"
        cfg["model"]["name"] = "SubpixelNet"
        return cfg
    cfg["model"]["sparse_loss"]["params"].update(num_matching_attempts=100,
                                                 num_masked_non_matches_per_match=10)
    if variant == "dense":
        cfg["model"]["dense_loss"]["enable"] = True
    elif variant == "accum":
        cfg["model"].update(real_batch_size=4, exact_accumulation=True)
    return cfg


def _corpus_loop(cuda, cfg: dict, runs: int = 2, eager: bool = False):
    """``runs`` turns of the device-corpus loop of a fresh agent on a seeded
    corpus of 8 samples at 64×96: (metrics of each turn, step count, ηs,
    module state, the captured region or None)."""
    import tempfile
    from pathlib import Path

    from ssp_torch import registry
    from ssp_torch.data.device_corpus import DeviceCorpus
    from ssp_torch.train import subpixel_agent  # noqa: F401  (registers Train_model_subpixel)
    from ssp_torch.train import trainer  # noqa: F401  (registers the joint agents)
    from ssp_torch.utils.experiment import ExperimentPaths

    rng = np.random.default_rng(0)
    arrays = {"image": torch.from_numpy((rng.uniform(size=(8, 64, 96)) * 255).astype(np.uint8)),
              "points": torch.from_numpy(rng.uniform([0, 0], [95, 63], (8, 40, 2))
                                         .astype(np.float32)),
              "points_valid": torch.from_numpy(rng.uniform(size=(8, 40)) < 0.7)}
    if cfg["data"].get("semantic"):
        arrays["sem"] = torch.from_numpy(rng.integers(0, 134, (8, 64, 96)).astype(np.int32))
    with tempfile.TemporaryDirectory() as td:
        agent = registry.get("agent", cfg["front_end_model"])(
            cfg, save_path=ExperimentPaths(f"e{int(eager)}", Path(td)), device=cuda, eager=eager)
        agent.device_corpus = DeviceCorpus({k: v.to(cuda) for k, v in arrays.items()}, 8)
        assert agent.graphed() != eager
        metrics = [{k: float(v) for k, v in agent.dispatch().items()} for _ in range(runs)]
        return (metrics, agent.state.step, agent.state.etas.detach().clone(),
                {k: v.clone() for k, v in agent.state.model.state_dict().items()}, agent.region)


def _assert_same_runs(a, b):
    (m_a, n_a, e_a, s_a, _), (m_b, n_b, e_b, s_b, _) = a, b
    assert n_a == n_b and m_a == m_b and torch.equal(e_a, e_b)
    assert all(np.isfinite(v) for m in m_a for v in m.values())
    for k in s_a:
        assert torch.equal(s_a[k], s_b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 4000, 256, 1200), (16, 1000, 256, 1200),
                                   (16000, 100, 1, 1200), (3, 70, 3, 5), (2, 33, 64, 1),
                                   (4, 200, 2, 76800), (3, 300, 128, 40), (3, 300, 127, 40),
                                   (2, 500, 300, 40), (2, 3000, 33, 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ordered_scatter_kernel_equals_plain(cuda, shape, dtype):
    """The kernel against its plain version run on the host, bit for bit
    (signed zeros included), at the flagship's shapes (descriptor taps, match
    rows) and at edges (one channel over many rows, one output row, a T the
    size of an image, C of 127 and 128, which do not fill the block's 256
    threads evenly or do, two channel chunks)."""
    from ssp_torch.kernels import ordered_scatter as osc

    R, K, C, T = shape
    g = torch.Generator(cuda).manual_seed(0)
    src = torch.randn(R, K, C, device=cuda, generator=g, dtype=dtype)
    src[:, ::7] = -0.0
    idx = torch.randint(0, T, (R, K), device=cuda, generator=g)
    before = osc.launches
    got = osc.ordered_scatter(src, idx, T).cpu()
    assert osc.launches == before + 1
    want = osc.ordered_scatter_plain(src.cpu(), idx.cpu(), T)
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
def test_flagship_loop_repeats_without_the_deterministic_switch(cuda):
    """The flagship at bf16 with its sparse loss at full size (1000×100 on
    8×12 cells: many collisions) and 3 steps per dispatch, switch off: two
    graphed loops from the same state and seeds (the warm-up turn, then the
    capture and three replays) equal each other and the eager loop bit for
    bit."""
    cfg = _variant_config("flagship")
    cfg["model"]["params"]["dtype"] = "bfloat16"
    cfg["model"]["sparse_loss"]["params"].update(num_matching_attempts=1000,
                                                 num_masked_non_matches_per_match=100)
    first, second = _corpus_loop(cuda, cfg), _corpus_loop(cuda, cfg)
    assert first[4].replays == 3
    _assert_same_runs(first, second)
    _assert_same_runs(first, _corpus_loop(cuda, cfg, eager=True))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flagship", "dense", "accum", "subpixel"])
def test_training_steps_graphed_equal_eager(cuda, variant):
    """The trainer's device-corpus loop with 3 steps per dispatch on a seeded
    corpus, for each step an agent installs (``_variant_config``): two
    turns, the first the eager warm-up, the second the capture and three
    replays, against the same loop with ``eager=True``, both under
    ``torch.use_deterministic_algorithms``: metrics, parameters, BatchNorm
    statistics and ηs equal."""
    cfg = _variant_config(variant)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        graphed = _corpus_loop(cuda, cfg)
        eager = _corpus_loop(cuda, cfg, eager=True)
    finally:
        torch.use_deterministic_algorithms(False)
    region = graphed[4]
    assert region.graph is not None and region.replays == 3
    assert region.launches_per_replay["vresample_coef"] == (2 if variant == "subpixel" else 4)
    assert graphed[1] == 6
    _assert_same_runs(graphed, eager)
