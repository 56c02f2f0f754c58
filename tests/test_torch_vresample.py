"""Port parity: the resample kernels' plain versions (what the wrappers run
for a CPU tensor) against the Pallas kernels in interpret mode, and the
two-pass warp built on them against the JAX package's.

Bars:
* ``vresample`` against ``vresample_pallas``: atol 1e-6.  Both are fp32;
  the Pallas hat weight ``1 − |r − i|`` and the port's ``1 − f`` / ``f``
  round differently in the last bit.
* ``vresample_coef`` against ``vresample_coef_pallas``: atol 2e-4, the bar
  of the JAX package's own coef test.  The coordinate is a rational
  function evaluated in fp32; XLA may contract or reassociate its products,
  which moves it by parts in 1e7 of a coordinate of up to ~100 px, and the
  output by that times the image's slope (uniform noise: up to 1 per pixel).
* the whole two-pass warp: (a) against the JAX coef path in interpret mode
  at the same 2e-4; (b) against the JAX gather warp at the bar of
  ``tests/test_warp_twopass.py`` (two bilinear passes ≈ one: mean interior
  difference below 5% of the mean image); (c) against JAX's own CPU two-pass
  warp, whose off-TPU resample rounds weights and image to bf16, at that
  test file's bf16 bar (max 1.5e-2, mean 2e-3 on a [0, 1] image).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.core.homography import inv3 as j_inv3
from ssp.core.homography import sample_homography as j_sample
from ssp.core.warp import inv_warp_image as j_gather_warp
from ssp.kernels import warp_twopass as jt
from ssp.kernels.vresample_pallas import vresample_coef_pallas, vresample_pallas
from ssp_torch.kernels import vresample as vm
from ssp_torch.kernels import warp_twopass as tt

HA_PARAMS = dict(allow_artifacts=True, patch_ratio=0.85, scaling_amplitude=0.2,
                 perspective_amplitude_x=0.2, perspective_amplitude_y=0.2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hat_fp64(img, rows):
    """out[o, x] = Σ_i max(0, 1 − |rows[o, x] − i|)·img[i, x] in fp64."""
    ii = np.arange(img.shape[0])[:, None, None]
    w = np.maximum(0.0, 1.0 - np.abs(rows[None].astype(np.float64) - ii))
    return np.einsum("iox,ix->ox", w, img.astype(np.float64))


@pytest.mark.parametrize("S", [32, 96])
def test_vresample_matches_pallas(S):
    rng = np.random.default_rng(S)
    img = rng.uniform(size=(S, S)).astype(np.float32)
    rows = rng.uniform(-2, S + 1, size=(S, S)).astype(np.float32)
    rows[0, :6] = [-10.0, -1.0, S - 1.0, S - 0.5, -0.25, float(S)]  # killed, edges
    want = np.asarray(vresample_pallas(jnp.asarray(img), jnp.asarray(rows), interpret=True))
    before = vm.launches
    got = vm.vresample(_t(img), _t(rows)).numpy()
    assert vm.launches == before  # CPU tensors never count a launch
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, _hat_fp64(img, rows), atol=1e-6)
    # the same resample along axis 1 of the transposed image, no transpose made
    got1 = vm.vresample(_t(img.T), _t(rows.T), axis=1).numpy()
    np.testing.assert_array_equal(got1.T, got)


def test_vresample_bottom_edge_and_runaway_coordinates():
    """The JAX package's bottom-edge case (S = 20, half a pixel above the
    last row: weight 0.5, not double-counted), and coordinates no int can
    hold: ±1e9 and ±inf give 0, and so does NaN."""
    S = 20
    img = np.zeros((S, S), np.float32)
    img[S - 1] = 1.0
    rows = np.full((S, S), S - 1.5, np.float32)
    want = np.asarray(vresample_pallas(jnp.asarray(img), jnp.asarray(rows), interpret=True))
    got = vm.vresample(_t(img), _t(rows)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, np.full((S, S), 0.5), atol=1e-6)
    wild = np.array([[1e9, -1e9, np.inf, -np.inf, np.nan, -10.0, -1.0, float(S)]], np.float32)
    ones = np.ones((S, 8), np.float32)
    np.testing.assert_array_equal(vm.vresample(_t(ones), _t(wild)).numpy(), np.zeros((1, 8)))
    # r in (−1, 0) still weights row 0 by 1 + r; r in (S−1, S) row S−1 by S − r
    edge = np.array([[-0.25, S - 0.75, S - 1.0, 0.0]], np.float32)
    np.testing.assert_allclose(vm.vresample(_t(ones[:, :4]), _t(edge)).numpy(),
                               [[0.75, 0.75, 1.0, 1.0]], atol=1e-6)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_warp"])
def test_vresample_batched_matches_pallas(shared):
    """N warps over one shared image, over one image each, and over M < N
    images (warp n reads image n // (N/M)); rectangular images."""
    rng = np.random.default_rng(4)
    S, N = 32, 4
    imgs = rng.uniform(size=(1 if shared else N, S, S)).astype(np.float32)
    rows = rng.uniform(-2, S + 1, size=(N, S, S)).astype(np.float32)
    f = lambda a, b: vresample_pallas(a, b, interpret=True)
    if shared:
        want = np.asarray(jax.vmap(f, in_axes=(None, 0))(jnp.asarray(imgs[0]), jnp.asarray(rows)))
        got = vm.vresample(_t(imgs[0]), _t(rows)).numpy()
    else:
        want = np.asarray(jax.vmap(f)(jnp.asarray(imgs), jnp.asarray(rows)))
        got = vm.vresample(_t(imgs), _t(rows)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    if not shared:
        two = vm.vresample(_t(imgs[:2]), _t(rows)).numpy()  # M = 2, N = 4
        for n in range(N):
            one = vm.vresample(_t(imgs[n // 2]), _t(rows[n])).numpy()
            np.testing.assert_array_equal(two[n], one)
    rect = rng.uniform(size=(24, 40)).astype(np.float32)
    r0 = rng.uniform(-2, 25, size=(24, 40)).astype(np.float32)
    np.testing.assert_allclose(vm.vresample(_t(rect), _t(r0)).numpy(), _hat_fp64(rect, r0),
                               atol=1e-6)
    r1 = rng.uniform(-2, 41, size=(24, 40)).astype(np.float32)
    np.testing.assert_allclose(vm.vresample(_t(rect), _t(r1), axis=1).numpy(),
                               _hat_fp64(rect.T, r1.T).T, atol=1e-6)


def _coef_case(seed, S):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(S, S)).astype(np.float32)
    Hm = (np.eye(3) + rng.normal(0, 0.1, (3, 3))).astype(np.float32)
    return img, Hm


@pytest.mark.parametrize("S", [32, 96])
def test_pass_coefs_and_coef_kernel_match_pallas(S):
    img, Hm = _coef_case(S, S)
    bounds = (2.0, S - 6.0, 3.0, S - 1.0)
    want1, want2 = jt._pass_coefs(jnp.asarray(Hm), *bounds, S)
    c1, c2 = tt._pass_coefs(_t(Hm)[None], *bounds, S)
    np.testing.assert_allclose(c1[0].numpy(), np.asarray(want1), atol=1e-6)
    np.testing.assert_allclose(c2[0].numpy(), np.asarray(want2), atol=1e-6)
    before = vm.coef_launches
    for coef, want_c in ((c1, want1), (c2, want2)):
        want = np.asarray(vresample_coef_pallas(jnp.asarray(img), want_c, interpret=True))
        got = vm.vresample_coef(_t(img), coef[0]).numpy()
        assert 0.05 < (want != 0).mean()  # the kill test and the bounds leave work
        np.testing.assert_allclose(got, want, atol=2e-4)
    assert vm.coef_launches == before
    # axis 1 is the same function on the transposed image
    a0 = vm.vresample_coef(_t(img), c2[0]).numpy()
    a1 = vm.vresample_coef(_t(img.T), c2[0], axis=1).numpy()
    np.testing.assert_array_equal(a1.T, a0)
    # batched: warps over a shared image
    both = vm.vresample_coef(_t(img), torch.cat([c1, c2])).numpy()
    np.testing.assert_array_equal(both[1], a0)


def _jax_coef_twopass(img, Hm):
    """The JAX coef path in interpret mode, wrapped as
    ``tests/test_warp_twopass.py::test_full_warp_matches_einsum_path`` does."""
    H_px, W_px = img.shape
    S = max(H_px, W_px)
    sx, sy = (S - 1) / (W_px - 1), (S - 1) / (H_px - 1)
    T = jnp.array([[sx, 0.0, sx - 1.0], [0.0, sy, sy - 1.0], [0.0, 0.0, 1.0]])
    Hc = j_inv3(T) @ jnp.asarray(Hm) @ T
    canvas = jnp.pad(jnp.asarray(img), ((0, S - H_px), (0, S - W_px)))
    k = jt._mean_rotation_bucket(Hc)
    rk_inv = jnp.stack([jt._rot_k((4 - kk) % 4) for kk in range(4)])
    Hres = Hc @ rk_inv[k]
    rlo = jnp.array([0, 0, S - H_px, S - W_px])[k]
    rhi = jnp.array([H_px, W_px, S, S])[k]
    clo = jnp.array([0, S - H_px, S - W_px, 0])[k]
    chi = jnp.array([W_px, S, S, H_px])[k]
    mid = jt._twopass_square_coef(canvas, Hres, rlo, rhi, clo, chi, interpret=True)
    return np.asarray(jnp.rot90(mid, k=int(k))[:H_px, :W_px]), int(k)


def _rotation(rng, ang):
    a = np.radians(ang)
    Hm = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]], np.float32)
    Hm[:2, 2] = rng.uniform(-0.2, 0.2, 2)
    Hm[2, :2] = rng.uniform(-0.05, 0.05, 2)
    return Hm


@pytest.fixture
def coef_grids(monkeypatch):
    """The port's two-pass warp on the coef route for one test."""
    monkeypatch.setattr(tt, "COEF_GRIDS", True)


@pytest.fixture
def rows_grids(monkeypatch):
    """The port's two-pass warp on the rows route for one test."""
    monkeypatch.setattr(tt, "COEF_GRIDS", False)


def test_twopass_matches_jax_coef_path_all_buckets(coef_grids):
    """(a) A rectangular 64×96 image (square side 96), one rotation per 90°
    bucket, the port's coef route against the JAX coef path."""
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(64, 96)).astype(np.float32)
    Hs = np.stack([_rotation(rng, ang) for ang in (-170.0, -95.0, 10.0, 80.0)])
    got = tt.inv_warp_image_twopass(_t(img), _t(Hs)).numpy()
    seen = set()
    for n, Hm in enumerate(Hs):
        want, k = _jax_coef_twopass(img, Hm)
        seen.add(k)
        assert np.abs(want).mean() > 0.05
        np.testing.assert_allclose(got[n], want, atol=2e-4)
    assert seen == {0, 1, 2, 3}


@pytest.mark.parametrize("coef", [False, True], ids=["rows", "coef"])
def test_twopass_matches_jax_gather_warp(coef, monkeypatch):
    """(b) Sampled export homographies on a smooth 48×64 image, both routes."""
    img = cv2.GaussianBlur(np.random.default_rng(3).uniform(0, 1, (48, 64)).astype(np.float32),
                           (7, 7), 0)
    Hs = np.stack([np.array(j_sample(jax.random.key(i), **HA_PARAMS)) for i in range(12)])
    monkeypatch.setattr(tt, "COEF_GRIDS", coef)
    got = tt.inv_warp_image_twopass(_t(img), _t(Hs)).numpy()
    worst = 0.0
    for n, Hm in enumerate(Hs):
        want = np.asarray(j_gather_warp(jnp.asarray(img)[..., None], jnp.asarray(Hm)))[..., 0]
        diff = np.abs(want - got[n])[4:-4, 4:-4].mean()
        worst = max(worst, diff / max(np.abs(want).mean(), 0.1))
    assert worst < 0.05, worst


def test_twopass_matches_jax_cpu_twopass_at_bf16_bar(rows_grids):
    """(c) The rows route against JAX's own CPU two-pass warp, all four
    buckets, per-warp images; and a single [3, 3] homography."""
    rng = np.random.default_rng(5)
    imgs = rng.uniform(size=(4, 64, 96)).astype(np.float32)
    Hs = np.stack([_rotation(rng, ang) for ang in (-170.0, -95.0, 10.0, 80.0)])
    got = tt.inv_warp_image_twopass(_t(imgs), _t(Hs)).numpy()
    assert got.shape == (4, 64, 96)
    for n in range(4):
        want = np.asarray(jt.inv_warp_image_twopass(jnp.asarray(imgs[n]), jnp.asarray(Hs[n])))
        d = np.abs(want - got[n])
        assert d.max() < 1.5e-2 and d.mean() < 2e-3, (n, d.max(), d.mean())
    one = tt.inv_warp_image_twopass(_t(imgs[2]), _t(Hs[2])).numpy()
    np.testing.assert_array_equal(one, got[2])


def test_twopass_identity_is_exact_inside():
    """The identity resamples every pixel at an integer coordinate: the
    fp32 two-pass warp returns the image (the coordinate grid is exact to
    1e-5 px, times a slope of at most 1)."""
    img = np.random.default_rng(6).uniform(size=(48, 64)).astype(np.float32)
    got = tt.inv_warp_image_twopass(_t(img), torch.eye(3)).numpy()
    np.testing.assert_allclose(got, img, atol=1e-4)


def test_twopass_identity_is_exact_inside_on_the_rows_route(rows_grids):
    img = np.random.default_rng(6).uniform(size=(48, 64)).astype(np.float32)
    got = tt.inv_warp_image_twopass(_t(img), torch.eye(3)).numpy()
    np.testing.assert_allclose(got, img, atol=1e-4)


def test_default_route_is_the_coef_route():
    """``inv_warp_image_twopass`` goes through ``vresample_coef`` unless
    ``COEF_GRIDS`` is switched off: bit-equal to the coef passes called by
    hand, and not to the rows route's grids."""
    assert tt.COEF_GRIDS is True
    rng = np.random.default_rng(7)
    img = _t(rng.uniform(size=(40, 40)).astype(np.float32))
    Hm = _t(_rotation(rng, 12.0))[None]
    canvas, Hres, bounds, k = tt._canvas_and_residual(img, Hm)
    assert k.tolist() == [0]
    c1, c2 = tt._pass_coefs(Hres, *bounds, 40)
    by_hand = vm.vresample_coef(vm.vresample_coef(canvas, c1, axis=0), c2, axis=1)
    assert torch.equal(tt.inv_warp_image_twopass(img, Hm), by_hand)


COEF_BOUNDS = {
    "empty_along_axis": (10.0, 10.0, 0.0, 96.0),
    "empty_along_line": (0.0, 96.0, 50.0, 50.0),
    "one_row": (31.0, 32.0, 0.0, 96.0),
    "one_column": (0.0, 96.0, 64.0, 65.0),  # the first column of the second tile
    "cuts_tiles_in_two": (40.0, 80.0, 20.0, 70.0),
}


@pytest.mark.parametrize("case", list(COEF_BOUNDS))
def test_coef_keep_bounds_match_pallas(case):
    """Keep bounds that are empty, that keep one row or one column, and that
    cut the CUDA kernel's 64×64 tiles in two, at S = 96 (one and a half tiles):
    the plain version against the Pallas kernel at the coef bar, 2e-4, and
    exactly 0 outside the bounds."""
    S = 96
    olo, ohi, llo, lhi = COEF_BOUNDS[case]
    img, Hm = _coef_case(17, S)
    o, l = np.arange(S)[:, None], np.arange(S)[None, :]
    kept = (o >= olo) & (o < ohi) & (l >= llo) & (l < lhi)
    for coef in tt._pass_coefs(_t(Hm)[None], 0.0, float(S), 0.0, float(S), S):
        coef = coef[0].clone()
        coef[16:] = torch.tensor([olo, ohi, llo, lhi])
        want = np.asarray(vresample_coef_pallas(jnp.asarray(img), jnp.asarray(coef.numpy()),
                                                interpret=True))
        got = vm.vresample_coef(_t(img), coef).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4)
        assert not got[~kept].any()
        assert (got[kept] != 0).mean() > 0.5 if kept.any() else not got.any()
        # axis 1: the same function of the transposed image
        got1 = vm.vresample_coef(_t(img.T), coef, axis=1).numpy()
        np.testing.assert_array_equal(got1.T, got)


@pytest.mark.parametrize("R,C", [(40, 72), (100, 70)])
@pytest.mark.parametrize("axis", [0, 1])
def test_coef_plain_matches_fp64_on_rectangles(R, C, axis):
    """R ≠ C, neither a multiple of the CUDA kernel's 64×64 tile (the Pallas
    kernel takes squares only): the plain version against the formula of
    ``coef_coords`` and the hat sum, both in fp64.  2e-4: the fp32 coordinate
    is off by parts in 1e7 of up to ~100 px, times a slope of at most 1."""
    rng = np.random.default_rng(R + axis)
    img = rng.uniform(size=(R, C)).astype(np.float32)
    L, n_lines = (R, C) if axis == 0 else (C, R)
    c = np.zeros(20, np.float32)
    c[0:4] = [0.05, 0.1, 0.9, 0.08]        # numerator: near the identity along the axis
    c[4:8] = [1.0, 0.05, -0.04, 0.02]      # denominator: near 1
    c[8:16] = [0, 0, 0, 0, 1, 0, 0, 0]     # never killed
    c[16:] = [3.0, L - 5.0, 2.0, n_lines - 7.0]
    io, il = np.arange(L, dtype=np.float64), np.arange(n_lines, dtype=np.float64)
    Lo, Ll = io / ((L - 1) / 2.0) - 1.0, il / ((n_lines - 1) / 2.0) - 1.0
    Lo, Ll = (Lo[:, None], Ll[None, :]) if axis == 0 else (Lo[None, :], Ll[:, None])
    io, il = (io[:, None], il[None, :]) if axis == 0 else (io[None, :], il[:, None])
    cd = c.astype(np.float64)
    q = lambda k: (cd[k] + cd[k + 1] * Ll) + (cd[k + 2] + cd[k + 3] * Ll) * Lo
    r = (q(0) / q(4) + 1.0) * (L - 1) / 2.0
    keep = (io >= cd[16]) & (io < cd[17]) & (il >= cd[18]) & (il < cd[19])
    r = np.where(keep, np.clip(r, -64.0, L + 64.0), -10.0)
    want = _hat_fp64(img, r) if axis == 0 else _hat_fp64(img.T, r.T).T
    got = vm.vresample_coef(_t(img), _t(c), axis=axis).numpy()
    assert got.shape == (R, C) and 0.5 < (want != 0).mean() < 1.0
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert not got[~np.broadcast_to(keep, (R, C))].any()


def test_resample_wrappers_check_inputs():
    img, rows = torch.zeros(8, 8), torch.zeros(8, 8)
    with pytest.raises(ValueError, match="float32"):
        vm.vresample(img.double(), rows)
    with pytest.raises(ValueError, match="axis"):
        vm.vresample(img, rows, axis=2)
    with pytest.raises(ValueError, match="differ along"):
        vm.vresample(img, torch.zeros(8, 9))
    with pytest.raises(ValueError, match="divide"):
        vm.vresample(torch.zeros(2, 8, 8), torch.zeros(3, 8, 8))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        vm.vresample(torch.zeros(8, 8, device="meta"), torch.zeros(8, 8, device="meta"))
    with pytest.raises(ValueError, match="20"):
        vm.vresample_coef(img, torch.zeros(19))
    with pytest.raises(ValueError, match="float32"):
        vm.vresample_coef(img, torch.zeros(20, dtype=torch.float64))
