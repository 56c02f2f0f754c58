"""The ordered scatter-add and the operations the training path replaced
with ordered ones, on the CPU (the kernel itself: ``tests/test_torch_cuda.py``).

* :func:`ordered_scatter_plain` (what :func:`ordered_scatter` runs for a CPU
  tensor) equals the gradient of ``torch.gather`` bit for bit at fp32, with
  heavy collisions, outputs that nothing hits and C ∈ {1, 127, 256, 300};
  :func:`gather_rows` passes ``gradcheck`` at fp64;
* each replacement gives the value of the operation it replaces bit for bit
  and its gradient within fp32 rounding (another summation order):
  ``gather_rows`` for ``torch.gather`` and for advanced indexing,
  ``edge_pad`` for ``F.pad(mode="replicate")``, the one-gather
  ``bilinear_sample`` for the four gathers it had;
* the sparse loss's value and gradient repeat bit for bit (the
  advanced-indexing backward it had does not on the CPU either).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssp_torch.core import warp
from ssp_torch.kernels import ordered_scatter as osc
from ssp_torch.losses.descriptor_sparse import cell_matches, descriptor_loss_sparse, sample_draws
from ssp_torch.losses.semantic import edge_pad
from test_torch_threads import _one_thread  # noqa: F401  (autouse)


def _inputs(R, K, C, T, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    src = torch.randn(R, K, C, generator=g, dtype=dtype)
    idx = torch.randint(0, T, (R, K), generator=g)
    return src, idx


@pytest.mark.parametrize("R,K,C,T", [(3, 500, 1, 7), (2, 4000, 256, 1200), (4, 100, 1, 1200),
                                     (5, 300, 256, 3), (3, 300, 127, 40), (2, 500, 300, 40)])
def test_plain_equals_the_gather_gradient_bit_for_bit(R, K, C, T):
    src, idx = _inputs(R, K, C, T)
    idx[0] = T // 2  # one row hits a single output: every other output empty
    table = torch.randn(R, T, C, requires_grad=True)
    out = torch.gather(table, 1, idx[..., None].expand(R, K, C))
    (want,) = torch.autograd.grad(out, table, src)
    before = osc.launches
    got = osc.ordered_scatter(src, idx, T)
    assert osc.launches == before  # a CPU tensor launches nothing
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, osc.ordered_scatter_plain(src, idx, T))
    assert not got[0, : T // 2].any() and not got[0, T // 2 + 1:].any()


def test_plain_is_a_serial_sum_in_k_from_zero():
    """The sums start from +0 and add in increasing k: -0 terms give +0,
    and a sum that cancels in one order and not in another takes the serial
    one."""
    src = torch.tensor([[[1e8], [1.0], [-1e8], [-0.0], [-0.0]]])
    idx = torch.tensor([[0, 0, 0, 1, 1]])
    out = osc.ordered_scatter(src, idx, 3)
    one = np.float32(1.0)
    assert out[0, 0, 0].item() == ((np.float32(0) + np.float32(1e8)) + one) - np.float32(1e8) == 0
    assert (np.float32(1e8) - np.float32(1e8)) + one == 1  # another order: another sum
    assert str(out[0, 1, 0].item()) == "0.0" and str(out[0, 2, 0].item()) == "0.0"


def test_gather_rows_gradcheck_fp64():
    src, idx = _inputs(2, 40, 3, 6, dtype=torch.float64)
    table = torch.randn(2, 6, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: osc.gather_rows(t, idx), (table,))
    assert torch.autograd.gradcheck(lambda t: osc.gather_rows(t, idx) * src, (table,))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    src, idx = _inputs(2, 5, 3, 4)
    with pytest.raises(ValueError):
        osc.ordered_scatter(src.half(), idx, 4)
    with pytest.raises(ValueError):
        osc.ordered_scatter(src, idx.int(), 4)
    with pytest.raises(ValueError):
        osc.ordered_scatter(src, idx[:, :3], 4)
    with pytest.raises(ValueError):
        osc.ordered_scatter(src[0], idx, 4)


@pytest.mark.parametrize("how", ["gather", "index"])
def test_gather_rows_replaces_gather_and_indexing(how):
    src, idx = _inputs(3, 900, 32, 50, seed=1)
    table = torch.randn(3, 50, 32, requires_grad=True)
    got = osc.gather_rows(table, idx)
    if how == "gather":
        want = torch.gather(table, 1, idx[..., None].expand(3, 900, 32))
    else:
        want = table[torch.arange(3)[:, None], idx]
    assert torch.equal(got, want)
    (g_got,) = torch.autograd.grad((got * src).sum(), table)
    (g_want,) = torch.autograd.grad((want * src).sum(), table)
    torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-5)


def test_edge_pad_replaces_the_replicate_pad():
    x = torch.randn(2, 5, 7, 3, requires_grad=True)
    got = edge_pad(x)
    want = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    w = torch.randn(got.shape)
    (g_got,) = torch.autograd.grad((got * w).sum(), x)
    (g_want,) = torch.autograd.grad((want * w).sum(), x)
    torch.testing.assert_close(g_got, g_want, rtol=1e-6, atol=1e-6)


def _bilinear_four_gathers(img, coords):
    """``bilinear_sample`` as it was: one gather per tap."""
    H, W = img.shape[-3], img.shape[-2]
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(iy, ix):
        ok = ((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W))[..., None].to(img.dtype)
        flat = img.reshape(img.shape[0], H * W, -1)
        i = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(img.shape[0], -1)
        v = torch.gather(flat, 1, i[..., None].expand(*i.shape, flat.shape[-1]))
        return v.reshape(*iy.shape, -1) * ok

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x0i + 1) * wx
    bot = tap(y0i + 1, x0i) * (1 - wx) + tap(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def test_bilinear_sample_in_one_gather_replaces_four():
    rng = np.random.default_rng(2)
    img = torch.randn(3, 15, 20, 16, requires_grad=True)
    coords = torch.from_numpy(rng.uniform([-2, -2], [21, 16], (3, 500, 2)).astype(np.float32))
    got, want = warp.bilinear_sample(img, coords), _bilinear_four_gathers(img, coords)
    assert torch.equal(got, want)
    w = torch.randn(got.shape)
    (g_got,) = torch.autograd.grad((got * w).sum(), img)
    (g_want,) = torch.autograd.grad((want * w).sum(), img)
    torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["2d", "1d"])
def test_sparse_loss_gradient_repeats_bit_for_bit(method):
    """Heavy collisions (1000 matches, 100 non-matches each, on 6×8 cells):
    the loss's gradient with respect to both descriptor maps is the same in
    every run."""
    g = torch.Generator().manual_seed(3)
    desc = F.normalize(torch.randn(2, 6, 8, 32, generator=g), dim=-1)
    warped = F.normalize(torch.randn(2, 6, 8, 32, generator=g), dim=-1)
    H = torch.eye(3).repeat(2, 1, 1)
    H[:, 0, 2] = 0.05
    _, _, valid = cell_matches(H, (6, 8))
    draws = sample_draws(valid, 1000, 100, torch.Generator().manual_seed(4))
    runs = []
    for _ in range(3):
        a, b = desc.clone().requires_grad_(), warped.clone().requires_grad_()
        loss = descriptor_loss_sparse(a, b, H, draws, method=method)[0]
        runs.append((loss.detach(), *torch.autograd.grad(loss, (a, b))))
    for r in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(r, runs[0]))
