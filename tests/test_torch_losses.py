"""Port parity: the training losses of ``ssp_torch.losses`` against the JAX
package's ``ssp.losses`` on the same numpy inputs, value and gradient, fp32.

Inputs come from a seeded numpy generator.  The sparse descriptor loss takes
the JAX package's own random draws, recomputed in the test from the same
``jax.random`` key by the JAX function's own splits, and fed to the port
(``SparseDraws``).

Bars: the value at rel 1e-5 and each gradient at 1e-5 of its largest
magnitude (rel 1e-4 for the sparse loss's, whose dot products are
summed by a matmul at ``Precision.HIGHEST`` in JAX and by a gather of a Gram
matrix here: fp32 sums of 256 products in another order).  Both sides are
fp32 on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.core.homography import inv3 as j_inv3
from ssp.core.homography import sample_homography as j_sample_homography
from ssp.core.homography import scale_homography as j_scale_homography
from ssp.core.homography import warp_points as j_warp_points
from ssp.losses import detector_loss as j_detector_loss
from ssp.losses import multi_task_loss as j_multi_task_loss
from ssp.losses import semantic_loss as j_semantic_loss
from ssp.losses import semantic_loss_coarse as j_semantic_loss_coarse
from ssp.losses.descriptor_sparse import batch_descriptor_loss_sparse as j_sparse
from ssp_torch.core.grid import labels_to_cells
from ssp_torch.losses import (descriptor_loss_sparse, detector_loss, init_etas,
                              multi_task_loss, semantic_loss, semantic_loss_coarse)
from ssp_torch.losses.descriptor_sparse import SparseDraws, cell_matches, sample_draws
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

B, HC, WC, D, C = 2, 8, 12, 256, 133
PAIR = dict(translation=True, rotation=True, scaling=True, perspective=True,
            scaling_amplitude=0.2, perspective_amplitude_x=0.2, perspective_amplitude_y=0.2,
            patch_ratio=0.85, max_angle=0.785, allow_artifacts=True)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close_grad(got, want, bar):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, atol=bar * scale, rtol=0)


@pytest.mark.parametrize("loss_type", ["softmax", "l2"])
def test_detector_loss_value_and_grad(loss_type):
    rng = np.random.default_rng(0)
    semi = rng.normal(size=(B, HC, WC, 65)).astype(np.float32) * 3
    labels = (rng.uniform(size=(B, HC * 8, WC * 8, 1)) < 0.01).astype(np.float32)
    mask = (rng.uniform(size=(B, HC, WC)) < 0.8).astype(np.float32)
    cells = labels_to_cells(torch.from_numpy(labels)).numpy()
    want, gwant = jax.value_and_grad(
        lambda s: j_detector_loss(s, jnp.asarray(cells), jnp.asarray(mask), loss_type))(
        jnp.asarray(semi))
    s = _t(semi, True)
    got = detector_loss(s, torch.from_numpy(cells), torch.from_numpy(mask), loss_type)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close_grad(s.grad.numpy(), gwant, 1e-5)


@jax.jit
def _jax_h_pair(key):
    keys = jax.random.split(key, B)
    H_inv = jax.vmap(lambda k: j_sample_homography(k, **PAIR))(keys).astype(jnp.float32)
    return j_inv3(H_inv)


def _desc_inputs(seed):
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(B, HC, WC, D)).astype(np.float32)
    d2 = d1 + 0.5 * rng.normal(size=(B, HC, WC, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return d1, d2, np.array(_jax_h_pair(jax.random.key(seed)))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_sparse_draws(key, H_pair, shape, M, N):
    hc, wc = shape
    vy, vx = jnp.meshgrid(jnp.arange(hc), jnp.arange(wc), indexing="ij")
    uv_a = jnp.stack([vx, vy], axis=-1).reshape(-1, 2).astype(jnp.float32)
    out = {"choice": [], "rand_flat": [], "sign_u": [], "normal": []}
    for k, h in zip(jax.random.split(key, len(H_pair)), H_pair):
        uv_b = jnp.round(j_warp_points(uv_a, j_scale_homography(h, (hc, wc))))
        valid = ((uv_b[:, 0] >= 0) & (uv_b[:, 0] <= wc - 1)
                 & (uv_b[:, 1] >= 0) & (uv_b[:, 1] <= hc - 1))
        k_choice, k_nm, k_sel, k_mag = jax.random.split(k, 4)
        out["choice"].append(jax.random.categorical(k_choice, jnp.where(valid, 0.0, -1e9),
                                                    shape=(M,)))
        out["rand_flat"].append(jax.random.randint(k_nm, (M * N,), 0, hc * wc))
        out["sign_u"].append(jax.random.uniform(k_sel, (M * N,)))
        out["normal"].append(jax.random.normal(k_mag, (M * N,)))
    return {k: jnp.stack(v) for k, v in out.items()}


def jax_sparse_draws(key, H_pair, shape, M, N):
    """The draws ``ssp.losses.descriptor_sparse.batch_descriptor_loss_sparse``
    makes from ``key`` for ``H_pair [B, 3, 3]`` on an ``(Hc, Wc)`` grid: one
    key per sample, split in four (choice, non-match cells, sign, size).
    One jitted program over the batch, as the JAX step draws them inside its
    own jit (``jax.random`` gives the same bits under ``jit``)."""
    out = _jax_sparse_draws(key, jnp.asarray(H_pair), tuple(shape), M, N)
    return SparseDraws(**{k: torch.from_numpy(np.array(v)) for k, v in out.items()})


@pytest.mark.parametrize("method", ["2d", "1d"])
def test_sparse_descriptor_loss_with_jax_draws(method):
    M, N = 1000, 100
    d1, d2, H_pair = _desc_inputs(3)
    key = jax.random.key(7)
    params = dict(num_matching_attempts=M, num_masked_non_matches_per_match=N, lamda_d=1.0,
                  method=method)

    def f(a, b):
        total, _, m, nm = j_sparse(key, a, b, jnp.asarray(H_pair), **params)
        return total, (m, nm)

    (want, (wm, wnm)), (ga, gb) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(d1), jnp.asarray(d2))
    a, b = _t(d1, True), _t(d2, True)
    got, _, m, nm = descriptor_loss_sparse(a, b, torch.from_numpy(H_pair),
                                           jax_sparse_draws(key, H_pair, (HC, WC), M, N),
                                           **params)
    got.backward()
    np.testing.assert_allclose([got.item(), m.item(), nm.item()],
                               [float(want), float(wm), float(wnm)], rtol=1e-5)
    assert 0.0 < float(wnm) and 0.0 < float(wm)  # both hinges are active
    _close_grad(a.grad.numpy(), ga, 1e-4)
    _close_grad(b.grad.numpy(), gb, 1e-4)


def test_sparse_descriptor_loss_own_draws():
    """The port's draws: matches only among the in-bounds cells, every index
    in range, the sign's uniform in [0, 1); the loss finite."""
    d1, d2, H_pair = _desc_inputs(4)
    g = torch.Generator().manual_seed(0)
    _, _, valid = cell_matches(torch.from_numpy(H_pair), (HC, WC))
    draws = sample_draws(valid, 1000, 100, g)
    assert valid.gather(1, draws.choice).all()
    assert 0 <= int(draws.rand_flat.min()) and int(draws.rand_flat.max()) < HC * WC
    assert 0.0 <= float(draws.sign_u.min()) and float(draws.sign_u.max()) < 1.0
    assert abs(float(draws.normal.mean())) < 0.02 and abs(float(draws.normal.std()) - 1) < 0.02
    total, _, m, nm = descriptor_loss_sparse(torch.from_numpy(d1), torch.from_numpy(d2),
                                             torch.from_numpy(H_pair), generator=g)
    assert torch.isfinite(total) and 0 < float(m) < 2 and float(nm) >= 0
    # no valid cell (a homography that maps everything out of frame): the
    # draws fall back to every cell, as the JAX package's masked categorical
    far = torch.eye(3)[None].repeat(B, 1, 1)
    far[:, 0, 2] = 10.0
    _, _, none = cell_matches(far, (HC, WC))
    assert not none.any()
    assert sample_draws(none, 50, 3, g).choice.shape == (B, 50)


def _sem_labels(rng, shape, all_ignored):
    labels = rng.integers(0, C, size=shape).astype(np.int32)
    labels[rng.uniform(size=shape) < 0.3] = 133
    if all_ignored:
        labels[:] = 133
    return labels


@pytest.mark.parametrize("all_ignored", [False, True])
def test_semantic_loss_value_and_grad(all_ignored):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(B, 16, 24, C)).astype(np.float32) * 2
    labels = _sem_labels(rng, (B, 16, 24), all_ignored)
    want, gwant = jax.value_and_grad(lambda x: j_semantic_loss(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    x = _t(logits, True)
    got = semantic_loss(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)
    if all_ignored:
        assert got.item() == 0.0 and not x.grad.any()
    else:
        _close_grad(x.grad.numpy(), gwant, 1e-5)


@pytest.mark.parametrize("all_ignored", [False, True])
def test_semantic_loss_coarse_value_and_grad(all_ignored):
    """The fused CE against JAX's, and against the port's own upsample-then-CE
    (``F.interpolate`` bilinear, half-pixel centres, then ``semantic_loss``):
    the two forms agree in value and gradient."""
    rng = np.random.default_rng(6)
    coarse = rng.normal(size=(B, HC, WC, C)).astype(np.float32) * 2
    labels = _sem_labels(rng, (B, HC * 8, WC * 8), all_ignored)
    want, gwant = jax.value_and_grad(
        lambda x: j_semantic_loss_coarse(x, jnp.asarray(labels)))(jnp.asarray(coarse))
    x = _t(coarse, True)
    got = semantic_loss_coarse(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)
    y = _t(coarse, True)
    up = torch.nn.functional.interpolate(y.permute(0, 3, 1, 2), scale_factor=8, mode="bilinear",
                                         align_corners=False).permute(0, 2, 3, 1)
    direct = semantic_loss(up, torch.from_numpy(labels))
    direct.backward()
    np.testing.assert_allclose(got.item(), direct.item(), rtol=1e-5, atol=0)
    if all_ignored:
        assert got.item() == 0.0 and not x.grad.any()
    else:
        _close_grad(x.grad.numpy(), gwant, 1e-5)
        _close_grad(x.grad.numpy(), y.grad.numpy(), 1e-5)


@pytest.mark.parametrize("semantic", [True, False])
def test_multi_task_loss_value_and_grad(semantic):
    rng = np.random.default_rng(7)
    etas = np.asarray(init_etas()) + rng.normal(size=3).astype(np.float32) * 0.1
    parts = rng.uniform(0.1, 3.0, size=4).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(init_etas()), [1.0, 2.0, 1.0])

    def jf(e, p):
        return j_multi_task_loss(e, p[0], p[1], p[2], p[3] if semantic else None)

    want, (ge, gp) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(etas), jnp.asarray(parts))
    e, p = _t(etas, True), _t(parts, True)
    got = multi_task_loss(e, p[0], p[1], p[2], p[3] if semantic else None)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp), rtol=1e-6, atol=1e-7)
