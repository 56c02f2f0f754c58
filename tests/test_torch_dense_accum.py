"""Port parity: the dense descriptor loss and exact gradient accumulation
against the JAX package, fp32 on the CPU, the same numpy-seeded inputs and
the flax-initialised weights carried across by ``flax_to_state_dict``.

* ``descriptor_loss_dense`` against ``ssp.losses.descriptor_dense``: loss,
  positive and negative terms at rel 1e-5 (sums of the same products in
  another order); the correspondence mask equal but for pairs whose JAX
  distance lies within 1e-4 px of ``descriptor_dist``, where an ulp of the
  warp decides the threshold (counted and reported).
* One dense train step (``SuperPointNet_gauss2``, warped pair, Kendall)
  against ``compute_losses(desc_loss="dense")``: every metric at rel 1e-4
  (the bar of ``tests/test_torch_train_step.py``) and the first-step
  gradient of every leaf after down3's max pool within 1e-4 of its largest
  magnitude; before it, cosine ≥ 0.9998 (near-ties of the 2×2 max route
  gradients by the last bit).
* ``accum_train_step`` against ``make_accum_train_step`` with SGD, r = 2:
  parameters and BatchNorm statistics at atol 1e-6, rtol 1e-5
  (``tests/test_accum.py``'s bars), both sides at fp64 (x64 JAX, the flax
  module's fixed fp32 read as fp64, as ``tests/test_torch_train_step.py``
  runs its fp64 cases; the homographies fp32 on both sides).  At fp32 one
  BatchNorm bias of down1 moves 2% off JAX's: an SGD step of 0.1 carries
  the gradient of a near-tie of a 2×2 max, routed by the last bit, into the
  parameter.  With identical micro-batches the update is r times one
  micro-batch's (gradients summed, not averaged).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssp.core.homography import warp_points as j_warp_points
from ssp.data.pipeline import prepare_batch as j_prepare_batch
from ssp.losses.descriptor_dense import descriptor_loss_dense as j_dense
from ssp.models import build_model as j_build_model
from ssp.train.state import create_train_state
from ssp.train.step import compute_losses as j_compute_losses
from ssp.train.step import make_accum_train_step
from ssp_torch.losses import descriptor_loss_dense
from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import flax_to_state_dict, load_flax_npz, load_reference_state_dict
from ssp_torch.train import TrainState, accum_train_step, train_step
from ssp_torch.train.lr import PolynomialDecayLR
from test_torch_train_step import _fp64, _widen
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

B, H, W = 2, 48, 64
KW = dict(semantic=False, warped_pair=True, det_loss_type="softmax", desc_loss="dense",
          desc_params={"lambda_d": 800.0, "descriptor_dist": 4.0}, lambda_loss=1.0,
          multi_task=True, ignore_class=133)
PAIR = {"enable": True, "valid_border_margin": 3, "params": {
    "translation": True, "rotation": True, "scaling": True, "perspective": True,
    "scaling_amplitude": 0.2, "perspective_amplitude_x": 0.2, "perspective_amplitude_y": 0.2,
    "patch_ratio": 0.85, "max_angle": 0.785, "allow_artifacts": True}}


def _jbatch(n, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=(n, H, W)).astype(np.float32)
    pts = rng.uniform([0, 0], [W - 1, H - 1], size=(n, 30, 2)).astype(np.float32)
    prep = jax.jit(lambda k, i, p, v: j_prepare_batch(k, i, p, v, warped_pair=PAIR))
    return prep(jax.random.key(seed), imgs, pts, np.ones((n, 30), bool))


def _torch(jbatch):
    return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


@pytest.fixture(scope="module")
def jbatch():
    return _jbatch(2 * B, 3)


def test_dense_loss_matches_jax(jbatch):
    rng = np.random.default_rng(0)
    Hc, Wc, D = H // 8, W // 8, 256
    desc = rng.normal(size=(2 * B, Hc, Wc, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    warped = desc + 0.3 * rng.normal(size=desc.shape).astype(np.float32)
    warped /= np.linalg.norm(warped, axis=-1, keepdims=True)
    Hp = np.asarray(jbatch["H_pair"])
    valid = (rng.uniform(size=(2 * B, Hc, Wc)) < 0.8).astype(np.float32)
    kw = dict(lambda_d=800.0, descriptor_dist=4.0)
    want = j_dense(jnp.asarray(desc), jnp.asarray(warped), jnp.asarray(Hp), jnp.asarray(valid),
                   **kw)
    got = descriptor_loss_dense(torch.from_numpy(desc), torch.from_numpy(warped),
                                torch.from_numpy(Hp), torch.from_numpy(valid), **kw)
    for i, name in ((0, "loss"), (2, "pos"), (3, "neg")):
        np.testing.assert_allclose(float(got[i]), float(want[i]), rtol=1e-5, err_msg=name)
    # JAX's distances, step by step as the JAX function computes them
    cy, cx = np.meshgrid(np.arange(Hc), np.arange(Wc), indexing="ij")
    centres = np.stack([cx, cy], -1).reshape(-1, 2) * 8 + 4
    wn = j_warp_points(jnp.asarray(centres / np.array([W, H]) * 2.0 - 1.0, jnp.float32),
                       jnp.asarray(Hp))
    wp = (wn + 1.0) / 2.0 * jnp.array([W, H])
    dist = np.asarray(jnp.linalg.norm(wp[:, :, None, :] - centres[None, None], axis=-1))
    near = np.abs(dist - 4.0) <= 1e-4
    differ = got[1].numpy() != np.asarray(want[1])
    assert np.asarray(want[1]).sum() > 0 and not (differ & ~near).any()
    print(f"corr: {int(differ.sum())} of {differ.size} pairs differ, {int(near.sum())} lie "
          f"within 1e-4 px of descriptor_dist")


def test_dense_train_step_matches_jax(jbatch):
    batch = {k: v[:B] for k, v in jbatch.items()}
    jm = j_build_model("SuperPointNet_gauss2", dtype=jnp.float32)
    state = jax.jit(lambda key: create_train_state(jm, key, (1, H, W, 1)))(jax.random.key(0))

    def loss_fn(tr):
        return j_compute_losses(state, batch, jax.random.key(1), tr["params"], tr["etas"],
                                train=True, **KW)

    grads, (_, jmetrics) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        {"params": state.params, "etas": state.etas})
    model = load_flax_npz({"params": state.params, "batch_stats": state.batch_stats},
                          "SuperPointNet_gauss2", device="cpu").train()
    ts = TrainState.create(model, learning_rate=0.001, max_steps=10)
    metrics = train_step(ts, _torch(batch), **KW)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    jg = flax_to_state_dict({"params": grads["params"]})
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), jg[name].numpy()
        scale = float(np.abs(w).max())
        if scale < 1e-6:  # a conv bias that feeds a BatchNorm: zero but for noise
            assert float(np.abs(g).max()) < 1e-5, name
        elif name.startswith(("inc.", "down")):
            cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
            assert cos >= 0.9998, (name, cos)
        else:
            assert float(np.abs(g - w).max()) <= 1e-4 * scale, name
    np.testing.assert_allclose(ts.etas.grad.numpy(), np.asarray(grads["etas"]), rtol=1e-4)


def _sgd_state(variables, dtype=torch.float32):
    model = build_model("SuperPointNet_gauss2", device="cpu", dtype=dtype).to(dtype)
    load_reference_state_dict(model, flax_to_state_dict(variables))
    etas = torch.nn.Parameter(torch.tensor([1.0, 2.0, 1.0], dtype=dtype))
    opt = torch.optim.SGD(list(model.parameters()) + [etas], lr=0.1)
    return TrainState(model.train(), etas, opt, PolynomialDecayLR(opt, 0))  # lr constant


def _close(got_sd, want_tree, kind):
    want = flax_to_state_dict({kind: want_tree})
    for k, w in want.items():
        np.testing.assert_allclose(got_sd[k].detach().numpy(), w.numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=k)


def test_accum_step_matches_jax(jbatch):
    r = 2
    batch = {k: np.asarray(v, np.float64 if v.dtype == jnp.float32 and k != "H_pair" else None)
             for k, v in jbatch.items()}
    with _fp64(True):
        jm = j_build_model("SuperPointNet_gauss2", dtype=jnp.float64)
        state = _widen(jax.jit(lambda key: create_train_state(
            jm, key, (1, H, W, 1), tx=optax.sgd(0.1)))(jax.random.key(0)))
        ts = _sgd_state({"params": state.params, "batch_stats": state.batch_stats},
                        torch.float64)
        new_state, jmetrics = make_accum_train_step(r, donate=False, **KW)(
            state, batch, jax.random.key(3))
    metrics = accum_train_step(ts, _torch(batch), r, **KW)
    sd = ts.model.state_dict()
    _close(sd, new_state.params, "params")
    _close(sd, new_state.batch_stats, "batch_stats")
    np.testing.assert_allclose(ts.etas.detach().numpy(), np.asarray(new_state.etas), atol=1e-6)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    assert ts.step == 1


def test_accum_gradient_is_sum_not_mean(jbatch):
    """Two identical micro-batches move every parameter by twice the update
    of one of them (SGD: the update is linear in the gradient)."""
    kw = dict(KW, warped_pair=False, lambda_loss=0.0, multi_task=False)
    jm = j_build_model("SuperPointNet_gauss2", dtype=jnp.float32)
    variables = jax.jit(functools.partial(jm.init, train=True))(jax.random.key(0),
                                                                 jnp.zeros((1, H, W, 1)))
    one = {k: v[:B] for k, v in _torch(jbatch).items()}
    doubled = {k: torch.cat([v, v]) for k, v in one.items()}
    a, b = _sgd_state(variables), _sgd_state(variables)
    before = {n: p.detach().clone() for n, p in a.model.named_parameters()}
    accum_train_step(a, doubled, 2, **kw)
    train_step(b, one, **kw)
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        np.testing.assert_allclose((pa - before[n]).detach().numpy(),
                                   2 * (pb - before[n]).detach().numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=n)
