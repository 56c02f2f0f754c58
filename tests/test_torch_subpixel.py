"""Port parity: SubpixelNet, the subpixel losses and the subpixel agents
against the JAX package, fp32 on the CPU, the same numpy-seeded inputs and
the flax-initialised weights carried across by ``flax_to_state_dict``.

* The SubpixelNet forward, evaluation and training mode: ``semi``,
  ``desc`` and ``subpixel`` within 2e-4 (the fp32 forward bar); the
  running statistics after a training forward within 1e-5 of each leaf's
  largest magnitude; ``state_dict_to_flax`` inverts the mapping.
  ``supports_fast`` says yes to a SubpixelNet state, as the JAX package's
  does, and the folded forward of one is the folded forward of its encoder
  and heads (only ``semi`` and ``desc`` are read there).
* ``subpixel_residual_loss`` and ``subpixel_map_loss``: value at rel 1e-5,
  the map loss's gradient within 1e-5 of its largest magnitude.
* One ``Train_model_subpixel`` step (the registered agent) against
  ``make_subpixel_train_step``: every metric at rel 1e-4, the BatchNorm
  statistics within 1e-5, the ηs unmoved on both sides, and Adam's first
  update of ``outc`` (no max pool on its gradient's path) within 1e-6.
* ``Val_model_subpixel``: ``run`` and ``refine_points`` within 2e-4 of
  JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssp.data.pipeline import prepare_batch as j_prepare_batch
from ssp.losses.subpixel import subpixel_residual_loss as j_residual_loss
from ssp.models import build_model as j_build_model
from ssp.models.fast_infer import supports_fast as j_supports_fast
from ssp.train.state import create_train_state
from ssp.train.subpixel_agent import SubpixelValAgent as JSubpixelValAgent
from ssp.train.subpixel_agent import make_subpixel_train_step
from ssp.train.subpixel_agent import subpixel_map_loss as j_map_loss
from ssp_torch import registry
from ssp_torch.losses.subpixel import subpixel_residual_loss
from ssp_torch.models.fast_infer import best_apply_fn, make_fast_apply, supports_fast
from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import (flax_to_state_dict, load_reference_state_dict,
                                      state_dict_to_flax)
from ssp_torch.train import subpixel_agent, val_agent  # noqa: F401  (register the agents)
from ssp_torch.train.subpixel_agent import SubpixelValAgent, subpixel_map_loss
from ssp_torch.utils.experiment import ExperimentPaths
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

B, H, W = 2, 32, 48
LR = 0.001


@pytest.fixture(scope="module")
def flax_sub():
    jm = j_build_model("SubpixelNet", dtype=jnp.float32)
    x = np.random.default_rng(0).uniform(size=(B, H, W, 1)).astype(np.float32)
    return jm, jax.jit(functools.partial(jm.init, train=False))(jax.random.key(0),
                                                               jnp.asarray(x)), x


def _port(variables):
    model = build_model("SubpixelNet", device="cpu", dtype=torch.float32)
    return load_reference_state_dict(model, flax_to_state_dict(variables))


def test_forward_matches_flax(flax_sub):
    jm, v, x = flax_sub
    model = _port(v)
    want = jax.jit(functools.partial(jm.apply, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want) == {"semi", "desc", "subpixel"}
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, rtol=0)
    # training mode: batch statistics, the running ones moved
    want, mut = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, rtol=0)
    stats = flax_to_state_dict({"batch_stats": mut["batch_stats"]})
    sd = model.state_dict()
    for k, w in stats.items():
        assert float((sd[k] - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-12), k
    # the mapping inverts
    flat = state_dict_to_flax(model.state_dict())
    assert len(flat) == len(flax_to_state_dict(v))
    assert "params/up3/DoubleConv_0/ConvBNRelu_1/BatchNorm_0/scale" in flat
    assert flat["params/outc/kernel"].shape == (1, 1, 64, 2)


def test_fast_forward_reads_encoder_and_heads(flax_sub):
    _, v, x = flax_sub
    assert j_supports_fast(v)
    model = _port(v).eval()
    assert supports_fast(model)
    enc = {k: t for k, t in model.state_dict().items() if not k.startswith(("up", "outc"))}
    gauss2 = load_reference_state_dict(build_model("SuperPointNet_gauss2", device="cpu"), enc)
    got = best_apply_fn(model, device="cpu")(torch.from_numpy(x))
    want = make_fast_apply(gauss2, device="cpu")(torch.from_numpy(x))
    assert set(got) == {"semi", "desc"}
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    heat = rng.uniform(size=(B, H, W)).astype(np.float32) ** 4
    pts = np.round(rng.uniform([0, 0], [W - 1, H - 1], size=(B, 20, 2))).astype(np.float32)
    res = rng.uniform(-0.5, 0.5, size=(B, 20, 2)).astype(np.float32)
    valid = rng.uniform(size=(B, 20)) < 0.7
    residual_loss = jax.jit(j_residual_loss)
    want = [float(residual_loss(*map(jnp.asarray, (heat[i], pts[i], res[i], valid[i]))))
            for i in range(B)]
    got = subpixel_residual_loss(*map(torch.from_numpy, (heat, pts, res, valid)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)

    pred = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    labels_res = rng.uniform(-0.5, 0.5, size=(B, H, W, 2)).astype(np.float32)
    labels = (rng.uniform(size=(B, H, W, 1)) < 0.05).astype(np.float32)
    want, gwant = jax.jit(jax.value_and_grad(j_map_loss))(
        jnp.asarray(pred), jnp.asarray(labels_res), jnp.asarray(labels))
    p = torch.tensor(pred, requires_grad=True)
    got = subpixel_map_loss(p, torch.from_numpy(labels_res), torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    gw = np.asarray(gwant)
    np.testing.assert_allclose(p.grad.numpy(), gw, atol=1e-5 * np.abs(gw).max(), rtol=0)


def test_train_step_matches_jax(flax_sub, tmp_path):
    jm, _, _ = flax_sub
    rng = np.random.default_rng(2)
    imgs = rng.uniform(size=(B, H, W)).astype(np.float32)
    pts = rng.uniform([0, 0], [W - 1, H - 1], size=(B, 25, 2)).astype(np.float32)
    jbatch = jax.jit(j_prepare_batch)(jax.random.key(4), imgs, pts, np.ones((B, 25), bool))
    state = jax.jit(lambda key: create_train_state(jm, key, (1, H, W, 1), learning_rate=LR,
                                                   max_steps=10))(jax.random.key(0))
    config = {"model": {"name": "SubpixelNet", "batch_size": B, "learning_rate": LR,
                        "params": {"dtype": "float32"}, "lambda_subpix": 1.0},
              "data": {"preprocessing": {"resize": [H, W]}}, "train_iter": 10}
    agent = registry.get("agent", "Train_model_subpixel")(
        config, save_path=ExperimentPaths("sub", tmp_path), device="cpu")
    load_reference_state_dict(agent.state.model, flax_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}))
    before = {n: p.detach().clone() for n, p in agent.state.model.named_parameters()}
    jstep, jeval = make_subpixel_train_step(donate=False)
    jval = jeval(state, jbatch, jax.random.key(0))
    new_state, jmetrics = jstep(state, jbatch, jax.random.key(0))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    val = agent.eval_batch(batch)
    metrics = agent.step(batch)
    assert set(metrics) == set(jmetrics) == {"loss", "loss_det", "loss_desc", "loss_subpix"}
    for got, want in ((metrics, jmetrics), (val, jval)):
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-8, err_msg=k)
    assert float(metrics["loss_subpix"]) > 0
    sd = agent.state.model.state_dict()
    for k, w in flax_to_state_dict({"batch_stats": new_state.batch_stats}).items():
        assert float((sd[k] - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-12), k
    np.testing.assert_array_equal(np.asarray(new_state.etas), np.asarray(state.etas))
    assert agent.state.etas.tolist() == np.asarray(state.etas).tolist()
    jparams = flax_to_state_dict({"params": new_state.params})
    for k in ("outc.weight", "outc.bias"):
        np.testing.assert_allclose((sd[k] - before[k]).numpy(),
                                   (jparams[k] - before[k]).numpy(), atol=1e-6, rtol=0)


def test_val_agent_run_and_refine_points(flax_sub):
    jm, v, x = flax_sub
    jagent = JSubpixelValAgent(jm, v)
    agent = SubpixelValAgent(build_model("SubpixelNet", device="cpu", dtype=torch.float32),
                             flax_to_state_dict(v), device="cpu")
    want, got = jagent.run(jnp.asarray(x)), agent.run(x)
    assert set(got) == set(want) == {"semi", "desc", "subpixel", "heatmap"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, rtol=0)
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.uniform(-3, W + 3, (B, 40, 1)), rng.uniform(-3, H + 3, (B, 40, 1)),
                          rng.uniform(size=(B, 40, 1))], -1).astype(np.float32)
    pts[0, :4, :2] = [[4.5, 5.5], [5.5, 6.5], [0.5, 0.5], [W - 0.5, H - 0.5]]  # ties of the round
    want = np.asarray(jagent.refine_points(jnp.asarray(x), jnp.asarray(pts)))
    got = agent.refine_points(x, pts).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(got[..., 2], pts[..., 2])
