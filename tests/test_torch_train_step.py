"""Port parity: training-mode forwards and train steps of the port against the
JAX package, fp32 unless a test says otherwise.

* **Train mode.**  One training-mode forward of ``SuperPointNet_gauss2_ssmall``
  (133 classes, the real widths) from the same flax-initialised weights:
  ``semi``, ``desc`` and ``sem_coarse`` within 2e-4 (the fp32 forward bar of
  ``tests/test_torch_weights.py``: convolutions summed in another order), and
  every running mean and variance within 1e-5 of its leaf's largest
  magnitude.  The running variance moves towards the *biased* batch
  variance, as flax's does; ``nn.BatchNorm2d``'s unbiased update is off by
  0.1·var/(n−1), 5e-4 of the value at n = 192 cells.
* **bf16.**  The module at ``dtype=bfloat16`` against the flax module at its
  default bf16, never against fp32: each output within 5% of its largest
  magnitude, and on average within 0.8% in training mode (flax at bf16 is
  1.0% from flax at fp32 on the same input: single bf16 roundings flipped by
  fp32 statistics summed in another order, carried through ten layers) and
  0.5% in evaluation mode.
* **Three train steps** on one batch the JAX package prepared, with the JAX
  step's own descriptor draws fed in, from two starting points: the flax
  initialisation and the trained weights of ``evidence/wsem_weights.npz``
  (for ``SuperPointNet_gauss2``, its leaves without the semantic head).  The
  port runs them twice: *synced* (set to the JAX state, Adam's moments
  included, before each step) and *chained* (on its own).  Three variants of
  the step, as the configs set it up:

  - the flagship's (``ssmall``-133: warped pair, semantics, Gaussian labels,
    sparse descriptor loss, Kendall over three tasks);
  - stage 1's (``pipeline240_magicpoint.yaml``: gauss2, the detector alone,
    ``lambda_loss`` 0, no warped pair, no Kendall; the batch through the
    config's homographic augmentation);
  - gauss2 joint training's (``pipeline240_joint.yaml`` and
    ``superpoint_synth_joint*.yaml``: warped pair, sparse descriptor loss,
    Kendall over the two tasks, no semantics; the flagship's warped pair,
    which is ``pipeline240_joint.yaml``'s).

  The two gauss2 variants run from the trained weights at fp64 on both
  sides (x64 JAX, the flax module's fixed fp32 read as fp64; the port's
  module and state in fp64), at the same bars.  At fp32, without the
  semantic loss, the first block's gradient is dominated by cells whose
  softmax sits within an ulp or two of the BCE's clip (the random labels
  against a confident detector), and its cosine to JAX's falls under the
  bar below; at fp64 the clip is resolved and the two sides agree.  Run
  this file (``PYTHONPATH=.:tests python tests/test_torch_train_step.py``)
  to print the first step's least gradient cosines of both variants at
  fp32 and at fp64.

  - Metrics: every synced step at rel 1e-4, and the chained first step.
    From the trained weights the detector terms (and the η_det gradient)
    get rel 2e-3: the network is sure of its dustbin there, the softmax lies
    within an fp32 ulp or two of 1, where the BCE's clip sits (1 − 1e-7 is
    two ulps below 1), and ``log(1 − p)`` then follows the last ulp of two
    libraries' exponentials (measured: 1.2e-3).  Chained steps after the
    first within 2e-2: Adam's first update is about ±lr per entry whatever
    the gradient's size, so an entry whose gradient sign differs moves by
    2·lr and the two runs drift.
  - First-step gradients (JAX's recovered from Adam's first moment, μ =
    0.1·g): the 13 conv biases that feed a BatchNorm have a zero gradient
    but for noise (both sides under 1e-5 of the model's largest gradient).
    From the initialisation, every leaf after down3's max pool within 1e-4
    of its largest magnitude, and every leaf before it at cosine ≥ 0.9998
    and within 15%: at a near-tie of a 2×2 max the last bit decides where
    the gradient goes (JAX's own fp32 gradient is up to 4.8% off an fp64 one
    there).  From the trained weights, cosine ≥ 0.99 (the saturated cells
    above pass the gradient on one side and clip it on the other).
  - The ηs and every BatchNorm statistic after each synced step within
    1e-5; the lr of each update is optax's at the count before it.
  - Parameters after three chained steps: every entry within 3× the steps'
    total lr, the median within 5% of it.
"""

import contextlib
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ssp.data.pipeline import prepare_batch as j_prepare_batch
from ssp.models import build_model as j_build_model
from ssp.models import superpoint as j_superpoint
from ssp.train.state import create_train_state
from ssp.train.step import make_train_step
from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import flax_to_state_dict, load_flax_npz, load_reference_state_dict
from ssp_torch.train import TrainState, polynomial_decay, train_step
from test_torch_losses import jax_sparse_draws
from test_torch_threads import torch_threads

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "evidence" / "wsem_weights.npz"
B, H, W = 2, 64, 96
LR, MAX_STEPS, STEPS = 0.0025, 10, 3
M, N = 1000, 100
PAIR = {"enable": True, "valid_border_margin": 3, "params": {
    "translation": True, "rotation": True, "scaling": True, "perspective": True,
    "scaling_amplitude": 0.2, "perspective_amplitude_x": 0.2, "perspective_amplitude_y": 0.2,
    "patch_ratio": 0.85, "max_angle": 0.785, "allow_artifacts": True}}
STEP_KW = dict(semantic=True, warped_pair=True, det_loss_type="softmax", desc_loss="sparse",
               desc_params={"num_matching_attempts": M, "num_masked_non_matches_per_match": N,
                            "lamda_d": 1.0, "method": "2d"},
               lambda_loss=1.0, multi_task=True, ignore_class=133, sem_fused=True)
_STAGE1 = yaml.safe_load((ROOT / "configs" / "pipeline240_magicpoint.yaml").read_text())["data"]
# model, its keyword arguments, the step's keywords, prepare_batch's keywords
VARIANTS = {
    "flagship": ("SuperPointNet_gauss2_ssmall", {"n_classes": 133}, STEP_KW,
                 {"warped_pair": PAIR, "gaussian_label_sigma": 0.2}),
    "stage1": ("SuperPointNet_gauss2", {}, dict(
        STEP_KW, semantic=False, warped_pair=False, lambda_loss=0.0, multi_task=False),
        {"homographic": _STAGE1["augmentation"]["homographic"]}),
    "gauss2_joint": ("SuperPointNet_gauss2", {}, dict(STEP_KW, semantic=False),
                     {"warped_pair": PAIR}),
}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads (``tests/test_torch_threads.py``), not one: on
    one, PyTorch's fp32 matmul sums the flagship's non-match dot products in
    another order, and two of them, within an ulp of the hinge's margin,
    cross it (4,995 hard non-matches against 4,997): from the initialisation
    the first step's negative_dist is then rel 3.6e-4 off JAX's (the bar is
    1e-4).  At 2, 3, 4, 6 and 8 threads it is within 1e-6 of JAX's."""
    with torch_threads(2):
        yield


def _tree(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _leaf_close(got: dict, want: dict, bar: float, what: str):
    assert set(got) == set(want), what
    for k in want:
        w = want[k].numpy()
        err = float(np.abs(got[k].detach().numpy() - w).max())
        assert err <= bar * max(float(np.abs(w).max()), 1e-12), (what, k, err)


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _input():
    return np.random.default_rng(0).uniform(size=(B, H, W, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def x():
    return _input()


@functools.lru_cache(maxsize=None)
def _flax_init(jdtype):
    """The flax module and its initialisation on :func:`x`'s batch, jitted and
    computed once per process for each dtype (the tests share it)."""
    jm = j_build_model("SuperPointNet_gauss2_ssmall", n_classes=133, dtype=jdtype)
    return jm, jax.jit(functools.partial(jm.init, train=True))(jax.random.key(0),
                                                              jnp.asarray(_input()))


def _pair(x, jdtype, tdtype=None, upsample_sem=True):
    """Flax-initialised weights in both modules; one training-mode forward
    of each (flax's jitted).  ``tdtype=None`` builds the port's module with
    its defaults."""
    jm, v = _flax_init(jdtype)
    out, mut = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"],
                                         upsample_sem=upsample_sem))(v, jnp.asarray(x))
    kw = {} if tdtype is None else {"dtype": tdtype}
    model = build_model("SuperPointNet_gauss2_ssmall", device="cpu", n_classes=133, **kw)
    load_reference_state_dict(model, flax_to_state_dict(v))
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)) if upsample_sem else model(torch.from_numpy(x),
                                                                     upsample_sem=False)
    return got, out, model, mut


def test_train_mode_forward_and_batch_stats_match_flax(x):
    """The module as built by default (fp32): outputs at the fp32 bars (sem,
    ×8 upsampled logits of larger magnitude, at 2e-3) and the running
    statistics after one training-mode forward."""
    got, want, model, mut = _pair(x, jnp.float32)
    assert set(got) == {"semi", "desc", "sem"} == set(want)
    for k, atol in (("semi", 2e-4), ("desc", 2e-4), ("sem", 2e-3)):
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0)
    want_stats = flax_to_state_dict({"batch_stats": mut["batch_stats"]})
    _leaf_close(_stats(model.state_dict()), want_stats, 1e-5, "batch_stats")


def test_training_forward_sem_coarse_matches_flax(x):
    """``upsample_sem=False``: the 1/8-resolution logits, fp32."""
    got, want, _, _ = _pair(x, jnp.float32, torch.float32, upsample_sem=False)
    assert set(got) == {"semi", "desc", "sem_coarse"} == set(want)
    assert got["sem_coarse"].dtype == torch.float32
    assert got["sem_coarse"].shape == (B, H // 8, W // 8, 133)
    np.testing.assert_allclose(got["sem_coarse"].numpy(), np.asarray(want["sem_coarse"]),
                               atol=2e-4, rtol=0)


def test_bf16_forward_matches_flax_bf16(x):
    got, want, model, _ = _pair(x, jnp.bfloat16, torch.bfloat16, upsample_sem=False)
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k]).astype(np.float32)
        assert got[k].dtype == torch.float32, k
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 0.05 * scale, k
        assert np.abs(g - w).mean() <= 0.008 * scale, k
    # eval mode on the trained weights, the full-resolution semantic head
    jm = j_build_model("SuperPointNet_gauss2_ssmall", n_classes=133)
    with np.load(NPZ) as d:
        flat = {k: d[k] for k in d.files}
    want = jax.jit(functools.partial(jm.apply, train=False))(_tree(flat), jnp.asarray(x))
    m = load_flax_npz(NPZ, "SuperPointNet_gauss2_ssmall", device="cpu")
    m.dtype = torch.bfloat16
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    for k in ("semi", "desc", "sem"):
        g, w = got[k].numpy(), np.asarray(want[k]).astype(np.float32)
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 0.05 * scale, k
        assert np.abs(g - w).mean() <= 0.005 * scale, k


def _adam_resync(tstate, jstate, names):
    """The port's state set to the JAX state: parameters, BatchNorm
    statistics, ηs and Adam's moments (the step count is already equal)."""
    load_reference_state_dict(tstate.model, flax_to_state_dict(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    adam = jstate.opt_state[0]
    mu = flax_to_state_dict({"params": adam.mu["params"]})
    nu = flax_to_state_dict({"params": adam.nu["params"]})
    count = float(adam.count)
    with torch.no_grad():
        tstate.etas.copy_(torch.from_numpy(np.array(jstate.etas)))
    moments = {**{n: (mu[n], nu[n]) for n in names},
               "etas": (torch.from_numpy(np.array(adam.mu["etas"])),
                        torch.from_numpy(np.array(adam.nu["etas"])))}
    params = dict(tstate.model.named_parameters(), etas=tstate.etas)
    for n, (m, v) in moments.items():
        tstate.optimizer.state[params[n]] = {"step": torch.tensor(count),
                                             "exp_avg": m.clone(), "exp_avg_sq": v.clone()}


@contextlib.contextmanager
def _fp64(on: bool):
    """With ``on``, JAX at fp64 throughout: x64 enabled, and the flax
    module's fixed fp32 (its parameters, BatchNorm, the heads' outputs) read
    as fp64 through a stand-in for the module's ``jnp``."""
    if not on:
        yield
        return

    class Jnp64:
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    saved = j_superpoint.jnp
    j_superpoint.jnp = Jnp64()
    try:
        with jax.enable_x64(True):
            yield
    finally:
        j_superpoint.jnp = saved


def _steps(variant, weights, fp64=False):
    """Three JAX train steps (flax at fp32, or both sides at fp64) of
    ``variant`` from the flax initialisation or from the trained weights, on
    one JAX-prepared batch; the same three on the port twice, with the JAX
    step's descriptor draws: chained (each side on its own) and
    resynchronised (the port set to the JAX state before each step).  At
    fp64 the homographies stay fp32 on both sides, as the port's descriptor
    loss reads them."""
    with _fp64(fp64):
        return _run_steps(variant, weights, fp64)


# (variant, fp64) whose prepare_batch stays eager: under ``jit`` the warped
# pair's homography moves by an ulp (H_pair up to 1.2e-7), and from the
# initialisation the first step's negative_dist then reads 0.058065 in JAX and
# 0.058044 in the port, rel 3.6e-4 apart (the bar is 1e-4): the two values of
# the hard non-matches' count seen on one thread (:func:`_two_threads`)
EAGER_PREPARE = {("flagship", False), ("gauss2_joint", False)}


@functools.lru_cache(maxsize=None)
def _jax_batch(variant, fp64):
    """``variant``'s batch, prepared by the JAX package (under ``jit`` as its
    trainer prepares one, ``ssp/train/trainer.py``'s ``prep``, but for
    :data:`EAGER_PREPARE`); computed once per process for each variant and
    precision (at fp64 inside :func:`_fp64`)."""
    _, _, step_kw, prep_kw = VARIANTS[variant]
    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(B, H, W)).astype(np.float32)
    imgs[:, 8:40, 16:60] *= 0.3
    pts = rng.uniform([0, 0], [W - 1, H - 1], size=(B, 60, 2)).astype(np.float32)
    valid = np.ones((B, 60), bool)
    sem = rng.integers(0, 134, size=(B, H // 8, W // 8)).repeat(8, 1).repeat(8, 2).astype(np.int32)
    prepare = functools.partial(j_prepare_batch, **prep_kw)
    if (variant, fp64) not in EAGER_PREPARE:
        prepare = jax.jit(prepare)
    jbatch = prepare(jax.random.key(3), imgs, pts, valid, sem=sem if step_kw["semantic"] else None)
    if fp64:
        jbatch = {k: v.astype(jnp.float64) if v.dtype == jnp.float32 and k != "H_pair" else v
                  for k, v in jbatch.items()}
    return jbatch


@functools.lru_cache(maxsize=None)
def _jax_init_state(name, model_kw, fp64):
    """``create_train_state`` of the flax module, jitted; once per process for
    each model and precision (the two gauss2 variants share it)."""
    jm = j_build_model(name, dtype=jnp.float64 if fp64 else jnp.float32, **dict(model_kw))
    return jax.jit(lambda key: create_train_state(jm, key, (1, H, W, 1), learning_rate=LR,
                                                  max_steps=MAX_STEPS))(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _trained_tree():
    with np.load(NPZ) as d:
        return _tree({k: d[k] for k in d.files})


@jax.jit
def _widen(state):
    """The state at fp64, its optimizer state made afresh for it."""
    wide = functools.partial(jax.tree.map, lambda v: v.astype(jnp.float64))
    params, etas = wide(state.params), wide(state.etas)
    return state.replace(params=params, batch_stats=wide(state.batch_stats), etas=etas,
                         opt_state=state.tx.init({"params": params, "etas": etas}))


def _run_steps(variant, weights, fp64):
    name, model_kw, step_kw, _ = VARIANTS[variant]
    jbatch = _jax_batch(variant, fp64)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}

    state = _jax_init_state(name, tuple(model_kw.items()), fp64)
    if weights == "trained":
        tree = _trained_tree()
        # gauss2: the trained modules it has (all but the semantic head)
        params = {k: tree["params"][k] for k in state.params}
        stats = {k: tree["batch_stats"][k] for k in state.batch_stats}
        state = state.replace(params=params, batch_stats=stats)
    if fp64:
        state = _widen(state)
    jstep, _ = make_train_step(donate=False, **step_kw)

    def port_state():
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        if not fp64:
            model = load_flax_npz(variables, name, device="cpu").train()
            return TrainState.create(model, learning_rate=LR, max_steps=MAX_STEPS)
        model = build_model(name, device="cpu", dtype=torch.float64, **model_kw).double()
        load_reference_state_dict(model, flax_to_state_dict(variables))
        ts = TrainState.create(model.train(), learning_rate=LR, max_steps=MAX_STEPS)
        ts.etas.data = ts.etas.data.double()
        return ts

    chained, synced = port_state(), port_state()
    names = [n for n, _ in chained.model.named_parameters()]
    recs = []
    for i in range(STEPS):
        key = jax.random.key(100 + i)
        draws = (jax_sparse_draws(key, np.asarray(jbatch["H_pair"]), (H // 8, W // 8), M, N)
                 if step_kw["warped_pair"] else None)
        rec = {"lr": chained.optimizer.param_groups[0]["lr"]}
        if i:
            _adam_resync(synced, state, names)
        before = {n: p.detach().clone() for n, p in synced.model.named_parameters()}
        jbefore = flax_to_state_dict({"params": state.params})
        state, jmetrics = jstep(state, jbatch, key)
        rec["jmetrics"] = {k: float(v) for k, v in jmetrics.items()}
        for tag, ts in (("chained", chained), ("synced", synced)):
            m = train_step(ts, batch, desc_draws=draws, **step_kw)
            rec[tag] = {k: float(v) for k, v in m.items()}
        rec["jstats"] = flax_to_state_dict({"batch_stats": state.batch_stats})
        rec["stats"] = {k: v.clone() for k, v in _stats(synced.model.state_dict()).items()}
        rec["jetas"], rec["etas"] = np.array(state.etas), synced.etas.detach().numpy().copy()
        jafter = flax_to_state_dict({"params": state.params})
        rec["jupdate"] = {n: jafter[n] - jbefore[n] for n in names}
        rec["update"] = {n: p.detach() - before[n] for n, p in synced.model.named_parameters()}
        if i == 0:
            mu = state.opt_state[0].mu  # (1 − β₁)·g after the first update
            rec["jgrads"] = {k: v * 10.0 for k, v in
                             flax_to_state_dict({"params": mu["params"]}).items()}
            rec["jgrad_etas"] = np.array(mu["etas"]) * 10.0
            # None: a head the step's loss leaves out (stage 1's descriptor)
            rec["grads"] = {k: None if p.grad is None else p.grad.clone()
                            for k, p in synced.model.named_parameters()}
            # stage 1 leaves the ηs out of the loss: no gradient (JAX's is 0)
            g = synced.etas.grad
            rec["grad_etas"] = (np.zeros_like(rec["jgrad_etas"]) if g is None
                                else g.numpy().copy())
        recs.append(rec)
    final = {"jparams": flax_to_state_dict({"params": state.params}),
             "params": dict(chained.model.named_parameters()), "step": chained.step}
    return weights, recs, final, step_kw["semantic"]


DETECTOR_TERMS = ("loss", "loss_det", "loss_det_warp")


def _zero_grad_biases(names):
    """Biases of the convs that feed a BatchNorm (all but ``convSout``):
    training-mode BN subtracts them, so their gradient is 0 but for noise."""
    heads = ("convPa", "convPb", "convDa", "convDb", "convDS")
    return {n for n in names if n.endswith(".bias")
            and (n.split(".")[-2] in ("0", "3") or n.split(".")[0] in heads)}


def _check_step_metrics_and_lr(steps):
    weights, recs, final, _ = steps
    sched = optax.polynomial_schedule(init_value=LR, end_value=0.001, power=2,
                                      transition_steps=MAX_STEPS)
    for i, r in enumerate(recs):
        assert r["synced"].keys() == r["jmetrics"].keys() == r["chained"].keys()
        for k, w in r["jmetrics"].items():
            rtol = 2e-3 if (weights == "trained" and k in DETECTOR_TERMS) else 1e-4
            np.testing.assert_allclose(r["synced"][k], w, rtol=rtol, atol=1e-7, err_msg=(i, k))
            # the runs on their own drift apart from the second step on
            # (Adam's first step is about ±lr per entry, whatever the
            # gradient's size: a sign that differs moves an entry by 2·lr)
            np.testing.assert_allclose(r["chained"][k], w, rtol=rtol if i == 0 else 2e-2,
                                       atol=1e-7, err_msg=(i, k))
        np.testing.assert_allclose(r["lr"], float(sched(i)), rtol=1e-6)
    assert final["step"] == STEPS
    for count in (0, 1, 5, 10, 25):
        np.testing.assert_allclose(polynomial_decay(LR, MAX_STEPS)(count), float(sched(count)),
                                   rtol=1e-6)


def _check_first_step_gradients(steps):
    weights, recs, _, semantic = steps
    r = recs[0]
    gmax = max(float(v.abs().max()) for v in r["jgrads"].values())
    zero = _zero_grad_biases(r["jgrads"])
    assert len(zero) == (13 if semantic else 12)  # convDS feeds a BatchNorm too
    for k, want in r["jgrads"].items():
        got = r["grads"][k]
        if got is None:  # left out of the loss: JAX's gradient is exactly 0
            assert float(want.abs().max()) == 0.0, k
            continue
        if k in zero:
            assert float(got.abs().max()) <= 1e-5 * gmax and float(want.abs().max()) <= 1e-5 * gmax
            continue
        cos = float((got * want).sum() / (got.norm() * want.norm()))
        err = float((got - want).abs().max()) / float(want.abs().max())
        if weights == "trained":
            assert cos >= 0.99, (k, cos)
        elif k.startswith(("inc.", "down1.", "down2.")):
            assert cos >= 0.9998 and err <= 0.15, (k, cos, err)
        else:
            assert err <= 1e-4, (k, err)
    np.testing.assert_allclose(r["grad_etas"], r["jgrad_etas"],
                               rtol=2e-3 if weights == "trained" else 1e-4)


def _check_stats_and_etas_after_each_step(steps):
    for r in steps[1]:
        _leaf_close(r["stats"], r["jstats"], 1e-5, "batch_stats")
        np.testing.assert_allclose(r["etas"], r["jetas"], rtol=1e-5)


def _check_parameters_after_three_steps(steps):
    _, _, final, _ = steps
    lr_total = sum(polynomial_decay(LR, MAX_STEPS)(i) for i in range(STEPS))
    diffs = []
    for k, w in final["jparams"].items():
        d = (final["params"][k].detach() - w).abs()
        assert float(d.max()) <= 3.0 * lr_total, k
        diffs.append(d.flatten())
    assert float(torch.cat(diffs).median()) <= 0.05 * lr_total


@pytest.mark.parametrize("variant,weights,fp64", [
    pytest.param("flagship", "init", False, id="init"),
    pytest.param("flagship", "trained", False, id="trained"),
    pytest.param("stage1", "init", False, id="stage1-init"),
    pytest.param("stage1", "trained", True, id="stage1-trained-fp64"),
    pytest.param("gauss2_joint", "init", False, id="gauss2_joint-init"),
    pytest.param("gauss2_joint", "trained", True, id="gauss2_joint-trained-fp64")])
def test_three_train_steps(variant, weights, fp64):
    """Each step's metrics and lr, the first step's gradients, the BatchNorm
    statistics and ηs after each step, the parameters after three (module
    docstring); the flagship's cases keep their ids."""
    steps = _steps(variant, weights, fp64)
    _check_step_metrics_and_lr(steps)
    _check_first_step_gradients(steps)
    _check_stats_and_etas_after_each_step(steps)
    _check_parameters_after_three_steps(steps)


def _first_step_cosines(steps):
    """{leaf: cosine of the port's first-step gradient to JAX's} over the
    leaves the bars compare by cosine."""
    _, recs, _, _ = steps
    r = recs[0]
    zero = _zero_grad_biases(r["jgrads"])
    out = {}
    for k, want in r["jgrads"].items():
        got = r["grads"][k]
        if got is not None and k not in zero:
            out[k] = float((got * want).sum() / (got.norm() * want.norm()))
    return out


if __name__ == "__main__":
    # the first step's gradient cosines from the trained weights, fp32 and
    # fp64, for the two gauss2 variants: the least over the first block
    # (``inc.``) and over every leaf
    for variant in ("stage1", "gauss2_joint"):
        for fp64 in (False, True):
            cos = _first_step_cosines(_steps(variant, "trained", fp64))
            first = min(v for k, v in cos.items() if k.startswith("inc."))
            print(f"{variant} trained {'fp64' if fp64 else 'fp32'}: "
                  f"min cosine inc. {first:.9f}, all leaves {min(cos.values()):.9f}")
