"""The port's single-program dispatches on the CPU: the two-pass warp split
into a host plan and a device apply, the HA ``one_dispatch`` chain, the
device-corpus and host-loader loops with ``steps_per_dispatch``, the
trainer's step on static inputs and ``prepare_batch`` split into its host
prologue and device body.  On a card the chains run as CUDA graphs
(``ssp_torch.graphs``; ``tests/test_torch_cuda.py`` holds the graphs against
the eager chains there); here they run eagerly, which is what a graph
replays.

Bars: the warp's rotation is a gather, a copy of the passes' values, so it is
equal bit for bit to ``torch.rot90`` per warp.  The port's ``one_dispatch``
against the JAX package's: the bars of ``tests/test_torch_ha.py`` (the two
fp32 forwards differ by ~2e-4 on semi: ≥ 95% of either side's valid points
on the other within 1e-3 px, scores within 1e-4).  ``one_dispatch`` against
the port's staged chain: valid flags equal and points within 1e-4, the JAX
package's own bar for its two modes (``tests/test_export_eval.py``): the
same sums in another order.  The loops with 4 steps per dispatch against 1,
the step on static inputs against ``prepare`` and ``step``, and the split
``prepare_batch`` against the one before the split: equal bit for bit, on
one CPU thread (with several, PyTorch's CPU reductions and scatters take
another order from run to run).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ssp.core.homography import sample_homographies as j_sample
from ssp.export.homography_adaptation import make_ha_fn as j_make_ha_fn
from ssp_torch import registry
from ssp_torch.bench import structured_images
from ssp_torch.data.pipeline import prepare_batch, prepare_body, prepare_prologue
from ssp_torch.export import make_ha_fn
from ssp_torch.kernels import warp_twopass
from ssp_torch.kernels.vresample import vresample_coef
from ssp_torch.models.fast_infer import best_apply_fn
from ssp_torch.train.trainer import TrainAgent
from ssp_torch.utils.experiment import ExperimentPaths
from test_torch_ha import PARAMS, _matched, jax_model, model  # noqa: F401  (fixtures)
from test_torch_train_agent import _config, _write_tree

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_dispatch" / "prepare_batch_a26c442.npz"
# prepare_batch's routes: (warp, warp_twopass.COEF_GRIDS)
ROUTES = {"coef": ("twopass", True), "rows": ("twopass", False), "gather": ("gather", True)}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _homography(deg: float, rng) -> np.ndarray:
    """A rotation by ``deg`` about the centre with a little shift, scale and
    perspective, on [-1, 1]² normalised coordinates."""
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    H = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    H[:2, :2] *= rng.uniform(0.9, 1.1)
    H[:2, 2] = rng.uniform(-0.1, 0.1, 2)
    H[2, :2] = rng.uniform(-0.05, 0.05, 2)
    return H.astype(np.float32)


@pytest.mark.parametrize("coef", [True, False], ids=["coef_route", "rows_route"])
def test_twopass_apply_rotates_on_the_device_as_rot90(coef, monkeypatch):
    """The plan's buckets cover all four rotations; the apply's one gather
    equals ``torch.rot90(mid[n], k[n])[:H, :W]`` per warp bit for bit, and
    ``inv_warp_image_twopass`` is the plan followed by the apply."""
    monkeypatch.setattr(warp_twopass, "COEF_GRIDS", coef)
    rng = np.random.default_rng(3)
    H, W = 40, 56
    img = torch.from_numpy(rng.uniform(size=(2, H, W)).astype(np.float32))
    Hm = torch.from_numpy(np.stack([_homography(d + rng.uniform(-20, 20), rng)
                                    for d in (0, 90, 180, 270, 270, 180, 90, 0)]))
    plan = warp_twopass.twopass_plan(Hm, H, W)
    assert set(plan["k"].tolist()) == {0, 1, 2, 3}
    assert all(v.device.type == "cpu" for v in plan.values())
    canvas = warp_twopass._canvas(img)
    S = canvas.shape[-1]
    if coef:
        mid = vresample_coef(vresample_coef(canvas, plan["coef1"], axis=0), plan["coef2"], axis=1)
    else:
        keep = warp_twopass._keep_masks(plan["bounds"], S, img.device)
        mid = warp_twopass._twopass_square(canvas, plan["Hres"], *keep)
    want = torch.stack([torch.rot90(mid[n], int(k), (0, 1))[:H, :W]
                        for n, k in enumerate(plan["k"])])
    got = warp_twopass.twopass_apply(img, plan)
    assert torch.equal(got, want)
    assert torch.equal(warp_twopass.inv_warp_image_twopass(img, Hm), got)


@pytest.mark.parametrize("aggregation,filter_counts,subpixel",
                         [("sum", 0, True), ("max", 2, False)],
                         ids=["sum_subpixel", "max_filter_counts"])
def test_one_dispatch_matches_jax_one_dispatch(jax_model, model,  # noqa: F811
                                               aggregation, filter_counts, subpixel,
                                               one_thread):
    """The port's ``one_dispatch`` against the JAX package's at the JAX test's
    shape (3×48×64, num_h 6, chunk 4: one warp of each image per chunk),
    gather warp, fp32, with the homographies that the JAX keys give."""
    jmodel, variables = jax_model
    common = dict(num_h=6, chunk=4, top_k=50, use_twopass=False, aggregation=aggregation,
                  filter_counts=filter_counts, subpixel=subpixel, one_dispatch=True)
    images = structured_images(3, 48, 64, 6)[..., 0]
    keys = jax.random.split(jax.random.key(9), 3)
    want_pts, want_valid = j_make_ha_fn(jmodel.apply, variables, **common)(keys,
                                                                          jnp.asarray(images))
    want_pts, want_valid = np.asarray(want_pts), np.asarray(want_valid)
    Hs = np.stack([np.array(j_sample(k, 5, shift=-1.0, **PARAMS)) for k in keys])
    ha = make_ha_fn(best_apply_fn(model, enable=False, device="cpu"), device="cpu", **common)
    pts, valid = ha(torch.from_numpy(images), homographies=torch.from_numpy(Hs))
    pts, valid = pts.numpy(), valid.numpy()
    tol = 1e-3 if subpixel else 0.0
    for g in range(3):
        assert want_valid[g].sum() >= 5
        for a, b in (((want_pts[g], want_valid[g]), (pts[g], valid[g])),
                     ((pts[g], valid[g]), (want_pts[g], want_valid[g]))):
            share, dscore = _matched(*a, *b, tol)
            assert share >= 0.95 and dscore <= 1e-4, (g, share, dscore)


@pytest.mark.parametrize("use_twopass", [True, False], ids=["twopass", "gather"])
def test_one_dispatch_matches_the_staged_chain(model, use_twopass, one_thread):  # noqa: F811
    """``one_dispatch`` against the staged chain on the same homographies:
    valid equal, points within 1e-4; with one image per group (one chunk
    holds its warps) the same bits."""
    apply_fn = best_apply_fn(model, enable=False, device="cpu")
    images = torch.from_numpy(structured_images(3, 48, 64, 7)[..., 0])
    for G, chunk in ((3, 4), (1, 100)):
        common = dict(device="cpu", num_h=6, chunk=chunk, top_k=50, subpixel=True,
                      use_twopass=use_twopass)

        def gens():
            return [torch.Generator().manual_seed(20 + g) for g in range(G)]

        a_pts, a_valid = make_ha_fn(apply_fn, one_dispatch=True, **common)(images[:G],
                                                                           generator=gens())
        b_pts, b_valid = make_ha_fn(apply_fn, **common)(images[:G], generator=gens())
        assert a_valid.sum() >= 5 * G
        assert torch.equal(a_valid, b_valid)
        if G == 1:
            assert torch.equal(a_pts, b_pts)
        else:
            torch.testing.assert_close(a_pts, b_pts, atol=1e-4, rtol=0)


def _loop_run(tmp: Path, spd: int, source: str = "corpus"):
    """The cut flagship (ssmall-133, warped pair, photometric, sparse loss,
    Kendall; fp32 at 64×96, batch 2) for 8 steps with ``spd`` steps per
    dispatch, its batches sampled from the device corpus or read by the host
    loader (``source``); (agent, the logged training rows)."""
    cfg = _config(tmp / "data")
    cfg["model"].update(batch_size=2, real_batch_size=2)
    cfg.update(steps_per_dispatch=spd, train_iter=8, tensorboard_interval=1,
               validation_interval=100, save_interval=100)
    cfg.pop("pretrained")
    exper = ExperimentPaths(f"{source}{spd}", tmp)
    agent = TrainAgent(cfg, save_path=exper, device="cpu")
    data = {k: v for k, v in cfg["data"].items() if k != "dataset"}
    train_set = registry.get("dataset", cfg["data"]["dataset"])(task="train", **data)
    if source == "corpus":
        agent.attach_device_corpus(train_set)
    else:
        agent.train_loader = train_set.batches(2, shuffle=True, seed=0)
    assert not agent.graphed()
    agent.train()
    rows = [json.loads(line) for line in (exper.root / "metrics_train.jsonl").read_text()
            .splitlines()]
    return agent, rows


def _assert_four_equal_one(tmp: Path, source: str):
    """``source``'s loop with 4 steps per dispatch against 1 over the same 8
    steps and seeds: parameters, ηs, BatchNorm statistics and the step
    count equal, and each logged row (the dispatch's last step, as the JAX
    trainer's scan returns) equal to that step's row of the one-step run.
    Returns the 4-step agent."""
    one, rows1 = _loop_run(tmp, 1, source)
    four, rows4 = _loop_run(tmp, 4, source)
    assert one.state.step == four.state.step == 8 and four.n_iter == 8
    for (k, a), b in zip(one.state.model.state_dict().items(),
                         four.state.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(one.state.etas, four.state.etas)
    assert [r["step"] for r in rows1] == list(range(8)) and [r["step"] for r in rows4] == [0, 4]
    for r in rows4:
        want = rows1[r["step"] + 3]
        assert {k: v for k, v in r.items() if k.startswith(("loss", "eta", "positive",
                                                             "negative"))} == \
            {k: v for k, v in want.items() if k.startswith(("loss", "eta", "positive",
                                                            "negative"))}
    return four


def test_steps_per_dispatch_equals_one_step_per_dispatch(tmp_path, one_thread):
    """The device-corpus loop with 4 steps per dispatch against 1
    (:func:`_assert_four_equal_one`)."""
    _write_tree(tmp_path / "data")
    _assert_four_equal_one(tmp_path, "corpus")


def test_host_loader_steps_per_dispatch_equals_one_step_per_dispatch(tmp_path, one_thread):
    """The host loader's loop (the JAX trainer's ``multi_train_step``) with 4
    steps per dispatch against 1 over the same 8 batches and seeds
    (:func:`_assert_four_equal_one`), the loader's wait counted."""
    _write_tree(tmp_path / "data")
    four = _assert_four_equal_one(tmp_path, "loader")
    assert four.device_corpus is None and four.loader_wait_s > 0


def test_region_step_on_static_inputs_equals_prepare_and_step(tmp_path, one_thread):
    """The trainer's step on its host inputs (``TrainAgent._inputs``: the
    prologue and the loader's batch), read from one packed buffer as a
    graph's static inputs are and called eagerly, against ``prepare`` then
    ``step`` on the same batch from the same state and seeds: metrics,
    parameters, BatchNorm statistics and ηs equal bit for bit."""
    _write_tree(tmp_path / "data")
    cfg = _config(tmp_path / "data")
    cfg["model"].update(batch_size=2, real_batch_size=2)
    cfg.pop("pretrained")
    data = {k: v for k, v in cfg["data"].items() if k != "dataset"}
    train_set = registry.get("dataset", cfg["data"]["dataset"])(task="train", **data)
    host = next(train_set.batches(2, shuffle=True, seed=0))
    a = TrainAgent(cfg, save_path=ExperimentPaths("a", tmp_path), device="cpu")
    b = TrainAgent(cfg, save_path=ExperimentPaths("b", tmp_path), device="cpu")
    want = a.step(a.prepare(host))
    b.train_loader = iter([host])
    inputs = b._inputs()
    assert sorted(k for k in inputs if k.startswith("raw.")) == [
        "raw.image", "raw.points", "raw.points_valid", "raw.sem"]
    packed = torch.cat([v.reshape(-1).view(torch.uint8) for v in inputs.values()])
    views, at = {}, 0
    for name, v in inputs.items():
        n = v.numel() * v.element_size()
        views[name] = packed[at:at + n].view(v.dtype).view(v.shape)
        at += n
    got = b._region_step(views)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (k, x), y in zip(a.state.model.state_dict().items(), b.state.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.equal(a.state.etas, b.state.etas) and a.state.step == b.state.step == 1


def _prep_inputs():
    """(args, kwargs) of one flagship-like ``prepare_batch`` call at 2×32×48:
    every photometric primitive, homographic augmentation, the warped pair,
    the Gaussian label spread and the bilinear class-id warp."""
    rng = np.random.default_rng(11)
    B, H, W = 2, 32, 48
    cfg = yaml.safe_load((ROOT / "configs" / "pipeline240_wsem_200k.yaml").read_text())["data"]
    args = (torch.from_numpy(rng.uniform(size=(B, H, W)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 40, (B, 25, 2)).astype(np.float32)),
            torch.from_numpy(rng.uniform(size=(B, 25)) < 0.8))
    kw = dict(sem=torch.from_numpy(rng.integers(0, 134, (B, H, W)).astype(np.int32)),
              photometric=dict(cfg["augmentation"]["photometric"], enable=True,
                               primitives=None),
              homographic={"enable": True, "params": {}, "valid_border_margin": 3},
              warped_pair=cfg["warped_pair"], gaussian_label_sigma=0.2,
              generator=torch.Generator().manual_seed(1),
              host_generator=torch.Generator().manual_seed(2))
    return args, kw


@pytest.mark.parametrize("route", list(ROUTES))
def test_prepare_batch_split_keeps_its_bits(route, monkeypatch, one_thread):
    """``prepare_batch`` equals the batch written by the one before the split
    (the fixture), and equals its prologue then its body called by hand, the
    body reading the prologue's tensors from one packed buffer as a graph's
    static inputs are; a second body from the same prologue and seeds gives
    the same bits."""
    warp, coef = ROUTES[route]
    monkeypatch.setattr(warp_twopass, "COEF_GRIDS", coef)
    args, kw = _prep_inputs()
    got = prepare_batch(*args, warp=warp, **kw)
    with np.load(FIXTURE) as want:
        keys = sorted(k.split("/", 1)[1] for k in want.files if k.startswith(route + "/"))
        assert sorted(got) == keys
        for k in keys:
            np.testing.assert_array_equal(got[k].numpy(), want[f"{route}/{k}"], err_msg=k)

    args, kw = _prep_inputs()
    B, H, W = args[0].shape
    host_generator = kw.pop("host_generator")
    prologue = prepare_prologue(B, (H, W), "cpu", homographic=kw["homographic"],
                                warped_pair=kw["warped_pair"], host_generator=host_generator,
                                warp=warp)
    assert all(v.device.type == "cpu" for v in prologue.values())
    assert ("homographic.k" in prologue) == (warp == "twopass")
    packed = torch.cat([v.reshape(-1).view(torch.uint8) for v in prologue.values()])
    views, at = {}, 0
    for name, v in prologue.items():
        n = v.numel() * v.element_size()
        views[name] = packed[at:at + n].view(v.dtype).view(v.shape)
        at += n
    for source in (prologue, views):
        kw["generator"] = torch.Generator().manual_seed(1)
        body = prepare_body(*args, source, **kw)
        assert sorted(body) == sorted(got)
        for k in got:
            assert torch.equal(body[k], got[k]), k


def test_cuda_graph_regions_refuse_the_cpu():
    from ssp_torch.graphs import CapturedRegion

    with pytest.raises(ValueError, match="CUDA device"):
        CapturedRegion(lambda b: b, {"x": torch.zeros(2)}, device="cpu")


def test_capturable_checkpoint_resumes_on_the_cpu(tmp_path, one_thread):
    """A checkpoint of a capturable state (as the graphed loop saves one on a
    card: every group capturable, a tensor lr) resumes into a CPU state,
    which takes its next step as from the same checkpoint saved without
    those keys: the same parameters, ηs, lr and step count."""
    from ssp_torch.models.superpoint import build_model
    from ssp_torch.train import TrainState
    from ssp_torch.train.checkpoint import load_checkpoint, save_checkpoint

    def fresh():
        model = build_model("SuperPointNet_gauss2", device="cpu",
                            generator=torch.Generator().manual_seed(0))
        return TrainState.create(model.train(), learning_rate=0.01, max_steps=10)

    def step(st, seed):
        g = torch.Generator().manual_seed(seed)
        for p in st.optimizer.param_groups[0]["params"]:
            p.grad = torch.randn(p.shape, generator=g)
        st.optimizer.step()
        st.finish_update()

    st = fresh()
    step(st, 0)
    plain = save_checkpoint(tmp_path / "plain", st, 1)
    for group in st.optimizer.param_groups:
        group["capturable"], group["lr"] = True, torch.tensor(float(group["lr"]))
    card = save_checkpoint(tmp_path / "card", st, 1)
    resumed = {}
    for name, path in (("plain", plain), ("card", card)):
        r = load_checkpoint(path, fresh(), mode="full")
        assert not r.capturable and r.step == 1
        assert all(g["capturable"] is False and isinstance(g["lr"], float)
                   for g in r.optimizer.param_groups)
        step(r, 1)
        resumed[name] = r
    a, b = resumed["plain"], resumed["card"]
    assert a.step == b.step == 2
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]
    assert torch.equal(a.etas, b.etas)
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    with pytest.raises(ValueError, match="CUDA device"):
        a.set_capturable(True)
