"""The port's trainer and training CLI on the CPU: ``python -m
ssp_torch.cli.train train_joint <config> <exper> --device cpu`` on a
``Coco_sem`` tree the test writes, with the flagship configuration
(``configs/pipeline240_wsem_200k.yaml``) cut to 64×96, batches of 2 with a
real batch of 4 (r = 2), ``steps_per_dispatch`` 2, from the trained weights,
the module at fp32 (``model.params.dtype``, which the JAX trainer reads too;
bf16 convolutions are slow on a CPU, and the bf16 forward has its own test in
``tests/test_torch_train_step.py``).

* every logged loss finite; the rows of ``metrics_train.jsonl`` and
  ``metrics_val.jsonl`` at the JAX trainer's boundaries: its own window test
  (``hits``, taken from ``ssp.train.trainer.TrainAgent.train``) run over its
  loop, with its interval alignment for ``steps_per_dispatch``;
* the checkpoint names (``superPointNet_<it>.pth.tar`` and ``.npz`` at each
  save boundary and at the end); a relaunch auto-resumes from the newest and
  continues the rows; ``--eval`` validates once.  The first run samples from
  the device corpus (the flagship's ``training.device_corpus``), the
  relaunch reads the streaming loader;
* the npz of a port checkpoint loads into the JAX package's
  ``load_weights_npz`` and into the port's ``load_weights``, and the two
  evaluation forwards agree at the fp32 bars (2e-4 on semi and desc, 2e-3
  on sem); a full resume continues a run exactly;
* the options once refused (exact accumulation, the dense loss,
  ``--max-restarts``) now build and dispatch; with ``SSP_DISTRIBUTED`` the
  CLI joins the process group (``tests/test_torch_parallel.py`` runs the
  ranks).
"""

import copy
import functools
import json
import math
import types
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ssp.models import build_model as j_build_model
from ssp.train.checkpoint import load_weights_npz as j_load_weights_npz
from ssp.train.state import create_train_state
from ssp.train.trainer import TrainAgent as JTrainAgent
from ssp.train.trainer import precision_recall as j_precision_recall
from ssp_torch.cli import train as cli
from ssp_torch.data.pipeline import prepare_batch
from ssp_torch.models.weights import load_flax_npz, load_weights
from ssp_torch.train import TrainState, train_step
from ssp_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ssp_torch.train.trainer import TrainAgent, boundary, hits, precision_recall
from ssp_torch.utils.experiment import ExperimentPaths
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "evidence" / "wsem_weights.npz"
H, W = 64, 96


def _jax_hits():
    """``hits`` as the JAX trainer defines it inside ``TrainAgent.train``."""
    code = next(c for c in JTrainAgent.train.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "hits")
    return types.FunctionType(code, {}, "hits", (0,))  # its default: lo=0


def jax_rows(cfg):
    """(train rows, val rows, save points) of the JAX trainer's loop for the
    config's intervals, ``r`` and ``steps_per_dispatch``."""
    m = cfg["model"]
    r = max(int(m.get("real_batch_size", m["batch_size"])) // int(m["batch_size"]), 1)
    iv = {k: int(cfg[k]) * r for k in ("train_iter", "validation_interval",
                                       "tensorboard_interval", "save_interval")}
    spd = max(int(cfg.get("steps_per_dispatch", 1)), 1)
    stride = r * spd
    if spd > 1:
        for k in ("validation_interval", "tensorboard_interval", "save_interval"):
            iv[k] = max(((iv[k] + stride - 1) // stride) * stride, stride)
    h = _jax_hits()
    train, val, save = [], [], []
    n = 0
    while n < iv["train_iter"]:
        n0, n = n, n + stride
        if h(n0, n, iv["tensorboard_interval"]):
            train.append(((n - 1) // iv["tensorboard_interval"]) * iv["tensorboard_interval"])
        if h(n0, n, iv["validation_interval"]):
            val.append(((n - 1) // iv["validation_interval"]) * iv["validation_interval"])
        if h(n0, n, iv["save_interval"], lo=1):
            save.append(((n - 1) // iv["save_interval"]) * iv["save_interval"])
    return train, val, save + [n]


def test_hits_and_boundary_are_the_jax_trainers():
    h = _jax_hits()
    for n0 in range(0, 40):
        for stride in (1, 2, 3, 50):
            for interval in (1, 2, 3, 7, 100):
                for lo in (0, 1):
                    assert hits(n0, n0 + stride, interval, lo) == h(n0, n0 + stride, interval, lo)
    assert boundary(4, 2) == 2 and boundary(1, 1000) == 0 and boundary(12, 4) == 8


def test_precision_recall_is_the_jax_trainers():
    rng = np.random.default_rng(2)
    heat = rng.uniform(size=(2, H, W)) ** 6
    labels = (rng.uniform(size=(2, H, W)) < 0.02).astype(np.float32)
    for thresh in (0.015, 0.3):
        assert precision_recall(heat, labels, thresh) == j_precision_recall(heat, labels, thresh)
    assert precision_recall(np.zeros((4, 4)), np.zeros((4, 4))) == (0.0, 0.0)


def _write_tree(root: Path, n_train=6, n_val=4, seed=0):
    rng = np.random.default_rng(seed)
    for split, n in (("train2017", n_train), ("val2017", n_val)):
        for d in (root / "COCO" / split, root / "ann" / f"semantic_{split}",
                  root / "labels" / split):
            d.mkdir(parents=True)
        for i in range(n):
            stem = f"{i + 1:012d}"
            img = (rng.uniform(size=(75, 110)) * 80).astype(np.uint8)
            img[20:60, 30:90] += 120
            cv2.imwrite(str(root / "COCO" / split / f"{stem}.jpg"), img)
            raw = np.zeros((75, 110), np.uint8)
            raw[:30], raw[30:] = 1, 200
            raw[60:, :20] = 12  # not a panoptic id: ignored
            cv2.imwrite(str(root / "ann" / f"semantic_{split}" / f"{stem}.png"), raw)
            pts = np.concatenate([rng.uniform([0, 0], [W - 1, H - 1], (40, 2)),
                                  rng.uniform(size=(40, 1))], 1)
            np.savez(root / "labels" / split / f"{stem}.npz", pts=pts.astype(np.float32))


def _config(root: Path):
    cfg = yaml.safe_load((ROOT / "configs" / "pipeline240_wsem_200k.yaml").read_text())
    cfg["data"].update(root=str(root / "COCO"), labels=str(root / "labels"),
                       sem_labels=str(root / "ann"))
    cfg["data"]["preprocessing"]["resize"] = [H, W]
    cfg["model"].update(batch_size=2, real_batch_size=4, eval_batch_size=2)
    cfg["model"]["params"]["dtype"] = "float32"
    cfg.update(train_iter=4, tensorboard_interval=1, validation_interval=3, save_interval=2,
               validation_size=1, steps_per_dispatch=2, pretrained=str(NPZ), reset_iter=True)
    return cfg


def _run(tmp):
    """One CLI run, a relaunch that auto-resumes, and an ``--eval`` run."""
    _write_tree(tmp / "data")
    cfg = _config(tmp / "data")
    cfg_path = tmp / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    mp = pytest.MonkeyPatch()
    mp.setenv("SSP_EXPER_PATH", str(tmp / "logs"))
    exper = tmp / "logs" / "exp"
    try:
        first_corpus = cli.main(["train_joint", str(cfg_path), "exp", "--device", "cpu"]) \
            .device_corpus
        first = {name: (exper / name).read_text().splitlines()
                 for name in ("metrics_train.jsonl", "metrics_val.jsonl")}
        ckpts = sorted(p.name for p in (exper / "checkpoints").iterdir())
        # relaunch with a longer schedule and no pretrained: auto-resume;
        # this time from the streaming loader, not the device corpus
        longer = dict(copy.deepcopy(cfg), train_iter=6)
        longer.pop("pretrained")
        longer["training"]["device_corpus"] = False
        resumed = cli.train_joint(longer, "exp", device="cpu")
        evaluated = cli.train_joint(cfg, "exp_eval", eval_only=True, device="cpu")
    finally:
        mp.undo()
    return dict(cfg=cfg, exper=exper, first=first, ckpts=ckpts, resumed=resumed,
                first_corpus=first_corpus,
                evaluated=evaluated, eval_exper=tmp / "logs" / "exp_eval")


def _rows(lines):
    return [json.loads(line) for line in lines]


def _check_cli_rows_at_the_jax_boundaries(run):
    train, val, saves = jax_rows(run["cfg"])
    rows_t, rows_v = _rows(run["first"]["metrics_train.jsonl"]), _rows(
        run["first"]["metrics_val.jsonl"])
    assert [r["step"] for r in rows_t] == train == [0, 4]
    assert [r["step"] for r in rows_v] == val == [0]
    for r in rows_t:
        assert set(r) >= {"loss", "loss_det", "loss_det_warp", "loss_desc", "loss_sem",
                          "loss_sem_warp", "positive_dist", "negative_dist", "eta_det",
                          "eta_desc", "eta_sem", "iters_per_s", "host_rss_mb"}
        assert all(math.isfinite(v) for v in r.values())
        assert r["loss_sem"] > 0 and r["loss_desc"] > 0
    assert all(k.startswith("val_") for k in rows_v[0] if k != "step")
    assert all(math.isfinite(v) for v in rows_v[0].values())
    assert run["ckpts"] == sorted(f"superPointNet_{s}.{ext}" for s in saves
                                  for ext in ("npz", "pth.tar"))


def _check_relaunch_auto_resumes(run):
    agent = run["resumed"]
    assert agent.state.step == 6 and agent.n_iter == 12
    rows = _rows((run["exper"] / "metrics_train.jsonl").read_text().splitlines())
    assert [r["step"] for r in rows] == [0, 4, 8]
    assert latest_checkpoint(run["exper"] / "checkpoints").name == "superPointNet_12.pth.tar"
    val = _rows(run["evaluated"].exper.root.joinpath("metrics_val.jsonl").read_text()
                .splitlines())
    assert len(val) == 1 and val[0]["step"] == 0 and math.isfinite(val[0]["val_loss"])
    assert not (run["eval_exper"] / "metrics_train.jsonl").exists()


def _check_npz_loads_into_jax_and_the_port(run):
    path = run["exper"] / "checkpoints" / "superPointNet_8.npz"
    with np.load(path) as z:
        assert all(z[k].dtype == np.float16 for k in z.files)
    jm = j_build_model("SuperPointNet_gauss2_ssmall", n_classes=133, dtype=jnp.float32)
    state = jax.jit(lambda key: create_train_state(jm, key, (1, H, W, 1)))(jax.random.key(0))
    state = j_load_weights_npz(path, state)
    x = np.random.default_rng(3).uniform(size=(2, H, W, 1)).astype(np.float32)
    want = jax.jit(functools.partial(jm.apply, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(x))
    model = load_weights(path, "SuperPointNet_gauss2_ssmall", {"n_classes": 133}, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k, atol in (("semi", 2e-4), ("desc", 2e-4), ("sem", 2e-3)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0)
    # the .pth.tar beside it holds the same module state, kept at fp32
    pth = torch.load(path.with_name("superPointNet_8.pth.tar"), weights_only=True)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(pth["model_state_dict"][k].half().float(), v), k


def _check_sweep_reads_each_iteration_once(run):
    """The checkpoint sweep takes the npz of an iteration the trainer wrote
    twice (``superPointNet_<it>.npz`` beside its ``.pth.tar``)."""
    from ssp_torch.cli.export_eval import checkpoints

    found = checkpoints(run["exper"] / "checkpoints")
    assert [it for it, _ in found] == [4, 8, 12]
    assert all(p.suffix == ".npz" for _, p in found)


def test_train_joint_cli(tmp_path):
    """The CLI's rows, checkpoints, relaunch, ``--eval``, the sweep's reading
    of its folder, and its npz in the JAX package (module docstring)."""
    run = _run(tmp_path)
    assert run["first_corpus"] is not None and run["resumed"].device_corpus is None
    _check_cli_rows_at_the_jax_boundaries(run)
    _check_relaunch_auto_resumes(run)
    _check_sweep_reads_each_iteration_once(run)
    _check_npz_loads_into_jax_and_the_port(run)


def test_full_resume_continues_exactly(tmp_path):
    """Two steps in one run equal one step, a full save and load into a fresh
    state, and the second step: metrics, parameters, ηs and the schedule."""
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand((2, H, W), generator=g)
    pts = torch.rand((2, 30, 2), generator=g) * torch.tensor([W - 1.0, H - 1.0])
    batch = prepare_batch(imgs, pts, torch.ones((2, 30), dtype=torch.bool),
                          sem=torch.randint(0, 134, (2, H, W), generator=g, dtype=torch.int32),
                          warped_pair={"enable": True, "params": {}}, gaussian_label_sigma=0.2,
                          host_generator=g)
    kw = dict(semantic=True, warped_pair=True, multi_task=True,
              desc_params={"num_matching_attempts": 50, "num_masked_non_matches_per_match": 5})

    def fresh():
        model = load_flax_npz(NPZ, "SuperPointNet_gauss2_ssmall", device="cpu").train()
        return TrainState.create(model, learning_rate=0.0025, max_steps=10)

    a = fresh()
    train_step(a, batch, generator=torch.Generator().manual_seed(1), **kw)
    save_checkpoint(tmp_path, a, 1)
    want = train_step(a, batch, generator=torch.Generator().manual_seed(2), **kw)
    b = load_checkpoint(tmp_path / "superPointNet_1.pth.tar", fresh(), mode="full")
    assert b.step == 1 and b.scheduler.last_epoch == 1
    got = train_step(b, batch, generator=torch.Generator().manual_seed(2), **kw)
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
    assert torch.equal(a.etas, b.etas) and a.optimizer.param_groups[0]["lr"] == \
        b.optimizer.param_groups[0]["lr"]
    # weights mode: the module only; the ηs, Adam and the count start afresh
    c = load_checkpoint(tmp_path / "superPointNet_1.pth.tar", fresh(), mode="weights")
    assert c.step == 0 and c.etas.tolist() == [1.0, 2.0, 1.0]
    # an orbax directory is refused with the loader's message
    (tmp_path / "superPointNet_5").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(tmp_path / "superPointNet_5", fresh())


@pytest.mark.parametrize("change,match", [
    (lambda c: c["model"].update(exact_accumulation=True), "accumulation"),
    (lambda c: c["model"]["dense_loss"].update(enable=True), "dense loss"),
])
def test_unported_options_are_refused(tmp_path, change, match):
    """The two options this test once saw refused now build: ``exact_accumulation``
    with r = 2 takes the accumulated step, ``dense_loss`` the dense loss with
    the config's ``lambda_d`` and ``descriptor_dist`` (the JAX trainer's
    mapping, ``ssp/train/trainer.py:162-167``)."""
    cfg = _config(tmp_path)
    change(cfg)
    agent = TrainAgent(cfg, save_path=ExperimentPaths("refused", tmp_path), device="cpu")
    if match == "accumulation":
        assert agent.r == 2 and agent.accumulate
        assert agent.step_kwargs["desc_loss"] == "sparse"
    else:
        assert not agent.accumulate
        assert agent.step_kwargs["desc_loss"] == "dense"
        assert agent.step_kwargs["desc_params"] == {"lambda_d": 800, "descriptor_dist": 4}


def test_cli_refuses_restarts_and_multi_host(monkeypatch, capsys):
    """``--max-restarts`` hands the run to the supervisor with the device
    (``tests/test_torch_train_telemetry.py`` runs it); with ``SSP_DISTRIBUTED``
    the CLI joins the process group (``init_distributed``, here a stand-in)
    with its ``--device`` and trains on the device that returns, and refuses
    ``--max-restarts`` beside it (torchrun restarts the ranks)."""
    calls = []
    monkeypatch.setattr(cli, "run_supervised", lambda *a, **k: calls.append((a, k)) or 0)
    with pytest.raises(SystemExit) as e:
        cli.main(["train_joint", "cfg.yaml", "exp", "--max-restarts", "2", "--device", "cpu"])
    assert e.value.code == 0
    assert calls == [(("train_joint", "cfg.yaml", "exp", 2), {"debug": False, "device": "cpu"})]
    monkeypatch.setenv("SSP_DISTRIBUTED", "1")
    joined, trained, left = [], [], []
    monkeypatch.setattr(cli.mesh, "init_distributed", lambda device: joined.append(device)
                        or "rank-device")
    monkeypatch.setattr(cli.mesh, "shutdown", lambda: left.append(True))
    monkeypatch.setattr(cli, "load_config", lambda path: {"path": path})
    monkeypatch.setattr(cli, "train_joint", lambda *a, **k: trained.append((a, k)) or "agent")
    assert cli.main(["train_joint", "cfg.yaml", "exp", "--device", "cpu"]) == "agent"
    assert joined == ["cpu"] and left == [True]
    assert trained == [(({"path": "cfg.yaml"}, "exp"),
                        {"debug": False, "eval_only": False, "device": "rank-device"})]
    with pytest.raises(SystemExit):
        cli.main(["train_joint", "cfg.yaml", "exp", "--max-restarts", "2"])
    assert "--max-restarts with SSP_DISTRIBUTED" in capsys.readouterr().err
    assert len(calls) == 1 and joined == ["cpu"]
