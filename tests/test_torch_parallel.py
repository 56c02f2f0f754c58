"""Port parity: data parallelism over processes (``ssp_torch.parallel``) on the
CPU, two ranks over gloo against one process, and the one process against the
JAX step.

The ranks are this file run as a script (``python tests/test_torch_parallel.py
<case> <rank> <world> <port> <dir>``): each joins the group through
``init_distributed`` from torchrun's environment variables, reads the case's
inputs that the test wrote to ``<dir>``, takes its rows and writes its result
there.  The script imports neither JAX nor the JAX package.

* (i) Cross-replica BatchNorm at fp64: two ranks with B/2 rows each in
  training mode equal one process with B rows: outputs, input gradients,
  the affine's gradients summed over the ranks and the running statistics
  within rel 1e-9.
* (ii) One flagship joint step (ssmall-133: warped pair, sparse descriptor
  loss, fused semantic CE, Kendall) on one prepared global batch of 4
  pairs, the JAX step's descriptor draws fed in: two ranks of 2 pairs equal
  one process of 4 at ``tests/test_multiproc.py``'s bars (loss rel 1e-6, the
  parameter checksum Σ|p| rel 1e-6), the ηs equal on both ranks and to the
  one process's.  Both sides run at fp64 (the module, its state and the
  batch; the homographies fp32, as in ``tests/test_torch_train_step.py``):
  at fp32 the gradients of the conv biases that feed a BatchNorm are
  rounding noise near Adam's eps, and their first updates, up to ±lr each,
  follow the noise (the checksum then moves by ~1e-6).  The batch is uneven:
  the second rank's pairs have most of their semantic pixels ignored and
  half their cells masked, so that a mean of per-rank losses is another
  loss (checked beside it).  The one process at fp32 is held against the
  JAX step at ``tests/test_torch_train_step.py``'s first-step bars (metrics
  rel 1e-4), from the same seeded weights.
* (ii') The mesh shrink: a ``TrainAgent`` of global batch 4 on three ranks
  trains on two (the largest count that divides 4, the JAX trainer's mesh)
  and leaves rank 2 idle; ranks 0-1 take (ii)'s step over the agent's
  training group and equal the two-rank run of (ii) bit for bit and the one
  process at (ii)'s bars; rank 2 writes nothing; all three exit 0.  The same
  through the train CLI under torchrun: three ranks write the rows of two,
  equal to a two-rank launch's.
* (iii) ``run_ha_export`` on two ranks against one process on the plain path
  (the tiny model and 6 images of ``tests/multiproc_ha_worker.py``): the same
  files, each written once, with equal points; and again with two files
  present before the run, which the ranks skip without moving any position.
"""

import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from ssp_torch.parallel import mesh  # noqa: E402
from test_torch_threads import _one_thread  # noqa: E402, F401  (autouse)

B, H, W = 4, 64, 96
LR, MAX_STEPS, M, N = 0.0025, 10, 1000, 100
STEP_KW = dict(semantic=True, warped_pair=True, det_loss_type="softmax", desc_loss="sparse",
               desc_params={"num_matching_attempts": M, "num_masked_non_matches_per_match": N,
                            "lamda_d": 1.0, "method": "2d"},
               lambda_loss=1.0, multi_task=True, ignore_class=133, sem_fused=True)
HA_KW = dict(num_h=4, top_k=24, conf_thresh=0.0, chunk=4)
HA_HW = (48, 64)
# the waits on child processes, about 3× the slowest wait of each kind
# measured under the suite's command (pytest -n 6 --dist load on 8 cores):
# the ranks of one case 65 s (the joint step's ranks, 19.4 s), one torchrun
# launch 160 s (the two-rank CLI's first launch, 53.1 s)
RANK_WAIT_S = 65
TORCHRUN_WAIT_S = 160


# ---- the ranks ----------------------------------------------------------------

def _bn_rank(inp, rank, world):
    from ssp_torch.models.superpoint import BatchNorm

    bn = BatchNorm(inp["x"].shape[1]).double()
    bn.load_state_dict(inp["bn"])
    bn.train()
    x = mesh.shard_rows({"x": inp["x"]}, world, rank)["x"].clone().requires_grad_(True)
    g = mesh.shard_rows({"g": inp["g"]}, world, rank)["g"]
    y = bn(x)
    (y * g).sum().backward()
    mesh.reduce_sum_([bn.weight.grad, bn.bias.grad])
    return {"y": y.detach(), "x_grad": x.grad, "w_grad": bn.weight.grad,
            "b_grad": bn.bias.grad, "mean": bn.running_mean, "var": bn.running_var}


def _fp64_state(state_dict):
    """A train state of the flagship module at fp64 from ``state_dict``."""
    from ssp_torch.models.superpoint import build_model
    from ssp_torch.train import TrainState

    model = build_model("SuperPointNet_gauss2_ssmall", device="cpu", n_classes=133,
                        dtype=torch.float64).double()
    model.load_state_dict(state_dict)
    ts = TrainState.create(model.train(), learning_rate=LR, max_steps=MAX_STEPS)
    ts.etas.data = ts.etas.data.double()
    return ts


def _fp64_batch(batch):
    return {k: v.double() if v.dtype == torch.float32 and k != "H_pair" else v
            for k, v in batch.items()}


def _step_rank(inp, rank, world):
    from ssp_torch.losses.descriptor_sparse import SparseDraws
    from ssp_torch.train import train_step

    ts = _fp64_state(inp["state_dict"])
    batch = mesh.shard_rows(_fp64_batch(inp["batch"]), world, rank)
    draws = SparseDraws(**mesh.shard_rows(inp["draws"], world, rank))
    metrics = train_step(ts, batch, desc_draws=draws, **STEP_KW)
    return _step_result(ts, metrics)


def _ha_rank(inp, rank, world):
    from ssp_torch.export import make_ha_fn, run_ha_export
    from ssp_torch.models.fast_infer import best_apply_fn
    from ssp_torch.models.superpoint import build_model

    model = build_model("SuperPointNet_gauss2", device="cpu")
    model.load_state_dict(inp["state_dict"])
    ha = make_ha_fn(best_apply_fn(model, enable=False, device="cpu"), device="cpu", **HA_KW)
    return run_ha_export(ha, inp["images"], Path(inp["out"]), seed=3, group=1, rank=rank,
                         world=world)


def _shrink_rank(inp, rank, world):
    """(ii'): the agent's training group, then (ii)'s step on it; an idle rank
    returns None and so writes no result."""
    from ssp_torch.train.trainer import TrainAgent
    from ssp_torch.utils.experiment import ExperimentPaths

    agent = TrainAgent(inp["config"], save_path=ExperimentPaths("shrink", Path(inp["out"])),
                       device="cpu")
    assert agent.world == 2 and agent.idle == (rank == 2) and mesh.world() == world
    if agent.idle:
        return None
    with mesh.scope(agent.group):
        assert mesh.world() == 2 and mesh.rank() == rank
        return _step_rank(inp, rank, mesh.world())


CASES = {"bn": _bn_rank, "step": _step_rank, "shrink": _shrink_rank, "ha": _ha_rank}


def _step_result(ts, metrics):
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "checksum": sum(float(p.detach().double().abs().sum())
                            for p in ts.model.parameters()),
            "etas": ts.etas.detach().clone(),
            "stats": {k: v.clone() for k, v in ts.model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def _rank_main(case: str, rank: int, world: int, port: int, work: Path) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(2)
    mesh.init_distributed("cpu")
    assert mesh.world() == world and mesh.rank() == rank
    out = CASES[case](torch.load(work / f"{case}_in.pt", weights_only=False), rank, world)
    if out is not None:
        torch.save(out, work / f"{case}_{rank}.pt")
    mesh.shutdown()


# ---- the tests ----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, env, err: Path):
    """(a child in a session of its own, so that :func:`_finish` can kill a
    launcher's ranks with it; ``err``, the file that takes its stderr)."""
    with open(err, "w") as f:
        return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=f,
                                start_new_session=True), err


def _finish(procs: dict, wait_s: float) -> dict:
    """Wait at most ``wait_s`` seconds in all for ``procs`` (name → (process,
    its stderr file)), kill what still runs, and fail naming each child that
    did not exit in time or exited with another code than 0, with the end of
    its stderr.  Returns name → stderr text."""
    deadline = time.monotonic() + wait_s
    late = set()
    for name, (p, _) in procs.items():
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            late.add(name)
    for p, _ in procs.values():
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    errs = {name: err.read_text() for name, (_, err) in procs.items()}
    for name, (p, _) in procs.items():
        how = f"no exit within {wait_s} s" if name in late else f"exit code {p.returncode}"
        assert name not in late and p.returncode == 0, f"{name}: {how}\n{errs[name][-4000:]}"
    return errs


def _launch(case: str, inp: dict, work: Path, world: int = 2):
    """Start ``case`` on ``world`` ranks over gloo (:func:`_collect` waits)."""
    torch.save(inp, work / f"{case}_in.pt")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return case, work, {f"{case} rank {r}": _spawn(
        [sys.executable, str(Path(__file__).resolve()), case, str(r), str(world), str(port),
         str(work)], env, work / f"{case}_{r}.err") for r in range(world)}


def _collect(launched):
    """The launched ranks' results in rank order (None for a rank that wrote
    none), once every rank has exited 0 (within ``RANK_WAIT_S``)."""
    case, work, procs = launched
    _finish(procs, RANK_WAIT_S)
    return [torch.load(work / f"{case}_{r}.pt", weights_only=False)
            if (work / f"{case}_{r}.pt").exists() else None for r in range(len(procs))]


def _ranks(case: str, inp: dict, work: Path, world: int = 2):
    """Run ``case`` on ``world`` ranks over gloo; their results in rank order."""
    return _collect(_launch(case, inp, work, world))


def _rel(a, b, rel):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rel,
                               atol=0)


def test_cross_replica_batchnorm_equals_one_process(tmp_path):
    from ssp_torch.models.superpoint import BatchNorm

    rng = np.random.default_rng(0)
    C = 8
    x = torch.from_numpy(rng.normal(loc=3.0, scale=2.0, size=(B, C, 6, 5)))
    g = torch.from_numpy(rng.normal(size=(B, C, 6, 5)))
    bn = BatchNorm(C).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=C)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(size=C)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, C)))
    inp = {"x": x, "g": g, "bn": {k: v.clone() for k, v in bn.state_dict().items()}}
    xs = x.clone().requires_grad_(True)
    y = bn.train()(xs)
    (y * g).sum().backward()

    ranks = _ranks("bn", inp, tmp_path)
    _rel(torch.cat([r["y"] for r in ranks]), y.detach(), 1e-9)
    _rel(torch.cat([r["x_grad"] for r in ranks]), xs.grad, 1e-9)
    for r in ranks:
        _rel(r["w_grad"], bn.weight.grad, 1e-9)
        _rel(r["b_grad"], bn.bias.grad, 1e-9)
        _rel(r["mean"], bn.running_mean, 1e-9)
        _rel(r["var"], bn.running_var, 1e-9)
    # the halves' own statistics are far from the global ones
    assert float((x[:2].mean(dim=(0, 2, 3)) - x.mean(dim=(0, 2, 3))).abs().max()) > 1e-2


def _uneven_batch():
    """A global batch of B pairs prepared by the port, the second half (rank
    1's rows) with most semantic pixels ignored and half the cells masked."""
    from ssp_torch.data.pipeline import prepare_batch
    from test_torch_train_step import PAIR

    rng = np.random.default_rng(1)
    imgs = rng.uniform(size=(B, H, W)).astype(np.float32)
    imgs[:, 8:40, 16:60] *= 0.3
    pts = rng.uniform([0, 0], [W - 1, H - 1], size=(B, 60, 2)).astype(np.float32)
    sem = rng.integers(0, 134, size=(B, H // 8, W // 8)).repeat(8, 1).repeat(8, 2)
    batch = prepare_batch(torch.from_numpy(imgs), torch.from_numpy(pts),
                          torch.ones((B, 60), dtype=torch.bool),
                          sem=torch.from_numpy(sem.astype(np.int32)), warped_pair=PAIR,
                          gaussian_label_sigma=0.2, generator=torch.Generator().manual_seed(3),
                          host_generator=torch.Generator().manual_seed(4))
    half = B // 2
    for k in ("sem", "warped_sem"):
        batch[k][half:, :, : 7 * W // 8] = 133
        batch[k][half:, :, 7 * W // 8:] = 0
    for k in ("valid_mask", "warped_valid_mask"):
        batch[k][half:, :, : W // 2] = 0
    for k in ("labels_2d", "warped_labels_2d"):
        batch[k][half:] = 0
    return batch


def _uneven_joint_batch(state_dict):
    """:func:`_uneven_batch` (the JAX step takes it too), the JAX step's
    descriptor draws, the JAX train state at ``state_dict``'s weights and its
    step."""
    import jax
    import jax.numpy as jnp
    import optax

    from ssp.losses.multitask import init_etas
    from ssp.models import build_model as j_build_model
    from ssp.train.lr import polynomial_decay_schedule
    from ssp.train.state import TrainState as JTrainState
    from ssp.train.step import make_train_step
    from ssp_torch.models.weights import state_dict_to_flax
    from test_torch_losses import jax_sparse_draws
    from test_torch_train_step import _tree

    batch = _uneven_batch()
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    draws = jax_sparse_draws(jax.random.key(100), np.asarray(jbatch["H_pair"]),
                             (H // 8, W // 8), M, N)

    tree = _tree(state_dict_to_flax(state_dict))
    tx = optax.adam(polynomial_decay_schedule(LR, MAX_STEPS, 0.001, 2.0))
    etas = init_etas()
    jm = j_build_model("SuperPointNet_gauss2_ssmall", dtype=jnp.float32, n_classes=133)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                         batch_stats=tree["batch_stats"], etas=etas,
                         opt_state=jax.jit(tx.init)({"params": tree["params"], "etas": etas}),
                         apply_fn=jm.apply, tx=tx)
    jstep, _ = make_train_step(donate=False, **STEP_KW)
    return batch, jbatch, draws, jstate, jstep


def test_two_rank_joint_step_equals_one_process_and_jax(tmp_path):
    import jax

    from ssp_torch.models.superpoint import build_model
    from ssp_torch.train import TrainState, train_step
    from ssp_torch.train.step import compute_losses

    model = build_model("SuperPointNet_gauss2_ssmall", device="cpu", n_classes=133,
                        generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch, jbatch, draws, jstate, jstep = _uneven_joint_batch(sd)

    # the one process at fp32 against the JAX step, the first from the same weights
    ts = TrainState.create(model.train(), learning_rate=LR, max_steps=MAX_STEPS)
    metrics = {k: float(v) for k, v in train_step(ts, batch, desc_draws=draws,
                                                  **STEP_KW).items()}
    _, jmetrics = jstep(jstate, jbatch, jax.random.key(100))
    assert metrics.keys() == jmetrics.keys()
    for k, w in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(w), rtol=1e-4, atol=1e-7, err_msg=k)

    # two ranks against the one process, both at fp64
    ts64 = _fp64_state(sd)
    one = _step_result(ts64, train_step(ts64, _fp64_batch(batch), desc_draws=draws, **STEP_KW))
    ranks = _ranks("step", {"state_dict": sd, "batch": batch, "draws": dict(vars(draws))},
                   tmp_path)
    for r in ranks:
        assert r["metrics"].keys() == one["metrics"].keys()
        _rel(r["metrics"]["loss"], one["metrics"]["loss"], 1e-6)
        _rel(r["checksum"], one["checksum"], 1e-6)
        for k in ("loss_det", "loss_det_warp", "loss_sem", "loss_sem_warp", "loss_desc"):
            _rel(r["metrics"][k], one["metrics"][k], 1e-6)
        _rel(r["etas"], one["etas"], 1e-6)
        for k, v in one["stats"].items():
            np.testing.assert_allclose(r["stats"][k], v, rtol=1e-6, atol=1e-9, err_msg=k)
    assert torch.equal(ranks[0]["etas"], ranks[1]["etas"])
    assert ranks[0]["checksum"] == ranks[1]["checksum"]

    # the batch is uneven: the mean of the two halves' own ratios is another loss
    halves = []
    for lo in (0, B // 2):
        part = {k: v[lo:lo + B // 2] for k, v in _fp64_batch(batch).items()}
        part_draws = type(draws)(**{k: v[lo:lo + B // 2] for k, v in vars(draws).items()})
        fresh = _fp64_state(sd)
        halves.append(compute_losses(fresh.model, fresh.etas, part, desc_draws=part_draws,
                                     **STEP_KW)[1])
    for k in ("loss", "loss_det", "loss_sem"):  # off by 1000x the bar and more
        mean_of_ratios = np.mean([float(h[k]) for h in halves])
        assert abs(mean_of_ratios - one["metrics"][k]) > 1e-3 * abs(one["metrics"][k]), k


def test_three_ranks_shrink_to_two_and_equal_two_ranks(tmp_path):
    """(ii'): three ranks on a global batch of 4 train on two; ranks 0-1
    equal (ii)'s two ranks bit for bit and the one process at (ii)'s bars;
    rank 2 writes nothing."""
    from ssp_torch.losses.descriptor_sparse import cell_matches, sample_draws
    from ssp_torch.models.superpoint import build_model
    from ssp_torch.train import train_step
    from test_torch_train_agent import _config

    model = build_model("SuperPointNet_gauss2_ssmall", device="cpu", n_classes=133,
                        generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _uneven_batch()
    draws = sample_draws(cell_matches(batch["H_pair"], (H // 8, W // 8))[2], M, N,
                         generator=torch.Generator().manual_seed(100))
    inp = {"state_dict": sd, "batch": batch, "draws": dict(vars(draws))}
    cfg = _config(tmp_path / "data")
    cfg["model"].update(batch_size=B, real_batch_size=B)
    cfg["pretrained"] = None
    launched = [_launch("step", inp, tmp_path),
                _launch("shrink", dict(inp, config=cfg, out=str(tmp_path / "logs")), tmp_path,
                        world=3)]
    ts64 = _fp64_state(sd)
    one = _step_result(ts64, train_step(ts64, _fp64_batch(batch), desc_draws=draws, **STEP_KW))
    two, three = map(_collect, launched)
    assert three[2] is None and not (tmp_path / "shrink_2.pt").exists()
    for r, want in zip(three[:2], two):
        assert r["metrics"] == want["metrics"] and r["checksum"] == want["checksum"]
        assert torch.equal(r["etas"], want["etas"])
        assert all(torch.equal(r["stats"][k], v) for k, v in want["stats"].items())
        _rel(r["metrics"]["loss"], one["metrics"]["loss"], 1e-6)
        _rel(r["checksum"], one["checksum"], 1e-6)
        _rel(r["etas"], one["etas"], 1e-6)


def _ha_inputs(out: Path):
    from ssp_torch.models.superpoint import build_model

    model = build_model("SuperPointNet_gauss2", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    images = [(f"img{i:03d}", rng.uniform(size=HA_HW).astype(np.float32)) for i in range(6)]
    return model, images, {"state_dict": model.state_dict(), "images": images, "out": str(out)}


def _ha_single(model, images, out: Path) -> int:
    from ssp_torch.export import make_ha_fn, run_ha_export
    from ssp_torch.models.fast_infer import best_apply_fn

    ha = make_ha_fn(best_apply_fn(model, enable=False, device="cpu"), device="cpu", **HA_KW)
    return run_ha_export(ha, images, out, seed=3, group=1)


def _same_exports(a: Path, b: Path):
    names = sorted(p.name for p in a.glob("*.npz"))
    assert names == sorted(p.name for p in b.glob("*.npz")) and len(names) == 6
    for name in names:
        pa, pb = np.load(a / name)["pts"], np.load(b / name)["pts"]
        assert pa.shape == pb.shape and len(pa) > 0, name
        np.testing.assert_array_equal(pa, pb, err_msg=name)


def test_two_rank_ha_export_equals_one_process(tmp_path):
    single = tmp_path / "single"
    model, images, inp = _ha_inputs(tmp_path / "multi")
    assert _ha_single(model, images, single) == 6
    written = [r for r in _ranks("ha", inp, tmp_path)]
    assert written == [3, 3]  # each file once: positions 0, 2, 4 and 1, 3, 5
    _same_exports(single, tmp_path / "multi")


def test_two_rank_ha_export_resumes_without_moving_positions(tmp_path):
    import shutil

    single = tmp_path / "single"
    multi = tmp_path / "multi"
    model, images, inp = _ha_inputs(multi)
    _ha_single(model, images, single)
    multi.mkdir()
    for name in ("img000.npz", "img003.npz"):  # one of each rank's
        shutil.copy(single / name, multi / name)
    assert _ranks("ha", inp, tmp_path) == [2, 2]
    _same_exports(single, multi)


def test_two_rank_train_cli_under_torchrun(tmp_path):
    """``SSP_DISTRIBUTED=1 torchrun --nproc_per_node=2 -m ssp_torch.cli.train
    train_joint`` on the CPU (gloo) with ``tests/test_torch_train_agent.py``'s
    cut flagship config (global batch 4, 2 rows per rank): the first run
    samples the device corpus, a relaunch with a longer schedule reads the
    streaming loader and resumes from the newest checkpoint.  Rank 0 alone
    writes: one row per boundary in the metrics files, the checkpoint names of
    a one-process run, every loss finite."""
    import json

    import yaml

    from test_torch_train_agent import _config, _write_tree, jax_rows

    _write_tree(tmp_path / "data")
    cfg = _config(tmp_path / "data")
    exper = tmp_path / "logs" / "exp"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(SSP_DISTRIBUTED="1", SSP_EXPER_PATH=str(tmp_path / "logs"), OMP_NUM_THREADS="2")

    def launch(c, name):
        path = tmp_path / name
        path.write_text(yaml.safe_dump(c))
        _finish({f"torchrun {name}": _spawn(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
             "--master_addr=127.0.0.1", f"--master_port={_free_port()}", "-m",
             "ssp_torch.cli.train", "train_joint", str(path), "exp", "--device", "cpu"], env,
            tmp_path / f"{name}.err")}, TORCHRUN_WAIT_S)

    def rows(name):
        return [json.loads(line) for line in (exper / name).read_text().splitlines()]

    launch(cfg, "first.yaml")
    train_rows, val_rows, saves = jax_rows(cfg)
    assert [r["step"] for r in rows("metrics_train.jsonl")] == train_rows
    assert [r["step"] for r in rows("metrics_val.jsonl")] == val_rows
    assert sorted(p.name for p in (exper / "checkpoints").glob("*.pth.tar")) == sorted(
        f"superPointNet_{n}.pth.tar" for n in set(saves))

    longer = dict(cfg, train_iter=6, training=dict(cfg["training"], device_corpus=False))
    longer.pop("pretrained")
    launch(longer, "longer.yaml")
    got = rows("metrics_train.jsonl")
    resumed = [r["step"] for r in got[len(train_rows):]]
    assert resumed and resumed[0] > train_rows[-1]
    assert (exper / "checkpoints" / "superPointNet_12.pth.tar").exists()
    for r in got + rows("metrics_val.jsonl"):
        assert all(np.isfinite(v) for k, v in r.items() if k.startswith(("loss", "val_loss")))


def test_three_rank_train_cli_trains_on_two_ranks(tmp_path):
    """``torchrun --nproc_per_node=3`` of the train CLI on the cut flagship
    config (global batch 4) beside a two-rank launch: all five ranks exit 0,
    rank 2 logs that it is idle, and the three-rank run's metrics rows (at
    the JAX trainer's boundaries) and checkpoints equal the two-rank run's."""
    import json

    import yaml

    from test_torch_train_agent import _config, _write_tree, jax_rows

    _write_tree(tmp_path / "data")
    cfg = _config(tmp_path / "data")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(SSP_DISTRIBUTED="1", SSP_EXPER_PATH=str(tmp_path / "logs"), OMP_NUM_THREADS="1")
    errs = _finish({n: _spawn(
        [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={n}",
         "--master_addr=127.0.0.1", f"--master_port={_free_port()}", "-m", "ssp_torch.cli.train",
         "train_joint", str(path), f"ranks{n}", "--device", "cpu"], env,
        tmp_path / f"ranks{n}.err") for n in (2, 3)}, TORCHRUN_WAIT_S)
    assert "rank 2 is idle" in errs[3] and "ranks 0..1 train" in errs[3]
    assert "idle" not in errs[2]

    def rows(n, name):
        return [{k: v for k, v in json.loads(line).items() if k not in ("iters_per_s",
                                                                        "host_rss_mb")}
                for line in (tmp_path / "logs" / f"ranks{n}" / name).read_text().splitlines()]

    train_rows, val_rows, _ = jax_rows(cfg)
    assert [r["step"] for r in rows(3, "metrics_train.jsonl")] == train_rows
    assert [r["step"] for r in rows(3, "metrics_val.jsonl")] == val_rows
    for name in ("metrics_train.jsonl", "metrics_val.jsonl"):
        assert rows(3, name) == rows(2, name)
    ckpts = {n: sorted(p.name for p in (tmp_path / "logs" / f"ranks{n}" / "checkpoints").iterdir())
             for n in (2, 3)}
    assert ckpts[3] == ckpts[2] and ckpts[3]


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               Path(sys.argv[5]))
