"""The trainer's telemetry and the train CLI's supervision on the CPU.

* ``TrainAgent.residual_diagnostic`` against the JAX trainer's
  ``_residual_diagnostic`` on the same weights and batch: the mean residual
  error at rel 1e-4 and the predicted offsets within 1e-4 px (fp32
  forwards summed in another order, through a soft-argmax).
* ``MetricsLogger.log_image``/``log_histogram``: what reaches TensorBoard's
  writer (HWC uint8 images, flattened values), and nothing without one.
* A run of ``TrainAgent.train`` with ``profile: {enable: true, steps: 1}``,
  ``val_residual_diagnostic: true`` and a validation loader: the trace file
  under ``<exper>/profile``, ``val_subpix_residual_err`` in
  ``metrics_val.jsonl``, the four validation images drawn and logged.
* ``watched_call`` kills a child whose metrics stop moving (124) and returns
  a finished child's code at once; ``run_supervised`` resumes a crashed run
  once from its checkpoint (``python -m ssp_torch.cli.train`` children on
  the CPU: the first stops at its host-memory watchdog after the first step
  and saves ``superPointNet_1``, the second resumes from it through
  ``resume_auto.yaml`` and ends at step 2).
"""

import json
import math
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from ssp.data.pipeline import prepare_batch as j_prepare_batch
from ssp.train.trainer import TrainAgent as JTrainAgent
from ssp.utils.experiment import ExperimentPaths as JExperimentPaths
from ssp_torch.cli import train as cli
from ssp_torch.models.weights import flax_to_state_dict, load_reference_state_dict
from ssp_torch.train.trainer import TrainAgent
from ssp_torch.utils.experiment import ExperimentPaths, MetricsLogger
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
B, H, W = 2, 32, 48


def _config(**extra):
    return dict({"model": {"name": "SuperPointNet_gauss2", "params": {"dtype": "float32"},
                           "batch_size": B, "learning_rate": 0.001},
                 "data": {"preprocessing": {"resize": [H, W]},
                          "warped_pair": {"enable": True, "params": {}}},
                 "train_iter": 4, "tensorboard_interval": 1, "save_interval": 100,
                 "validation_interval": 3, "validation_size": 0}, **extra)


def _host_batches(seed):
    rng = np.random.default_rng(seed)
    while True:
        yield {"image": rng.uniform(size=(B, H, W)).astype(np.float32),
               "points": rng.uniform([0, 0], [W - 1, H - 1], (B, 20, 2)).astype(np.float32),
               "points_valid": np.ones((B, 20), bool)}


def test_residual_diagnostic_matches_jax(tmp_path):
    cfg = _config()
    jagent = JTrainAgent(cfg, save_path=JExperimentPaths("j", tmp_path))
    agent = TrainAgent(cfg, save_path=ExperimentPaths("t", tmp_path), device="cpu")
    load_reference_state_dict(agent.state.model, flax_to_state_dict(
        {"params": jagent.state.params, "batch_stats": jagent.state.batch_stats}))
    host = next(_host_batches(0))
    jbatch = jax.jit(j_prepare_batch)(jax.random.key(0), host["image"], host["points"],
                                      host["points_valid"])
    want = jagent._residual_diagnostic(jbatch)
    got, offsets = agent.residual_diagnostic(
        {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()})
    assert math.isfinite(want) and want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(offsets, jagent._residual_offsets, atol=1e-4, rtol=0)
    assert agent.residual_diagnostic({"image": jbatch["image"]}) is None


class _Writer:
    def __init__(self):
        self.calls = []

    def add_image(self, name, img, step, dataformats):
        self.calls.append(("image", name, img.dtype, img.shape, step, dataformats))

    def add_histogram(self, name, values, step):
        self.calls.append(("histogram", name, values.shape, step))


def test_log_image_and_histogram(tmp_path):
    logger = MetricsLogger(ExperimentPaths("tb", tmp_path), "val")
    writer, logger._tb = _Writer(), None
    logger.log_image(1, "none", np.zeros((4, 5)))  # no TensorBoard: nothing, no error
    logger._tb = writer
    logger.log_image(2, "gray", np.full((4, 5), 2.0))
    logger.log_image(3, "bgr", np.zeros((4, 5, 3), np.uint8))
    logger.log_histogram(4, "h", np.ones((3, 2)))
    logger.log_histogram(5, "empty", np.zeros((0, 2)))
    assert writer.calls == [("image", "gray", np.uint8, (4, 5, 1), 2, "HWC"),
                            ("image", "bgr", np.uint8, (4, 5, 3), 3, "HWC"),
                            ("histogram", "h", (6,), 4)]
    logger._tb = None
    logger.close()


def test_train_writes_profile_diagnostic_and_images(tmp_path, monkeypatch):
    images = []
    monkeypatch.setattr(MetricsLogger, "log_image",
                        lambda self, step, name, img: images.append((step, name, img.shape)))
    cfg = _config(profile={"enable": True, "steps": 1}, val_residual_diagnostic=True)
    agent = TrainAgent(cfg, save_path=ExperimentPaths("run", tmp_path), device="cpu")
    agent.train_loader, agent.val_loader = _host_batches(1), _host_batches(2)
    agent.train()
    exper = tmp_path / "run"
    assert [p.name for p in (exper / "profile").iterdir()] == ["trace_3.json"]
    assert json.loads((exper / "profile" / "trace_3.json").read_text())["traceEvents"]
    val = [json.loads(r) for r in (exper / "metrics_val.jsonl").read_text().splitlines()]
    assert [r["step"] for r in val] == [0, 3]
    assert all(math.isfinite(r["val_subpix_residual_err"]) for r in val)
    assert [name for _, name, _ in images[:4]] == [
        "val/base_heatmap_overlay", "val/base_nms_detections",
        "val/warped_heatmap_overlay", "val/warped_nms_detections"]
    assert images[0][2] == (H, W, 3) and images[1][2] == (H, W, 3) and len(images) == 8


def test_watched_call_kills_a_hung_child(tmp_path):
    exper = ExperimentPaths("w", tmp_path)
    t0 = time.time()
    rc = cli.watched_call([sys.executable, "-c", "import time; time.sleep(60)"], exper,
                          stall_s=0.5, poll_s=0.1)
    assert rc == 124 and time.time() - t0 < 20
    t0 = time.time()
    assert cli.watched_call([sys.executable, "-c", "raise SystemExit(3)"], exper,
                            stall_s=60, poll_s=30) == 3
    assert time.time() - t0 < 20


def test_run_supervised_resumes_from_a_checkpoint(tmp_path, monkeypatch):
    cfg = yaml.safe_load((ROOT / "configs" / "pipeline240_magicpoint.yaml").read_text())
    cfg["data"]["generation"]["split_sizes"] = {"training": 2, "validation": 1, "test": 1}
    cfg["data"]["preprocessing"]["resize"] = [H, W]
    cfg["model"].update(batch_size=B, eval_batch_size=B, params={"dtype": "float32"})
    # the host-memory watchdog stops the first child at its first logged step
    cfg.update(train_iter=2, tensorboard_interval=2, save_interval=100, steps_per_dispatch=1,
               validation_interval=100, validation_size=0, rss_budget_mb=1)
    path = tmp_path / "cut.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("SSP_DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setenv("SSP_EXPER_PATH", str(tmp_path / "logs"))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the children at one thread, as this process
    with pytest.raises(SystemExit) as e:
        cli.main(["train_base", str(path), "sup", "--device", "cpu", "--max-restarts", "1"])
    assert e.value.code == 0
    exper = tmp_path / "logs" / "sup"
    resume = yaml.safe_load((exper / "resume_auto.yaml").read_text())
    assert resume["pretrained"].endswith("superPointNet_1.pth.tar")
    assert resume["reset_iter"] is False and resume["retrain"] is False
    names = sorted(p.name for p in (exper / "checkpoints").iterdir())
    assert names == ["superPointNet_1.npz", "superPointNet_1.pth.tar",
                     "superPointNet_2.npz", "superPointNet_2.pth.tar"]
    # the watchdog stops before the row of step 0 is written; step 1 logs none
    assert (exper / "metrics_train.jsonl").read_text() == ""
