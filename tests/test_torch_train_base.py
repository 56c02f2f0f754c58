"""Stage 1 on the CPU: ``python -m ssp_torch.cli.train train_base`` on
``configs/pipeline240_magicpoint.yaml`` cut to 64×96, a real batch of 4, 3
training and 2 validation samples per primitive, 4 steps with validation and
checkpoints every 2.  The corpus is generated without OpenCV into the run's
``SSP_DATA_PATH`` and held on the device as uint8; each step goes through
the config's homographic and photometric augmentation and the detector-only
loss.  Checked: every logged loss finite, the metrics rows at their steps,
the checkpoint names, and the generated shards equal to the JAX package's
for the same configuration."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import yaml
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _config(tmp_path: Path) -> Path:
    cfg = yaml.safe_load((ROOT / "configs" / "pipeline240_magicpoint.yaml").read_text())
    cfg["data"]["generation"]["split_sizes"] = {"training": 3, "validation": 2, "test": 2}
    cfg["data"]["preprocessing"]["resize"] = [64, 96]
    cfg["model"].update(batch_size=4, eval_batch_size=2)
    cfg.update(train_iter=4, save_interval=2, validation_interval=2, tensorboard_interval=1,
               steps_per_dispatch=1)
    path = tmp_path / "magicpoint_cut.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_train_base_cli_on_the_stage1_config(tmp_path):
    # the child at one intra-op thread, as the tests in this process run
    # (tests/test_torch_threads.py)
    env = dict(os.environ, SSP_DATA_PATH=str(tmp_path / "data"),
               SSP_EXPER_PATH=str(tmp_path / "logs"), PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "ssp_torch.cli.train", "train_base",
                        str(_config(tmp_path)), "mp", "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "device corpus attached: 22 samples" in r.stderr  # 3 per primitive, truncated
    exper = tmp_path / "logs" / "mp"
    rows = [json.loads(line) for line in (exper / "metrics_train.jsonl").read_text().splitlines()]
    assert [row["step"] for row in rows] == [0, 1, 2, 3]
    for row in rows:
        assert all(math.isfinite(v) for v in row.values()), row
        assert row["loss"] == row["loss_det"] > 0 and row["loss_desc"] == 0.0
    val = [json.loads(line) for line in (exper / "metrics_val.jsonl").read_text().splitlines()]
    assert [row["step"] for row in val] == [0, 2]  # the JAX trainer's boundaries
    assert all(math.isfinite(row["val_loss"]) for row in val)
    names = sorted(p.name for p in (exper / "checkpoints").iterdir())
    assert names == ["superPointNet_2.npz", "superPointNet_2.pth.tar",
                     "superPointNet_4.npz", "superPointNet_4.pth.tar"]

    # the shards are the JAX package's for the same configuration
    from ssp.data.synthetic_dataset import SyntheticShapesDataset

    cache = tmp_path / "data" / "synthetic_shapes_jointd240"
    assert len(list(cache.glob("*_training_3_64x96_b21_s0.npz"))) == 9
    assert len(list(cache.glob("*_validation_2_64x96_b21_s0.npz"))) == 9
    want = SyntheticShapesDataset(task="val", cache_dir=tmp_path / "jax", primitives="all",
                                  generation={"split_sizes": {"validation": 2}},
                                  preprocessing={"resize": [64, 96], "blur_size": 21})
    with np.load(cache / "draw_cube_validation_2_64x96_b21_s0.npz") as z:
        assert np.array_equal(z["images"], want._images[14:16])


def test_stage1_batches_warp_once_on_the_two_pass_route(tmp_path, monkeypatch):
    """A stage-1 training batch makes two ``vresample_coef`` calls on the
    two-pass route (one homographic warp, two passes), a validation batch
    none (``enable_val: false``): the launches ``chip_smoke.py`` expects per
    prepared batch on the card, counted here through the wrapper's plain
    version."""
    import torch

    from ssp_torch import registry
    from ssp_torch.data.pipeline import prepare_batch
    from ssp_torch.kernels import warp_twopass
    from ssp_torch.train import trainer  # noqa: F401  (registers the agents)
    from ssp_torch.utils.experiment import ExperimentPaths

    cfg = yaml.safe_load(_config(tmp_path).read_text())
    agent = registry.get("agent", cfg["front_end_model"])(
        cfg, save_path=ExperimentPaths("mp", tmp_path / "logs"), exper_name="mp", device="cpu")
    calls = []
    wrapped = warp_twopass.vresample_coef
    monkeypatch.setattr(warp_twopass, "vresample_coef",
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(size=(4, 64, 96)).astype(np.float32))
    points = torch.from_numpy(rng.uniform(0, 60, (4, 120, 2)).astype(np.float32))
    valid = torch.ones(4, 120, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    for prep, want in ((agent.prep_train, 2), (agent.prep_val, 0)):
        calls.clear()
        batch = prepare_batch(images, points, valid, generator=g, host_generator=g,
                              warp="twopass", **prep)
        assert len(calls) == want and torch.isfinite(batch["image"]).all()
