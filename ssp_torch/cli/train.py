"""Training CLI (port of ``ssp/cli/train.py``; reference ``train4.py``).

Usage::

  python -m ssp_torch.cli.train train_joint <config> <exper_name> [--debug] [--eval]
                                [--device cpu] [--max-restarts N]
  python -m ssp_torch.cli.train train_base  <config> <exper_name> ...

``train_base`` and ``train_joint`` are the same code path, as in the
reference: the config decides which heads train.  The agent is the config's
``front_end_model`` (``Train_model_heatmap`` and its aliases,
``ssp_torch.train.trainer.TrainAgent``; ``Train_model_subpixel``); the datasets
are ``data.dataset`` for the ``train`` and ``val`` splits, read by a
background decode thread (``workers_train`` decode threads per batch) for
training, or, with ``training.device_corpus``, sampled from the whole
training set held on the device.  ``--debug`` stops after 10 iterations, ``--eval`` runs one
validation and stops.  It trains on the card unless ``--device cpu`` is
given.

``--max-restarts N`` supervises the run (:func:`run_supervised`): the
training runs in a child ``python -m ssp_torch.cli.train`` on the same
``--device``; when the child dies (a crash, the host-memory watchdog, a
kill) it is relaunched from the newest checkpoint through
``<exper>/resume_auto.yaml``, up to N times, and a child whose metrics files
stop moving for ``SSP_STALL_TIMEOUT_S`` seconds (default 2400) is killed and
relaunched so.

Data-parallel training: with ``SSP_DISTRIBUTED`` set, each process of a
``torchrun --nproc_per_node=N`` launch joins the process group
(``ssp_torch.parallel.init_distributed``: NCCL, one card per rank,
``cuda:LOCAL_RANK``; gloo over the CPU with ``--device cpu``) and trains its
share of every global batch (``ssp_torch.train.trainer``)::

  SSP_DISTRIBUTED=1 torchrun --nproc_per_node=N -m ssp_torch.cli.train \
      train_joint <config> <exper_name>

The JAX CLI's ``SSP_DISTRIBUTED`` joins a multi-host JAX runtime and then
supervises children that would each join it again; the port refuses
``--max-restarts`` with ``SSP_DISTRIBUTED`` instead: torchrun's own
``--max-restarts`` relaunches every rank of a failed run, and a relaunch
resumes from the newest checkpoint (``auto_resume``).
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
import time

from ssp_torch import registry
from ssp_torch.data.prefetch import Prefetcher
from ssp_torch.parallel import mesh
from ssp_torch.train import trainer as _trainer  # noqa: F401  (registers the agent names)
from ssp_torch.train import subpixel_agent as _subpixel  # noqa: F401  (registers the agent names)
from ssp_torch.train import val_agent as _val  # noqa: F401  (registers the agent names)
from ssp_torch.train.checkpoint import latest_checkpoint
from ssp_torch.utils.config import load_config
from ssp_torch.utils.experiment import ExperimentPaths

log = logging.getLogger("ssp_torch.train.supervisor")


def make_dataset(config: dict, task: str):
    data_cfg = dict(config["data"])
    name = data_cfg.pop("dataset")
    return registry.get("dataset", name)(task=task, **data_cfg)


def train_joint(config: dict, exper_name: str, debug: bool = False, eval_only: bool = False,
                *, device="cuda"):
    """Build the agent and its loaders from ``config`` and train (or, with
    ``eval_only``, validate once).  Returns the agent."""
    exper = ExperimentPaths(exper_name)
    agent = registry.get("agent", config["front_end_model"])(
        config, save_path=exper, exper_name=exper_name, device=device)
    train_set = make_dataset(config, "train")
    val_set = make_dataset(config, "val")
    bs = int(config["model"].get("real_batch_size", config["model"]["batch_size"]))
    seed = int(config.get("seed", 0))
    training_cfg = config.get("training") or {}
    if training_cfg.get("device_corpus"):
        agent.attach_device_corpus(train_set)
    else:
        agent.train_loader = Prefetcher(train_set.batches(
            bs, shuffle=True, seed=seed, workers=int(training_cfg.get("workers_train", 4))))
    agent.val_loader = val_set.batches(
        int(config["model"].get("eval_batch_size", bs)), shuffle=False, seed=seed,
        workers=int(training_cfg.get("workers_val", 2)))
    if eval_only:
        agent._validate()
        if agent._val_logger is not None:
            agent._val_logger.close()
        return agent
    if debug:
        agent.max_iter = min(agent.max_iter, 10)
    agent.train()
    return agent


def watched_call(cmd, exper: ExperimentPaths, stall_s: float, poll_s: float = 30.0) -> int:
    """Run ``cmd`` in a child and return its exit code; kill it (and return
    124) when the experiment's metrics files have not changed for
    ``stall_s`` seconds.  The child's exit is seen at once; progress is
    looked at every ``poll_s`` seconds."""

    def progress_mtime() -> float:
        return max([(exper.root / n).stat().st_mtime for n in
                    ("metrics_train.jsonl", "metrics_val.jsonl") if (exper.root / n).exists()]
                   + [0.0])

    child = subprocess.Popen(cmd)
    last, last_mtime = time.time(), progress_mtime()
    while True:
        try:
            return child.wait(timeout=poll_s)
        except subprocess.TimeoutExpired:
            pass
        m = progress_mtime()
        if m > last_mtime:
            last_mtime, last = m, time.time()
        elif time.time() - last > stall_s:
            log.error("no metrics progress for %.0f s: killing hung child %d", stall_s, child.pid)
            child.kill()
            child.wait()
            return 124


def run_supervised(command: str, config_path: str, exper_name: str, max_restarts: int,
                   debug: bool = False, *, device: str = "cuda") -> int:
    """Crash-resilient training: the run in a child process (``python -m
    ssp_torch.cli.train`` with this ``--device``); when it exits non-zero
    (including a kill that no handler inside it survives, or a hang that
    :func:`watched_call` ends), a resume config pointing at the newest
    checkpoint (``pretrained``, ``reset_iter: false``) is written to
    ``<exper>/resume_auto.yaml`` and the child relaunched from it, up to
    ``max_restarts`` times.  Returns the last child's exit code (0 on
    success)."""
    import yaml

    stall_s = float(os.environ.get("SSP_STALL_TIMEOUT_S", "2400"))
    cfg_file, rc = config_path, 1
    for attempt in range(max_restarts + 1):
        cmd = [sys.executable, "-m", "ssp_torch.cli.train", command, cfg_file, exper_name,
               "--device", device] + (["--debug"] if debug else [])
        exper = ExperimentPaths(exper_name)
        rc = watched_call(cmd, exper, stall_s)
        if rc == 0:
            return 0
        ckpt = latest_checkpoint(exper.checkpoints)
        if ckpt is None:
            log.error("child exited %d with no checkpoint to resume from", rc)
            return rc
        cfg = load_config(config_path)
        cfg.update(pretrained=str(ckpt), retrain=False, reset_iter=False)
        cfg_file = str(exper.root / "resume_auto.yaml")
        with open(cfg_file, "w") as f:
            yaml.safe_dump(cfg, f)
        if attempt < max_restarts:
            log.warning("child exited %d; restart %d/%d from %s", rc, attempt + 1, max_restarts,
                        ckpt)
    return rc


def main(argv=None):
    """The command line; returns the agent (with ``--max-restarts``, exits
    with the supervised run's code)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(description="ssp_torch training")
    sub = ap.add_subparsers(dest="command", required=True)
    for cmd in ("train_base", "train_joint"):
        p = sub.add_parser(cmd)
        p.add_argument("config")
        p.add_argument("exper_name")
        p.add_argument("--debug", action="store_true")
        p.add_argument("--eval", action="store_true")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        p.add_argument("--max-restarts", type=int, default=0,
                       help="supervise the run in child processes: on a crash or a hang, "
                            "resume from the newest checkpoint, up to N times")
    args = ap.parse_args(argv)
    distributed = bool(os.environ.get("SSP_DISTRIBUTED"))
    if distributed and args.max_restarts > 0:
        ap.error("--max-restarts with SSP_DISTRIBUTED: restart the ranks with torchrun's own "
                 "--max-restarts (a relaunch resumes from the newest checkpoint)")
    if args.max_restarts > 0:
        raise SystemExit(run_supervised(args.command, args.config, args.exper_name,
                                        args.max_restarts, debug=args.debug, device=args.device))
    device = mesh.init_distributed(args.device) if distributed else args.device
    agent = train_joint(load_config(args.config), args.exper_name, debug=args.debug,
                        eval_only=args.eval, device=device)
    if distributed:
        mesh.shutdown()
    return agent


if __name__ == "__main__":
    main()
