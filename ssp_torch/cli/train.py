"""Training CLI (port of ``ssp/cli/train.py``; reference ``train4.py``).

Usage::

  python -m ssp_torch.cli.train train_joint <config> <exper_name> [--debug] [--eval]
                                [--device cpu]
  python -m ssp_torch.cli.train train_base  <config> <exper_name> ...

``train_base`` and ``train_joint`` are the same code path, as in the
reference: the config decides which heads train.  The agent is the config's
``front_end_model`` (``ssp_torch.train.trainer.TrainAgent``); the datasets
are ``data.dataset`` for the ``train`` and ``val`` splits, read by a
background decode thread (``workers_train`` decode threads per batch) for
training, or, with ``training.device_corpus``, sampled from the whole
training set held on the device.  ``--debug`` stops after 10 iterations, ``--eval`` runs one
validation and stops.  It trains on the card unless ``--device cpu`` is
given.

Not ported: ``--max-restarts`` (supervised restarts in child processes) and
multi-host runs (``SSP_DISTRIBUTED``); each exits with an error naming its
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import logging
import os

from ssp_torch import registry
from ssp_torch.data.prefetch import Prefetcher
from ssp_torch.train import trainer as _trainer  # noqa: F401  (registers the agent names)
from ssp_torch.utils.config import load_config
from ssp_torch.utils.experiment import ExperimentPaths


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
        agent._val_logger.close()
        return agent
    if debug:
        agent.max_iter = min(agent.max_iter, 10)
    agent.train()
    return agent


def main(argv=None):
    """The command line; returns the agent."""
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
                       help="not ported (ROADMAP.md Queue 1 item 10, 'supervised restarts')")
    args = ap.parse_args(argv)
    if os.environ.get("SSP_DISTRIBUTED"):
        ap.error("SSP_DISTRIBUTED: multi-host training is not ported (ROADMAP.md Queue 1 "
                 "item 10, DDP with SyncBatchNorm)")
    if args.max_restarts > 0:
        ap.error("--max-restarts is not ported (ROADMAP.md Queue 1 item 10, "
                 "'supervised restarts')")
    return train_joint(load_config(args.config), args.exper_name, debug=args.debug,
                       eval_only=args.eval, device=args.device)


if __name__ == "__main__":
    main()
