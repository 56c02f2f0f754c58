"""Classical-baseline export CLI (port of ``ssp/cli/export_classical.py``;
reference ``export_classical.py``).

Usage::

  python -m ssp_torch.cli.export_classical <config> <exper_name> [--device cpu]

Exports SIFT/ORB keypoints, descriptors and matches on HPatches pairs in the
evaluation npz format (``configs/classical_descriptors.yaml``), one
``<i>.npz`` per pair under ``<exper_name>/predictions/``, skipping the files
that exist.  Detection runs on the host; the matcher runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ssp_torch import registry
from ssp_torch.export.classical import classical_detect_describe, match_classical
from ssp_torch.utils.config import load_config
from ssp_torch.utils.experiment import ExperimentPaths

log = logging.getLogger(__name__)


def export_classical(config: Dict[str, Any], exper_name: str, *,
                     device: Union[str, torch.device] = "cuda",
                     seconds: Optional[Dict[str, float]] = None) -> int:
    """Writes one npz per HPatches pair; returns the number of pairs (those
    that existed included).  ``seconds``, if given, gains the host-clock
    seconds of each part: ``read`` (decode and resize), ``detect``,
    ``match`` and ``write``."""
    data_cfg = dict(config["data"])
    name = data_cfg.pop("dataset")
    dataset = registry.get("dataset", name)(task="test", **data_cfg)
    method = config["model"].get("name", "sift")
    top_k = int(config["model"].get("top_k", 1000))
    t = seconds if seconds is not None else {}

    exper = ExperimentPaths(exper_name)
    out_dir = exper.predictions
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for idx in range(len(dataset)):
        out_file = out_dir / f"{idx}.npz"
        if out_file.exists():
            n += 1
            continue
        t0 = time.perf_counter()
        pair = dataset[idx]
        t1 = time.perf_counter()
        p1, d1 = classical_detect_describe(pair["image"], method, top_k)
        p2, d2 = classical_detect_describe(pair["warped_image"], method, top_k)
        t2 = time.perf_counter()
        if len(p1) and len(p2):
            m = match_classical(d1, d2, method, device=device)
            matches = np.concatenate(
                [p1[m[:, 0].astype(int)][:, :2], p2[m[:, 1].astype(int)][:, :2]], axis=1
            )
        else:
            matches = np.zeros((0, 4))
        t3 = time.perf_counter()
        np.savez_compressed(
            out_file,
            image=pair["image"],
            warped_image=pair["warped_image"],
            prob=p1,
            warped_prob=p2,
            desc=d1,
            warped_desc=d2,
            homography=pair["homography"],
            matches=matches,
        )
        t4 = time.perf_counter()
        for part, dt in (("read", t1 - t0), ("detect", t2 - t1), ("match", t3 - t2),
                         ("write", t4 - t3)):
            t[part] = t.get(part, 0.0) + dt
        n += 1
    log.info("exported %d classical (%s) pairs → %s", n, method, out_dir)
    return n


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("exper_name")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    export_classical(load_config(args.config), args.exper_name, device=args.device)


if __name__ == "__main__":
    main()
