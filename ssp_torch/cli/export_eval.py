"""Checkpoint-sweep CLI (port of ``ssp/cli/export_eval.py``; reference
``export_eval.py``).

Usage::

  python -m ssp_torch.cli.export_eval <config> <exper_name> [--device cpu]

Globs the checkpoints ``superPointNet_<it>*`` under
``config["model"]["folder"]``, runs the HPatches export of
``predictions/ckpt_<it>`` and its evaluation for each, and appends one row
per checkpoint to ``<exper>/checkpoints/results.csv`` and, in the
reference's own columns, ``results_ref.csv`` (reference
``export_eval.py:700-752``).  A checkpoint that fails is written as a zero
row and the sweep goes on (``export_eval.py:737-751``).  It runs on the
card unless ``--device cpu`` is given.

What the port reads as a checkpoint: ``superPointNet_<it>.npz`` (the flax
npz of ``ssp.train.checkpoint.save_weights_npz``) and the reference's
``superPointNet_<it>_checkpoint.pth.tar``.  The JAX trainer's orbax
directories need the JAX package: one among readable files gives a zero
row, and a folder of nothing else raises before anything is written.

The forward is the export's (``ssp_torch/cli/export.py``): the folded bf16
forward unless ``model.fast_inference`` is false, then the fp32 module.
The JAX sweep always runs the flax module at its own dtype (bfloat16
unless the model params say ``dtype: float32``), so only fp32 is held
against fp32.
"""

from __future__ import annotations

import argparse
import csv
import logging
import re
from pathlib import Path
from typing import Dict, List, Tuple

from ssp_torch import registry
from ssp_torch.cli.evaluate import HOMOGRAPHY_THRESH, evaluate
from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import load_reference_state_dict, read_state_dict
from ssp_torch.utils.config import load_config
from ssp_torch.utils.experiment import ExperimentPaths

log = logging.getLogger(__name__)

CSV_FIELDS = (
    ["iter", "repeatability", "localization_err"]
    + [f"correctness_{e}" for e in HOMOGRAPHY_THRESH]
    + ["nn_map", "matching_score"]
)

# the reference's exact header (export_eval.py:710-719) — written as a
# second file so tooling built against the reference's results.csv
# (e.g. its plotting notebooks) consumes the sweeps unchanged
REF_CSV_FIELDS = [
    "path",
    "repeatability threshold",
    "repeatability",
    "localization error",
    "homography threshold",
    "Average correctness",
    "nn mean AP",
    "matching score",
]
REP_THRESH = 3  # reference rep_thd (export_eval.py:96)
_ITER = re.compile(r"superPointNet_(\d+)")


def reference_row(ckpt_path: str, summary: dict) -> dict:
    """One ``results.csv`` row in the reference's schema
    (``export_eval.py:345-355``): correctness over the ε sweep is a
    stringified array, scalars stringified as the reference does."""
    correctness = [summary.get(f"correctness_{e}", 0.0) for e in HOMOGRAPHY_THRESH]
    return {
        "path": ckpt_path,
        "repeatability threshold": str(REP_THRESH),
        "repeatability": summary.get("repeatability", 0.0),
        "localization error": summary.get("localization_err", 0.0),
        "homography threshold": str(list(HOMOGRAPHY_THRESH)),
        "Average correctness": str(correctness),
        "nn mean AP": str(summary.get("nn_map", 0.0)),
        "matching score": str(summary.get("matching_score", 0.0)),
    }


def _readable(path: Path) -> bool:
    return path.is_file() and (path.name.endswith(".npz") or path.name.endswith(".pth.tar"))


def checkpoints(folder: Path) -> List[Tuple[int, Path]]:
    """``(iteration, path)`` of every ``superPointNet_<it>*`` entry under
    ``folder``, by iteration.  Raises when there is none, or when none is a
    file the port reads."""
    found = sorted((int(m.group(1)), p) for p in Path(folder).glob("superPointNet_*")
                   if (m := _ITER.match(p.name)))
    # the port's trainer writes each iteration twice, superPointNet_<it>.pth.tar
    # beside its npz: the npz alone stands for the iteration
    npz = {it for it, p in found if p.name.endswith(".npz")}
    found = [(it, p) for it, p in found if it not in npz or p.name.endswith(".npz")]
    if not found:
        raise FileNotFoundError(f"no checkpoints under {folder}")
    if not any(_readable(p) for _, p in found):
        raise ValueError(
            f"no checkpoint under {folder} is a file the port reads (superPointNet_<it>.npz or "
            f"superPointNet_<it>_checkpoint.pth.tar); orbax directories need the JAX package: "
            f"export each with ssp.train.checkpoint.save_weights_npz")
    return found


def sweep(config: dict, exper_name: str, *, device="cuda") -> Path:
    """Export and evaluate every checkpoint of ``config["model"]["folder"]``;
    returns the path of ``results.csv``."""
    from ssp_torch.export.descriptors_export import (
        make_detect_describe_var_fn,
        run_descriptor_export,
    )

    m = config["model"]
    ckpts = checkpoints(Path(m["folder"]))

    data_cfg = dict(config["data"])
    name = data_cfg.pop("dataset")
    dataset = registry.get("dataset", name)(task="test", **data_cfg)
    size = config["data"].get("preprocessing", {}).get("resize", [240, 320])

    params = dict(m.get("params") or {})
    # a checkpoint that does not fit the model fails on this CPU copy, before
    # its predictions directory is made, as the JAX sweep fails at its load
    template = build_model(m["name"], device="cpu", **params)
    sub = m.get("subpixel", {})
    var_fn = make_detect_describe_var_fn(
        build_model(m["name"], device="cpu", **params),
        device=device,
        input_hw=tuple(size),
        fast_inference=bool(m.get("fast_inference", True)),
        top_k=int(m.get("top_k", 1000)),
        conf_thresh=float(m.get("detection_threshold", 0.015)),
        nms_radius=int(m.get("nms", 4)),
        subpixel=bool(sub.get("enable", True)),
        patch_size=int(sub.get("patch_size", 5)),
    )

    exper = ExperimentPaths(exper_name)
    csv_path = exper.checkpoints / "results.csv"
    ref_csv_path = exper.checkpoints / "results_ref.csv"
    write_header = not csv_path.exists()
    write_ref_header = not ref_csv_path.exists()
    with open(csv_path, "a", newline="") as f, \
            open(ref_csv_path, "a", newline="") as rf:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        ref_writer = csv.DictWriter(rf, fieldnames=REF_CSV_FIELDS)
        if write_header:
            writer.writeheader()
        if write_ref_header:
            ref_writer.writeheader()
        for it, ckpt in ckpts:
            row: Dict[str, float] = {k: 0.0 for k in CSV_FIELDS}
            row["iter"] = it
            summary: dict = {}
            try:
                state_dict = read_state_dict(ckpt, m["name"])
                load_reference_state_dict(template, state_dict)
                out_dir = exper.predictions / f"ckpt_{it}"
                run_descriptor_export(
                    lambda img, sd=state_dict: var_fn(sd, img), iter(dataset), out_dir,
                    nn_thresh=float(m.get("nn_thresh", 1.0)),
                )
                summary = evaluate(out_dir)
                for k in CSV_FIELDS[1:]:
                    row[k] = summary.get(k, 0.0)
            except Exception as e:  # noqa: BLE001 — the sweep must go on
                log.exception("checkpoint %s failed: %s", ckpt, e)
            writer.writerow(row)
            ref_writer.writerow(reference_row(str(ckpt), summary))
            f.flush()
            rf.flush()
            log.info("ckpt %d: %s", it, {k: round(v, 4) for k, v in row.items()})
    return csv_path


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="ssp_torch checkpoint sweep")
    ap.add_argument("config")
    ap.add_argument("exper_name")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sweep(load_config(args.config), args.exper_name, device=args.device)


if __name__ == "__main__":
    main()
