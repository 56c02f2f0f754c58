"""Export CLI (port of ``ssp/cli/export.py``; reference ``export.py``).

Usage::

  python -m ssp_torch.cli.export export_detector_homoAdapt <config> <exper_name> [--device cpu]
  python -m ssp_torch.cli.export export_descriptor        <config> <exper_name> [--device cpu]
  python -m ssp_torch.cli.export export_sequence          <config> <exper_name> [--device cpu]

* ``export_detector_homoAdapt`` (stage 2) writes homography-adaptation
  pseudo-labels, one ``pts`` npz per image, to ``<EXPER_PATH>/<exper_name>/
  predictions/<split dir>/`` and appends its audit lines to
  ``<exper_name>/export.txt`` (``configs/magicpoint_coco_export.yaml``,
  ``configs/magicpoint_kitti_export.yaml``);
* ``export_descriptor`` (stage 4) writes the HPatches predictions, one npz
  per pair, to ``<exper_name>/predictions/``;
* ``export_sequence`` writes per-frame keypoints and descriptors for a
  SLAM front end to ``<exper_name>/predictions/<split dir>/<scene>/
  <frame>.npz`` (``configs/kitti384_sequence_r5.yaml``).

Each runs on the card unless ``--device cpu`` is given, and skips the files
that exist, so a stopped export resumes.

``export_detector_homoAdapt`` also runs over several processes, one per card,
as the JAX CLI shards its groups over a mesh of all devices: with
``SSP_DISTRIBUTED`` set each process of a ``torchrun --nproc_per_node=N``
launch joins the process group (``ssp_torch.parallel.init_distributed``) and
exports its share of the images on its own card, one image per call::

  SSP_DISTRIBUTED=1 torchrun --nproc_per_node=N -m ssp_torch.cli.export \
      export_detector_homoAdapt <config> <exper_name>

``export_descriptor`` and ``export_sequence`` run in one process, as in the
JAX package.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ssp_torch import registry
from ssp_torch.models.superpoint import build_model
from ssp_torch.models.weights import load_weights
from ssp_torch.parallel import mesh
from ssp_torch.utils.config import load_config
from ssp_torch.utils.experiment import ExperimentPaths

log = logging.getLogger(__name__)


def _load_model(config: Dict[str, Any], *, device="cuda") -> nn.Module:
    """The configured model with the weights of ``config['pretrained']``
    (or ``model.pretrained``), in eval mode on ``device``; without either,
    a seeded initialisation."""
    m = config["model"]
    params = dict(m.get("params") or {})
    pretrained = config.get("pretrained") or m.get("pretrained")
    if pretrained:
        log.info("loading weights from %s", pretrained)
        return load_weights(pretrained, m["name"], params, device=device)
    log.warning("no pretrained weights configured — exporting random init")
    return build_model(m["name"], device=device, generator=torch.Generator().manual_seed(0),
                       **params)


def export_descriptor(config: Dict[str, Any], exper_name: str, *, device="cuda") -> int:
    """Stage-4 HPatches export from ``config`` (the reference schema; see
    ``configs/pipeline240_sweep_wsem.yaml``); returns the number of npz
    files written."""
    from ssp_torch.export.descriptors_export import make_detect_describe_fn, run_descriptor_export
    from ssp_torch.models.fast_infer import best_apply_fn

    data_cfg = dict(config["data"])
    name = data_cfg.pop("dataset")
    dataset = registry.get("dataset", name)(task="test", **data_cfg)

    size = config["data"].get("preprocessing", {}).get("resize", [240, 320])
    model = _load_model(config, device=device)
    m = config["model"]
    sub = m.get("subpixel", {})
    dd_fn = make_detect_describe_fn(
        best_apply_fn(model, input_hw=tuple(size), enable=bool(m.get("fast_inference", True)),
                      device=device),
        device=device,
        top_k=int(m.get("top_k", 1000)),
        conf_thresh=float(m.get("detection_threshold", 0.015)),
        nms_radius=int(m.get("nms", 4)),
        subpixel=bool(sub.get("enable", True)),
        patch_size=int(sub.get("patch_size", 5)),
    )
    out_dir = ExperimentPaths(exper_name).predictions
    n = run_descriptor_export(dd_fn, iter(dataset), out_dir,
                              nn_thresh=float(m.get("nn_thresh", 1.0)))
    log.info("exported %d pairs to %s", n, out_dir)
    return n


def _dataset(config: Dict[str, Any]):
    """(the configured dataset for ``data.export_folder``, that split)."""
    data_cfg = dict(config["data"])
    name = data_cfg.pop("dataset")
    split = data_cfg.pop("export_folder", "train")
    return registry.get("dataset", name)(task=split, **data_cfg), split


def export_detector_homoAdapt(config: Dict[str, Any], exper_name: str, *, device="cuda",
                              regions: Optional[dict] = None) -> int:
    """Stage-2 homography-adaptation pseudo-labels from ``config`` (see
    ``configs/magicpoint_coco_export.yaml``); returns the number of npz
    files this process wrote.  One image per call (``group=1``), as the JAX
    CLI runs on one device; in a process group (``ssp_torch.parallel``) each
    rank exports its share of the images (``run_ha_export``'s ``rank`` and
    ``world``) and rank 0 writes ``export.txt``.
    ``homography_adaptation.one_dispatch`` runs each image as one CUDA graph
    (``make_ha_fn``'s ``one_dispatch``), with the same points: with one image
    per call its chunk holds all of the image's warps.  A ``regions`` dict
    receives the HA function's captured regions (``ha.regions``: their
    launches per replay and replay counts)."""
    from ssp_torch.export.homography_adaptation import make_ha_fn, run_ha_export
    from ssp_torch.models.fast_infer import best_apply_fn

    ha_cfg = config["data"].get("homography_adaptation", {})
    dataset, split = _dataset(config)
    size = config["data"].get("preprocessing", {}).get("resize", [240, 320])
    model = _load_model(config, device=device)
    m = config["model"]
    sub = m.get("subpixel", {})
    num = int(ha_cfg.get("num", 100))
    ha_fn = make_ha_fn(
        best_apply_fn(model, input_hw=tuple(size), enable=bool(m.get("fast_inference", True)),
                      device=device),
        device=device,
        num_h=num,
        homography_params=ha_cfg.get("homographies", {}).get("params"),
        aggregation=ha_cfg.get("aggregation", "sum"),
        filter_counts=int(ha_cfg.get("filter_counts", 0)),
        top_k=int(m.get("top_k", 600)),
        conf_thresh=float(m.get("detection_threshold", 0.015)),
        nms_radius=int(m.get("nms", 4)),
        subpixel=bool(sub.get("enable", False)),
        patch_size=int(sub.get("patch_size", 5)),
        one_dispatch=bool(ha_cfg.get("one_dispatch", False)),
    )
    exper = ExperimentPaths(exper_name)
    out_dir = exper.predictions / type(dataset).split_dir(split)
    # audit log, appended across resumed runs (reference export.py:263-275)
    if mesh.is_rank0():
        with open(exper.root / "export.txt", "a") as audit:
            audit.write(f"load model: {config.get('pretrained') or m.get('pretrained')}\n")
            audit.write(f"homography adaptation: {num}\n")
    n = run_ha_export(ha_fn, dataset.images(), out_dir, seed=int(config.get("seed", 0)),
                      group=1, rank=mesh.rank(), world=mesh.world())
    log.info("exported %d predictions to %s", n, out_dir)
    if regions is not None:
        regions.update(ha_fn.regions)
    return n


def export_sequence(config: Dict[str, Any], exper_name: str, *, device="cuda") -> int:
    """Per-frame keypoints and descriptors for a SLAM front end (the
    reference feeds KITTI/TUM sequences to Semantic ORB-SLAM2) from
    ``config`` (see ``configs/kitti384_sequence_r5.yaml``); subpixel
    refinement is off unless configured.  Returns the number of npz files
    written."""
    from ssp_torch.export.descriptors_export import make_detect_describe_fn, run_sequence_export
    from ssp_torch.models.fast_infer import best_apply_fn

    dataset, split = _dataset(config)
    size = config["data"].get("preprocessing", {}).get("resize", [240, 320])
    model = _load_model(config, device=device)
    m = config["model"]
    sub = m.get("subpixel", {})
    dd_fn = make_detect_describe_fn(
        best_apply_fn(model, input_hw=tuple(size), enable=bool(m.get("fast_inference", True)),
                      device=device),
        device=device,
        top_k=int(m.get("top_k", 1000)),
        conf_thresh=float(m.get("detection_threshold", 0.015)),
        nms_radius=int(m.get("nms", 4)),
        subpixel=bool(sub.get("enable", False)),
        patch_size=int(sub.get("patch_size", 5)),
    )
    out_root = ExperimentPaths(exper_name).predictions / type(dataset).split_dir(split)
    n = run_sequence_export(dd_fn, dataset.images(), out_root)
    log.info("exported %d frames to %s", n, out_root)
    return n


COMMANDS = {"export_detector_homoAdapt": export_detector_homoAdapt,
            "export_descriptor": export_descriptor, "export_sequence": export_sequence}


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(description="ssp_torch export")
    sub = ap.add_subparsers(dest="command", required=True)
    for command in COMMANDS:
        p = sub.add_parser(command)
        p.add_argument("config")
        p.add_argument("exper_name")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    distributed = bool(os.environ.get("SSP_DISTRIBUTED"))
    if distributed and args.command != "export_detector_homoAdapt":
        ap.error(f"SSP_DISTRIBUTED: {args.command} runs in one process (only "
                 f"export_detector_homoAdapt runs over several)")
    device = mesh.init_distributed(args.device) if distributed else args.device
    COMMANDS[args.command](load_config(args.config), args.exper_name, device=device)
    if distributed:
        mesh.shutdown()


if __name__ == "__main__":
    main()
