"""Export CLI (port of ``ssp/cli/export.py``; reference ``export.py``).

Usage::

  python -m ssp_torch.cli.export export_descriptor <config> <exper_name> [--device cpu]

``export_descriptor`` writes the stage-4 HPatches predictions, one npz per
pair, to ``<EXPER_PATH>/<exper_name>/predictions/``.  It runs on the card
unless ``--device cpu`` is given.

Not ported yet: ``export_detector_homoAdapt`` (stage-2 pseudo-labels over
COCO JPEGs) and ``export_sequence`` (SLAM sequence export over KITTI PNG
frames).  Their compute path is ported (``ssp_torch.export.make_ha_fn``,
:func:`ssp_torch.export.make_detect_describe_fn`), but their datasets need
JPEG and PNG decoding, which the port does without OpenCV only from a
later slice on.
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict

import torch

from ssp_torch import registry
from ssp_torch.models.superpoint import SuperPointGauss2, build_model
from ssp_torch.models.weights import load_weights
from ssp_torch.utils.config import load_config
from ssp_torch.utils.experiment import ExperimentPaths

log = logging.getLogger(__name__)


def _load_model(config: Dict[str, Any], *, device="cuda") -> SuperPointGauss2:
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


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(description="ssp_torch export")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("export_descriptor")
    p.add_argument("config")
    p.add_argument("exper_name")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    export_descriptor(load_config(args.config), args.exper_name, device=args.device)


if __name__ == "__main__":
    main()
