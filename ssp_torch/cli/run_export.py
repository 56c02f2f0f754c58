"""HPatches export, then its evaluation (port of ``run_export.sh``).

Usage::

  python -m ssp_torch.cli.run_export [CONFIG] [EXPER] [--device cpu]

runs ``export_descriptor CONFIG EXPER`` (``ssp_torch.cli.export``), then
``evaluate <EXPER_PATH>/EXPER/predictions -r -homo`` (``ssp_torch.cli.
evaluate``), with the shell script's defaults
(``configs/magicpoint_repeatability_heatmap.yaml``, ``hp_eval``).  The
export runs on ``--device`` (the card unless ``cpu``), the evaluation on the
host; the summary is printed as the evaluation prints it and returned.
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict

from ssp_torch.cli.evaluate import evaluate
from ssp_torch.cli.export import export_descriptor
from ssp_torch.utils.config import load_config
from ssp_torch.utils.experiment import ExperimentPaths

DEFAULT_CONFIG = "configs/magicpoint_repeatability_heatmap.yaml"
DEFAULT_EXPER = "hp_eval"


def run_export(config, exper_name: str = DEFAULT_EXPER, *, device="cuda") -> Dict[str, float]:
    """Export ``config`` (a dict or a YAML path) under ``exper_name`` and
    evaluate the predictions (repeatability and homography estimation);
    returns the evaluation's summary."""
    if not isinstance(config, dict):
        config = load_config(config)
    export_descriptor(config, exper_name, device=device)
    return evaluate(ExperimentPaths(exper_name).predictions, do_rep=True, do_homo=True)


def main(argv=None) -> Dict[str, float]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default=DEFAULT_CONFIG)
    ap.add_argument("exper_name", nargs="?", default=DEFAULT_EXPER)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    summary = run_export(args.config, args.exper_name, device=args.device)
    for k, v in summary.items():
        print(f"{k}: {v}")
    return summary


if __name__ == "__main__":
    main()
