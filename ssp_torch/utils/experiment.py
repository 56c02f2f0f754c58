"""Experiment directories (port of ``ssp/utils/experiment.py:1-53``).

Reference layout (``train4.py:63-66``, ``utils/utils.py:952-961``):
``EXPER_PATH/<exper_name>/`` holds ``config.yml``, ``checkpoints/`` and
``predictions/``.  The JAX package's ``MetricsLogger`` (JSONL and
TensorBoard) comes with training.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional


def settings_paths() -> Dict[str, Path]:
    """DATA_PATH / EXPER_PATH roots (reference ``settings.py:6-9``),
    overridable by ``SSP_DATA_PATH`` / ``SSP_EXPER_PATH``."""
    return {
        "DATA_PATH": Path(os.environ.get("SSP_DATA_PATH", "datasets")),
        "EXPER_PATH": Path(os.environ.get("SSP_EXPER_PATH", "logs")),
    }


class ExperimentPaths:
    def __init__(self, exper_name: str, exper_path: Optional[Path] = None):
        root = exper_path or settings_paths()["EXPER_PATH"]
        self.root = Path(root) / exper_name
        self.checkpoints = self.root / "checkpoints"
        self.predictions = self.root / "predictions"
        self.root.mkdir(parents=True, exist_ok=True)
        self.checkpoints.mkdir(parents=True, exist_ok=True)

    def dump_config(self, config: Dict[str, Any]) -> None:
        """Write ``config.yml``; values YAML cannot hold are written as
        their ``str``."""
        import yaml

        def sanitize(x):
            if isinstance(x, dict):
                return {k: sanitize(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [sanitize(v) for v in x]
            if isinstance(x, (str, int, float, bool)) or x is None:
                return x
            return str(x)

        with open(self.root / "config.yml", "w") as f:
            yaml.safe_dump(sanitize(config), f)
