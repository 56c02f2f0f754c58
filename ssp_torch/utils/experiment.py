"""Experiment directories (port of ``ssp/utils/experiment.py:1-53``).

Reference layout (``train4.py:63-66``, ``utils/utils.py:952-961``):
``EXPER_PATH/<exper_name>/`` holds ``config.yml``, ``checkpoints/`` and
``predictions/``.  :class:`MetricsLogger` writes the trainer's scalars.
"""

from __future__ import annotations

import datetime as _dt
import importlib.util
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


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


class MetricsLogger:
    """Scalars as JSON lines in ``<exper>/metrics_<task>.jsonl``, one record
    ``{"step": n, "<prefix><name>": value, ...}`` per call, the JAX
    package's layout; TensorBoard scalars too when
    ``torch.utils.tensorboard`` imports (the JAX logger tries TensorFlow).
    Where TensorFlow is installed, TensorBoard's writer would import it (tens
    of seconds, and the port does not load TensorFlow), so the scalars go to
    JSONL alone there.  The event files go under ``<exper>/runs/<task>/``
    (the JAX logger writes ``runs/<task>/<exper>_<stamp>`` below the working
    directory).  Images and histograms go to TensorBoard alone."""

    def __init__(self, exper: ExperimentPaths, task: str = "train"):
        self._jsonl = open(exper.root / f"metrics_{task}.jsonl", "a")
        self._tb = None
        if importlib.util.find_spec("tensorflow") is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                logging.getLogger(__name__).info("no TensorBoard: metrics go to JSONL only")
            else:
                stamp = _dt.datetime.now().strftime("%m-%d-%H:%M")
                self._tb = SummaryWriter(str(exper.root / "runs" / task / stamp))

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": int(step)}
        rec.update({f"{prefix}{k}": float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}{k}", float(v), int(step))

    def log_image(self, step: int, name: str, image) -> None:
        """An image ([H, W] or [H, W, C], float in [0, 1] or uint8) to
        TensorBoard (reference label, NMS and heatmap overlays,
        ``Train_model_frontend_all.py:535-566``); nothing without it."""
        if self._tb is None:
            return
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[..., None]
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self._tb.add_image(name, img, int(step), dataformats="HWC")

    def log_histogram(self, step: int, name: str, values) -> None:
        """A value distribution to TensorBoard (reference subpixel-residual
        histograms, ``Train_model_frontend_all.py:568-571``); nothing
        without it or for no values."""
        if self._tb is None:
            return
        vals = np.asarray(values).reshape(-1)
        if vals.size:
            self._tb.add_histogram(name, vals, int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None
