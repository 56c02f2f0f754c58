"""COCO images with homography-adaptation pseudo-labels (port of
``CocoDataset`` in ``ssp/data/coco.py``; reference ``datasets/Coco.py``).

The host decodes (JPEG without OpenCV, :func:`ssp_torch.data.base.
read_gray`), resizes with INTER_AREA, scales to [0, 1] and pads the label
points; augmentation belongs to training.  Label coordinates: the
HA-export npz ``pts`` are (x, y, score) at the export resolution, which the
reference and the shipped configs keep equal to the training resolution, so
points are used as stored.  ``Coco_sem`` (panoptic semantic labels) comes
with training.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ssp_torch.data.base import ImageDataset, read_gray
from ssp_torch.registry import register
from ssp_torch.utils.experiment import settings_paths

log = logging.getLogger(__name__)

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


@register("dataset", "Coco")
class CocoDataset(ImageDataset):
    def __init__(
        self,
        task: str = "train",
        root: Optional[Path] = None,
        labels: Optional[Path] = None,
        preprocessing: Optional[Dict[str, Any]] = None,
        max_points: int = 1000,
        **_unused: Any,
    ):
        self.task = task
        self.root = Path(root) if root else settings_paths()["DATA_PATH"] / "COCO"
        self.resize = (preprocessing or {}).get("resize")
        self.max_points = int(max_points)

        img_dir = self.root / self.split_dir(task)
        self.files = sorted(p for p in img_dir.iterdir()
                            if p.suffix.lower() in IMAGE_EXTS) if img_dir.is_dir() else []
        self.labels_dir: Optional[Path] = None
        if labels:
            # label join: only images with a pseudo-label file (reference
            # datasets/Coco.py:96-117)
            self.labels_dir = Path(labels) / self.split_dir(task)
            before = len(self.files)
            self.files = [f for f in self.files if (self.labels_dir / f"{f.stem}.npz").exists()]
            if len(self.files) < before:
                log.info("label join dropped %d/%d unlabeled images",
                         before - len(self.files), before)

    @staticmethod
    def split_dir(split: str) -> str:
        return "train2017" if split.startswith("train") else "val2017"

    def __len__(self) -> int:
        return len(self.files)

    def _load_points(self, stem: str):
        points = np.zeros((self.max_points, 2), np.float32)
        valid = np.zeros((self.max_points,), bool)
        if self.labels_dir is not None:
            with np.load(self.labels_dir / f"{stem}.npz") as z:
                arr = z["pts"]  # bind once: NpzFile decompresses per access
                pts = np.asarray(arr, np.float32).reshape(-1, arr.shape[-1])
            k = min(len(pts), self.max_points)
            points[:k] = pts[:k, :2]
            valid[:k] = True
        return points, valid

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        path = self.files[idx]
        points, valid = self._load_points(path.stem)
        return {
            "image": read_gray(path, self.resize),
            "points": points,
            "points_valid": valid,
            "name": path.stem,
        }
