"""Driving and indoor sequence readers: KITTI, TUM, ApolloScape (port of
``ssp/data/kitti.py``; reference ``datasets/Kitti_inh.py``, ``Tum.py``,
``Apollo.py``).

All three share one pattern: a split txt lists scene directories; the
frames live in a per-dataset subpath of each scene (or the scene root);
homography-adaptation labels join by ``<split>/<scene>/<frame>.npz``.  One
reader parametrised by the frame subpath covers all three.  Frames are PNG
or JPEG, decoded without OpenCV (:func:`ssp_torch.data.base.read_gray`).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ssp_torch.data.base import ImageDataset, read_gray
from ssp_torch.registry import register
from ssp_torch.utils.experiment import settings_paths

log = logging.getLogger(__name__)

IMAGE_EXTS = (".png", ".jpg", ".jpeg")


@register("dataset", "Kitti_inh", "Kitti")
class KittiDataset(ImageDataset):
    #: scene-relative directory holding the frames (KITTI raw layout,
    #: reference ``Kitti_inh.py:83``); falls back to the scene root.
    FRAME_SUBPATH = "image_02/data"
    DATA_DIR = "kitti"

    def __init__(
        self,
        task: str = "train",
        root: Optional[Path] = None,
        root_split_txt: Optional[Path] = None,
        labels: Optional[Path] = None,
        preprocessing: Optional[Dict[str, Any]] = None,
        max_points: int = 1000,
        **_unused: Any,
    ):
        self.task = task
        self.root = Path(root) if root else settings_paths()["DATA_PATH"] / self.DATA_DIR
        split_root = Path(root_split_txt) if root_split_txt else self.root
        self.resize = (preprocessing or {}).get("resize")
        self.max_points = int(max_points)
        self.labels_dir = Path(labels) / self.split_dir(task) if labels else None

        split_file = split_root / f"{task}.txt"
        if not split_file.exists():
            raise FileNotFoundError(f"split list not found: {split_file}")
        scenes = [ln.strip() for ln in split_file.read_text().splitlines() if ln.strip()]

        self.frames: List[Dict[str, Any]] = []
        for scene in scenes:
            frame_dir = self.root / scene / self.FRAME_SUBPATH
            if not frame_dir.is_dir():
                frame_dir = self.root / scene
            files = sorted(p for p in frame_dir.iterdir()
                           if p.suffix.lower() in IMAGE_EXTS) if frame_dir.is_dir() else []
            for f in files:
                if self.labels_dir is not None and \
                        not (self.labels_dir / scene / f"{f.stem}.npz").exists():
                    continue
                self.frames.append({"path": f, "scene": scene, "name": f"{scene}/{f.stem}"})
        if not self.frames:
            log.warning("%s: no frames for task=%s under %s", type(self).__name__, task,
                        self.root)

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rec = self.frames[idx]
        points = np.zeros((self.max_points, 2), np.float32)
        valid = np.zeros((self.max_points,), bool)
        if self.labels_dir is not None:
            with np.load(self.labels_dir / rec["scene"] / f"{rec['path'].stem}.npz") as z:
                arr = z["pts"]
                pts = np.asarray(arr, np.float32).reshape(-1, arr.shape[-1])
            k = min(len(pts), self.max_points)
            points[:k] = pts[:k, :2]
            valid[:k] = True
        return {
            "image": read_gray(rec["path"], self.resize),
            "points": points,
            "points_valid": valid,
            "name": rec["name"],
        }


@register("dataset", "Tum")
class TumDataset(KittiDataset):
    """TUM RGB-D sequences: frames under ``<scene>/rgb`` (reference
    ``datasets/Tum.py``)."""

    FRAME_SUBPATH = "rgb"
    DATA_DIR = "tum"


@register("dataset", "Apollo")
class ApolloDataset(KittiDataset):
    """ApolloScape sequences (reference ``datasets/Apollo.py``): frames
    directly under the scene directory."""

    FRAME_SUBPATH = "."
    DATA_DIR = "apollo"
