"""Cached synthetic-shapes corpus (port of ``ssp/data/synthetic_dataset.py``;
reference ``datasets/SyntheticDataset_gaussian.py``).

Each (primitive, split) shard is one seeded npz under
``DATA_PATH/synthetic_shapes_<suffix>/`` with the JAX package's file name,
arrays and seed streams, so a shard written by either package is read by
the other: the samples are the same bytes
(:func:`ssp_torch.data.synthetic_shapes.generate_sample`).  Labels are
padded to ``MAX_POINTS`` so batches have one shape.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ssp_torch.data.base import ImageDataset
from ssp_torch.data.synthetic_shapes import PRIMITIVES, generate_sample
from ssp_torch.registry import register
from ssp_torch.utils.experiment import settings_paths

log = logging.getLogger(__name__)

DEFAULT_SPLIT_SIZES = {"training": 10000, "validation": 200, "test": 500}
_TASK_TO_SPLIT = {"train": "training", "val": "validation", "test": "test"}

# pad target: generous upper bound on points per synthetic image
MAX_POINTS = 120


@register("dataset", "SyntheticDataset_gaussian", "SyntheticShapes")
class SyntheticShapesDataset(ImageDataset):
    def __init__(
        self,
        task: str = "train",
        primitives: Any = "all",
        truncate: Optional[Dict[str, float]] = None,
        suffix: Optional[str] = None,
        generation: Optional[Dict[str, Any]] = None,
        preprocessing: Optional[Dict[str, Any]] = None,
        cache_dir: Optional[Path] = None,
        seed: int = 0,
        **_unused: Any,
    ):
        self._configure(task, primitives, suffix, generation, preprocessing, cache_dir, seed)
        truncate = dict(truncate or {})
        imgs: List[np.ndarray] = []
        pts: List[np.ndarray] = []
        valid: List[np.ndarray] = []
        for prim in self.primitives:
            i, p, v = self._load_shard(prim)
            frac = float(truncate.get(prim, 1.0))
            keep = max(int(round(len(i) * frac)), 1)
            imgs.append(i[:keep])
            pts.append(p[:keep])
            valid.append(v[:keep])
        self._images = np.concatenate(imgs, axis=0)
        self._points = np.concatenate(pts, axis=0)
        self._valid = np.concatenate(valid, axis=0)

    def _configure(self, task, primitives, suffix, generation, preprocessing, cache_dir,
                   seed) -> None:
        self.split = _TASK_TO_SPLIT.get(task, task)
        if primitives in ("all", None):
            prims = list(PRIMITIVES)
        else:
            prims = list(primitives)
        unknown = set(prims) - set(PRIMITIVES)
        if unknown:
            raise KeyError(f"unknown primitives {sorted(unknown)}")
        self.primitives = prims
        gen = dict(generation or {})
        sizes = dict(DEFAULT_SPLIT_SIZES)
        sizes.update(gen.get("split_sizes") or {})
        self.per_primitive = int(sizes.get(self.split, sizes["training"]))
        prep = dict(preprocessing or {})
        self.resize = tuple(int(v) for v in (prep.get("resize") or (240, 320)))
        self.blur_size = int(prep.get("blur_size", 11))
        self.seed = int(gen.get("random_seed", seed))

        if cache_dir is None:
            name = "synthetic_shapes" + (f"_{suffix}" if suffix else "")
            cache_dir = settings_paths()["DATA_PATH"] / name
        self.cache_dir = Path(cache_dir)

    @classmethod
    def missing_shards(cls, task: str = "train", primitives: Any = "all",
                       suffix: Optional[str] = None, generation: Optional[Dict[str, Any]] = None,
                       preprocessing: Optional[Dict[str, Any]] = None,
                       cache_dir: Optional[Path] = None, seed: int = 0,
                       **_unused: Any) -> Dict[str, int]:
        """{primitive: samples} of the shards of this configuration that are
        not cached yet (what constructing the dataset would generate)."""
        ds = cls.__new__(cls)
        ds._configure(task, primitives, suffix, generation, preprocessing, cache_dir, seed)
        return {p: ds.per_primitive for p in ds.primitives if not ds._shard_path(p).exists()}

    # -- generation / cache -------------------------------------------
    def _shard_path(self, prim: str) -> Path:
        h, w = self.resize
        return self.cache_dir / (
            f"{prim}_{self.split}_{self.per_primitive}_{h}x{w}"
            f"_b{self.blur_size}_s{self.seed}.npz"
        )

    def _load_shard(self, prim: str):
        path = self._shard_path(prim)
        if path.exists():
            with np.load(path) as z:
                return z["images"], z["points"], z["valid"]
        log.info("generating %d %s/%s samples → %s",
                 self.per_primitive, prim, self.split, path)
        n = self.per_primitive
        h, w = self.resize
        images = np.zeros((n, h, w), np.float32)
        points = np.zeros((n, MAX_POINTS, 2), np.float32)
        valid = np.zeros((n, MAX_POINTS), bool)
        # disjoint seed streams per (split, index); the primitive is
        # folded in by generate_sample itself.  The 200k stride bounds
        # the per-split size — enforce it so an oversized config can't
        # silently alias training seeds into the validation/test streams
        # (train/val leakage).
        if n > 200_000:
            raise ValueError(
                f"split_sizes[{self.split}]={n} exceeds the 200000-sample "
                "seed-stream stride; raise the stride to grow further"
            )
        split_off = {"training": 0, "validation": 1, "test": 2}.get(self.split, 3)
        for i in range(n):
            s = self.seed * 1_000_003 + split_off * 200_000 + i
            img, p = generate_sample(prim, size=self.resize, seed=s, blur_size=self.blur_size)
            images[i] = img
            k = min(len(p), MAX_POINTS)
            points[i, :k] = p[:k]
            valid[i, :k] = True
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, images=images, points=points, valid=valid)
        return images, points, valid

    # -- dataset protocol ----------------------------------------------
    def __len__(self) -> int:
        return len(self._images)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return {
            "image": self._images[idx],
            "points": self._points[idx],
            "points_valid": self._valid[idx],
            "name": str(idx),
        }
