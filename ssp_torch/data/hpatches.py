"""HPatches evaluation pairs (port of ``ssp/data/hpatches.py``; reference
``datasets/patches_dataset.py``).

Each sequence directory holds ``1.ppm`` plus warped views ``2..6.ppm``
with ground-truth homographies ``H_1_<i>``; the dataset yields up to 5
(reference, warped, H) pairs per sequence.  ``alteration`` filters to
illumination (``i``) or viewpoint (``v``) sequences.  When a resize is
configured, H is conjugated into the resized frame
(``patches_dataset.py:101-113``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ssp_torch.data.base import ImageDataset, read_gray, read_pnm_header
from ssp_torch.registry import register
from ssp_torch.utils.experiment import settings_paths


def _rescale_homography(H: np.ndarray, raw_ref, new_ref, raw_warp, new_warp) -> np.ndarray:
    """Adapt a pixel-coordinate H (ref → warped) to resized images:
    S₂ · H · S₁⁻¹, each side scaled by its own image's resize ratio
    (reference ``_adapt_homography_to_preprocessing``,
    ``datasets/patches_dataset.py:81-92``)."""
    s1 = np.diag([new_ref[1] / raw_ref[1], new_ref[0] / raw_ref[0], 1.0])
    s2 = np.diag([new_warp[1] / raw_warp[1], new_warp[0] / raw_warp[0], 1.0])
    return s2 @ H @ np.linalg.inv(s1)


@register("dataset", "hpatches", "PatchesDataset", "patches_dataset")
class PatchesDataset(ImageDataset):
    def __init__(
        self,
        task: str = "test",
        root: Optional[Path] = None,
        alteration: str = "all",
        preprocessing: Optional[Dict[str, Any]] = None,
        **_unused: Any,
    ):
        self.root = Path(root) if root else settings_paths()["DATA_PATH"] / "HPatches"
        self.resize = (preprocessing or {}).get("resize")
        self.pairs: List[Dict[str, Any]] = []
        for seq in sorted(p for p in self.root.iterdir() if p.is_dir()):
            if alteration in ("i", "v") and not seq.name.startswith(alteration):
                continue
            ref = seq / "1.ppm"
            if not ref.exists():
                continue
            for i in range(2, 7):
                warped = seq / f"{i}.ppm"
                h_file = seq / f"H_1_{i}"
                if warped.exists() and h_file.exists():
                    self.pairs.append({"name": f"{seq.name}/1_{i}", "ref": ref,
                                       "warped": warped, "H": h_file})

    def __len__(self) -> int:
        return len(self.pairs)

    @staticmethod
    def _raw_shape(path: Path) -> tuple:
        """(H, W) of an image file, from its header."""
        return read_pnm_header(path)[:2]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rec = self.pairs[idx]
        img = read_gray(rec["ref"], self.resize)
        warped = read_gray(rec["warped"], self.resize)
        H = np.loadtxt(rec["H"]).astype(np.float64).reshape(3, 3)
        if self.resize is not None:
            H = _rescale_homography(H, self._raw_shape(rec["ref"]), img.shape,
                                    self._raw_shape(rec["warped"]), warped.shape)
        return {"image": img, "warped_image": warped, "homography": H, "name": rec["name"]}
