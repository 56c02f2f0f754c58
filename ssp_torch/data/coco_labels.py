"""COCO panoptic 133-class label table (the port's copy of
``ssp/data/coco_labels.py``).

The reference ships the panoptic category list and a raw-id → train-id
mapping in ``utils/coco_labels.py:1-160`` (80 "thing" + 53 "stuff"
categories; the raw COCO category ids are sparse in [1, 200]).  The
train id of a category is its rank in the sorted id list; every id that
is not a panoptic category (including 0 and the gaps) maps to the
ignore class 133.

Only the id table itself is reproduced here — it is factual COCO
dataset metadata, not code.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

# The 133 COCO panoptic category ids, sorted ascending.  Things are
# ids 1..90 (with the historical COCO gaps), stuff 92..200.
PANOPTIC_IDS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
    80, 81, 82, 84, 85, 86, 87, 88, 89, 90, 92, 93, 95, 100, 107, 109,
    112, 118, 119, 122, 125, 128, 130, 133, 138, 141, 144, 145, 147,
    148, 149, 151, 154, 155, 156, 159, 161, 166, 168, 171, 175, 176,
    177, 178, 180, 181, 184, 185, 186, 187, 188, 189, 190, 191, 192,
    193, 194, 195, 196, 197, 198, 199, 200,
)

N_CLASSES = len(PANOPTIC_IDS)  # 133
IGNORE_CLASS = 133


def builtin_mapping() -> np.ndarray:
    """[256] int32 lookup table: raw panoptic category id → train id.

    ``table[raw_id]`` is the sorted-rank train id in [0, 132] for the
    133 panoptic ids and ``IGNORE_CLASS`` (133) everywhere else —
    applying it as ``table[raw]`` can therefore never emit an id the
    133-way semantic CE would silently clamp.
    """
    table = np.full(256, IGNORE_CLASS, dtype=np.int32)
    for rank, cid in enumerate(PANOPTIC_IDS):
        table[cid] = rank
    return table


def load_panoptic_mapping(annotations_json: Optional[Path]) -> np.ndarray:
    """Mapping table from a panoptic ``categories`` json if present,
    else the built-in table (reference derives its table from exactly
    this json; the two agree for the shipped COCO 2017 panoptic set).
    """
    if annotations_json is None:
        return builtin_mapping()
    path = Path(annotations_json)
    if not path.exists():
        return builtin_mapping()
    import json

    with open(path) as f:
        spec = json.load(f)
    cats = spec["categories"] if isinstance(spec, dict) else spec
    ids = sorted(c["id"] for c in cats)
    table = np.full(max(256, max(ids) + 1), IGNORE_CLASS, dtype=np.int32)
    for rank, cid in enumerate(ids):
        table[cid] = rank
    return table
