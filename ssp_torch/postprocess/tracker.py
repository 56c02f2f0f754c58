"""Two-way nearest-neighbour matching and multi-frame point tracks (port
of ``ssp/postprocess/tracker.py``).

Host-side numpy, by design, as in the JAX package: matching and tracking
are part of the *evaluation protocol* (HPatches export, matching score, NN
mAP — reference ``models/model_wrap.py:426-649``), so they stay in the same
arithmetic as the reference's eval path.  A fixed-shape matcher on tensors,
for the device, is :func:`nn_match_two_way_torch`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def nn_match_two_way(desc1: np.ndarray, desc2: np.ndarray, nn_thresh: float) -> np.ndarray:
    """Mutual nearest-neighbour descriptor matching.

    desc1/desc2: [D, N1], [D, N2] unit-norm descriptors (column-major,
    the reference layout).  Returns matches [3, L]:
    (index1, index2, distance), with distance = sqrt(2 - 2·cos) and
    matches kept only when mutual and distance < nn_thresh.
    Contract from ``models/model_wrap.py:451-494``.
    """
    if desc1.shape[1] == 0 or desc2.shape[1] == 0:
        return np.zeros((3, 0))
    if nn_thresh < 0.0:
        raise ValueError("nn_thresh must be non-negative")
    sim = desc1.T @ desc2
    dmat = np.sqrt(np.maximum(2.0 - 2.0 * np.clip(sim, -1.0, 1.0), 0.0))
    idx = np.argmin(dmat, axis=1)
    scores = dmat[np.arange(dmat.shape[0]), idx]
    keep = scores < nn_thresh
    idx2 = np.argmin(dmat, axis=0)
    keep &= np.arange(len(idx)) == idx2[idx]
    m1 = np.flatnonzero(keep)
    return np.stack([m1.astype(float), idx[keep].astype(float), scores[keep]])


def nn_match_two_way_torch(desc1: torch.Tensor, desc2: torch.Tensor,
                           nn_thresh: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape twin on tensors: desc1 [N1, D], desc2 [N2, D] unit-norm
    → (idx2 [N1], valid [N1], dist [N1]), where ``valid[i]`` ⇔ point i of
    set 1 mutually matches ``idx2[i]`` of set 2 under the distance
    threshold, and ``dist[i]`` is its distance sqrt(2 − 2·cos)."""
    sim = desc1 @ desc2.T  # [N1, N2], unit-norm → cos
    dmat = torch.sqrt(torch.clamp(2.0 - 2.0 * torch.clamp(sim, -1.0, 1.0), min=0.0))
    idx = torch.argmin(dmat, dim=1)  # ties: the first index, as argmin in numpy and JAX
    scores = dmat.gather(1, idx[:, None])[:, 0]
    idx_back = torch.argmin(dmat, dim=0)
    mutual = torch.arange(dmat.shape[0], device=dmat.device) == idx_back[idx]
    return idx, mutual & (scores < nn_thresh), scores


class PointTracker:
    """Fixed-memory point tracker (max ``max_length`` frames).

    Re-derivation of the reference tracker's observable behaviour
    (``models/model_wrap.py:426-649``): feed frames with ``update(pts,
    desc)``; after ≥2 updates, ``get_matches()`` returns the matched
    point coordinates between the last two frames as a [4, L] array
    (x1, y1, x2, y2 stacked), which is what the HPatches export and the
    mAP evaluation consume.  ``get_tracks``/track table support longer
    chains for the SLAM-style use.
    """

    def __init__(self, max_length: int = 2, nn_thresh: float = 0.7):
        if max_length < 2:
            raise ValueError("max_length must be >= 2")
        self.maxl = max_length
        self.nn_thresh = nn_thresh
        self.all_pts: List[np.ndarray] = [np.zeros((2, 0)) for _ in range(max_length)]
        self.last_desc: Optional[np.ndarray] = None
        self.last_pts: Optional[np.ndarray] = None
        self.matches: Optional[np.ndarray] = None
        self.mscores: Optional[np.ndarray] = None
        # tracks: [track_id, avg_score, pt_id_0 … pt_id_{L-1}]
        self.tracks = np.zeros((0, max_length + 2))
        self.track_count = 0
        self._unset_score = 9999.0

    # -- protocol -----------------------------------------------------
    def update(self, pts: np.ndarray, desc: np.ndarray) -> None:
        """pts: [3, N] (x, y, conf); desc: [D, N]."""
        assert pts.shape[1] == desc.shape[1]
        if self.last_desc is None:
            self.last_desc = np.zeros((desc.shape[0], 0))

        remove_size = self.all_pts[0].shape[1]
        self.all_pts.pop(0)
        self.all_pts.append(pts[:2])

        # age the track table by one frame
        self.tracks = np.delete(self.tracks, 2, axis=1)
        self.tracks[:, 2:] -= remove_size
        self.tracks[:, 2:][self.tracks[:, 2:] < -1] = -1
        offsets = np.cumsum([0] + [p.shape[1] for p in self.all_pts[:-1]])
        self.tracks = np.hstack([self.tracks, -np.ones((self.tracks.shape[0], 1))])

        raw = nn_match_two_way(self.last_desc, desc, self.nn_thresh)
        self.mscores = raw
        if self.last_pts is not None:
            i1 = raw[0].astype(int)
            i2 = raw[1].astype(int)
            self.matches = np.concatenate(
                [self.last_pts[:, i1], pts[:2, i2]], axis=0
            )  # [4, L]
        else:
            # first frame: no previous points — keep the documented
            # [4, L] coordinate contract (raw is [3, 0] index/dist rows)
            self.matches = np.zeros((4, 0))

        matched = np.zeros(pts.shape[1], bool)
        for i1f, i2f, score in raw.T:
            gid1 = int(i1f) + offsets[-2]
            gid2 = int(i2f) + offsets[-1]
            rows = np.flatnonzero(self.tracks[:, -2] == gid1)
            if rows.size:
                matched[int(i2f)] = True
                r = rows[0]
                self.tracks[r, -1] = gid2
                if self.tracks[r, 1] == self._unset_score:
                    self.tracks[r, 1] = score
                else:
                    n = (self.tracks[r, 2:] != -1).sum() - 1.0
                    f = 1.0 / n
                    self.tracks[r, 1] = (1 - f) * self.tracks[r, 1] + f * score

        new_ids = (np.arange(pts.shape[1]) + offsets[-1])[~matched]
        fresh = -np.ones((new_ids.size, self.maxl + 2))
        fresh[:, 0] = self.track_count + np.arange(new_ids.size)
        fresh[:, 1] = self._unset_score
        fresh[:, -1] = new_ids
        self.tracks = np.vstack([self.tracks, fresh])
        self.track_count += new_ids.size
        self.tracks = self.tracks[np.any(self.tracks[:, 2:] >= 0, axis=1)]

        self.last_desc = desc.copy()
        self.last_pts = pts[:2].copy()

    def get_matches(self) -> Optional[np.ndarray]:
        return self.matches

    def get_mscores(self) -> Optional[np.ndarray]:
        return self.mscores

    def get_tracks(self, min_length: int) -> np.ndarray:
        if min_length < 1:
            raise ValueError("min_length must be >= 1")
        good = (self.tracks[:, 2:] != -1).sum(axis=1) >= min_length
        headed = self.tracks[:, -1] != -1
        return self.tracks[good & headed].copy()

    def clear_desc(self) -> None:
        self.last_desc = None
