"""The numbers that decide ``correct``: the program's keypoints and
descriptors held against the plain reference's, image by image, pooled over
every image compared.

For each image, with P the program's valid points and R the reference's
(both refined, in pixels):

* ``kp_miss``: 1 − the smaller of the share of R with a point of P within
  1 px and the share of P with a point of R within 1 px (0 where both hold
  no point); the largest over the images;
* ``score_gap_p99``: the 99th percentile of the gap between the score of a
  point of P and that of its nearest point of R, over the pairs within 1 px;
* ``desc_gap_p99``: the 99th percentile of the L2 distance between the
  descriptor the program gave a point of P and the reference's descriptor
  sampled at that point;
* ``desc_far``: how many of those distances exceed 1, an angle over 60°: a
  descriptor that is wrong, not rounded.

The widest gaps themselves are not compared: at bfloat16 a few cells'
descriptors and logits lose most of their digits to cancellation, so the
widest gap swings from 0.29 to 0.52 between seeds (PERF.md).  The verdict
compares the numbers that the mix's ``limits`` name.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

MATCH_PX = 1.0
FAR = 1.0


def image_numbers(pts: torch.Tensor, valid: torch.Tensor, ref_pts: torch.Tensor,
                  ref_valid: torch.Tensor, desc: torch.Tensor,
                  ref_desc_at_pts: torch.Tensor) -> Dict:
    """One image: the program's (pts [K, 3], valid [K], desc [K, D]), the
    reference's (pts, valid) and its descriptors at the program's points [K, D]."""
    p, r = pts[valid], ref_pts[ref_valid]
    out: Dict = {"kp_miss": float(len(p) != len(r)), "score": torch.zeros(0),
                 "desc": torch.linalg.vector_norm(desc[valid] - ref_desc_at_pts[valid],
                                                  dim=-1).cpu()}
    if len(p) == 0 or len(r) == 0:
        return out
    d = torch.cdist(p[:, :2].double(), r[:, :2].double())
    near_p, nearest = d.min(dim=1)
    hit_p, hit_r = near_p <= MATCH_PX, d.min(dim=0).values <= MATCH_PX
    out["kp_miss"] = 1.0 - min(float(hit_p.float().mean()), float(hit_r.float().mean()))
    out["score"] = (p[:, 2] - r[nearest, 2]).abs()[hit_p].cpu()
    return out


def summarize(per_image: List[Dict]) -> Dict[str, float]:
    def p99(key: str) -> float:
        pooled = torch.cat([n[key] for n in per_image]).double()
        return float(torch.quantile(pooled, 0.99)) if len(pooled) else 0.0

    desc = torch.cat([n["desc"] for n in per_image])
    return {"kp_miss": max(n["kp_miss"] for n in per_image), "score_gap_p99": p99("score"),
            "desc_gap_p99": p99("desc"), "desc_far": float((desc > FAR).sum())}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a number
    that is missing or not finite fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        table[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, table
