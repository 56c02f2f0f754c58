"""HPatches keypoint, descriptor and match export, stage 4a (port of
``ssp/export/descriptors_export.py``).

Reference pipeline (``export.py:66-189``): per image pair, run the model,
NMS + threshold + top-k keypoints, optional soft-argmax subpixel
refinement, sample descriptors at the keypoints, two-way-match the pair,
and write one npz per pair with keys ``image, prob, desc, warped_image,
warped_prob, warped_desc, homography, matches`` (read by the evaluation).

Detection and description run on the device, one image per call, as the
JAX package runs them; matching and the npz writes stay on the host (the
evaluation protocol's arithmetic).  The JAX package's ``topk_method=
"approx"`` and ``desc_sampler="mxu"`` are TPU workarounds and are not
carried over (``ssp_torch/postprocess/points.py``): the exact top-k and the
gather sampler are the path.  :func:`make_detect_describe_var_fn` is the
form that takes the weights as an argument, for checkpoint sweeps
(``ssp_torch/cli/export_eval.py``).  :func:`run_sequence_export` is the SLAM
sequence export's loop (``ssp/cli/export.py:126-168``): one npz of valid
points and descriptors per frame.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ssp_torch._device import resolve_device
from ssp_torch.core.grid import flatten_detection
from ssp_torch.kernels.nms import nms_plain
from ssp_torch.postprocess.nms import batched_nms
from ssp_torch.postprocess.points import extract_keypoints, sample_descriptors, soft_argmax_refine
from ssp_torch.postprocess.tracker import PointTracker
from ssp_torch.trace import span


def make_detect_describe_fn(
    apply_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    *,
    device="cuda",
    top_k: int = 1000,
    conf_thresh: float = 0.015,
    nms_radius: int = 4,
    subpixel: bool = True,
    patch_size: int = 5,
    nms_iterations: int = 3,
    reference: bool = False,
):
    """``detect_describe(image [H, W]) → (pts [k, 3] (x, y, score), valid
    [k], desc [k, D])`` on ``device``; a ``[B, H, W]`` batch gives batched
    results.

    ``apply_fn(images [B, H, W, 1]) → {"semi", "desc", ...}`` is the model
    on ``device`` (``ssp_torch.models.fast_infer.best_apply_fn``).  The steps
    are the JAX package's: flatten the detector logits; suppress with the
    4-px border removed (the NMS kernel on the card); top-k over the
    suppressed map; refine the points on the un-suppressed heatmap; sample
    the descriptors at the refined points.  ``reference=True`` runs the NMS
    kernel's plain version instead (the card-side check of the kernels;
    give it an ``apply_fn`` built the same way).
    """
    dev = resolve_device(device)
    suppress = nms_plain if reference else batched_nms

    @torch.inference_mode()
    def detect_describe(image):
        # the root times the call on the host alone: no metric reads its
        # device interval, and under the profiler each event record costs
        # the host ~13 us, much of it while the card waits
        with span("ssp.detect"):
            with span("ssp.detect.upload", dev) as s:
                # a plain copy, not ``to_device``'s pinned one: the export waits
                # for each call's results before the next, so nothing is queued
                # that the copy could wait for, and pinning a fresh buffer per
                # image cost ~7 ms of host time per call inside the export on
                # the H100's host
                x = torch.as_tensor(image, dtype=torch.float32)
                if s is not None and x.device.type == "cpu" and not x.is_pinned():
                    s.counts["pageable_bytes"] = x.nbytes
                x = x.to(dev)
            squeeze = x.dim() == 2
            if squeeze:
                x = x[None]
            with span("ssp.detect.forward", dev):
                out = apply_fn(x[..., None])
            with span("ssp.detect.postprocess", dev):
                heat = flatten_detection(out["semi"])[..., 0].contiguous()
                heat_nms = suppress(heat, nms_radius, nms_iterations, border=4)
                pts, valid = extract_keypoints(heat_nms, k=top_k, conf_thresh=conf_thresh,
                                               nms_radius=0, border=0, nms_iterations=1)
                if subpixel:
                    pts = soft_argmax_refine(heat, pts, patch_size)
                desc = sample_descriptors(out["desc"], pts)
        return (pts[0], valid[0], desc[0]) if squeeze else (pts, valid, desc)

    return detect_describe


def make_detect_describe_var_fn(
    model: nn.Module,
    *,
    device="cuda",
    input_hw: Optional[Tuple[int, int]] = None,
    fast_inference: bool = True,
    **kw,
):
    """``fn(state_dict, image) → (pts, valid, desc)``: the weights as an
    argument, as the JAX package's form takes its variables, for checkpoint
    sweeps.

    PyTorch has no traced weights, so ``fn`` loads ``state_dict`` (reference
    names, :func:`ssp_torch.models.weights.read_state_dict`) into ``model``
    strictly and builds :func:`make_detect_describe_fn` over
    ``best_apply_fn(model, input_hw, fast_inference)`` (``kw`` goes to it),
    only when it is given another state dict object than the last call: a
    sweep folds the BatchNorm once per checkpoint.  A state dict that does
    not load raises, and the next call loads again."""
    from ssp_torch.models.fast_infer import best_apply_fn
    from ssp_torch.models.weights import load_reference_state_dict

    dev = resolve_device(device)
    model = model.to(dev).eval()
    loaded: Dict[str, Any] = {"weights": None, "fn": None}

    def fn(state_dict: Mapping[str, Any], image):
        if state_dict is not loaded["weights"]:
            loaded["weights"] = None  # a failed load leaves the module partly written
            load_reference_state_dict(model, state_dict)
            loaded["fn"] = make_detect_describe_fn(
                best_apply_fn(model, input_hw=input_hw, enable=fast_inference, device=dev),
                device=dev, **kw)
            loaded["weights"] = state_dict
        return loaded["fn"](image)

    return fn


def _host(result):
    """(pts, valid, desc) on the device → the valid rows as numpy."""
    pts, valid, desc = (t.cpu().numpy() for t in result)
    return pts[valid], desc[valid]


def run_descriptor_export(
    dd_fn,
    pairs: Iterable[Dict[str, Any]],
    out_dir: Path,
    *,
    nn_thresh: float = 1.0,
) -> int:
    """Export every pair dict (from ``PatchesDataset``) to
    ``<out_dir>/<idx>.npz`` and return how many files were written.

    File naming is the reference's sequential integer scheme
    (``evaluation.py:124`` sorts numerically).  A file that exists is
    skipped, so a stopped run resumes; only new writes are counted."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    for idx, pair in enumerate(pairs):
        out_file = out_dir / f"{idx}.npz"
        if out_file.exists():
            continue
        pts1, desc1 = _host(dd_fn(pair["image"]))
        pts2, desc2 = _host(dd_fn(pair["warped_image"]))

        tracker = PointTracker(max_length=2, nn_thresh=nn_thresh)
        tracker.update(pts1.T, desc1.T)
        tracker.update(pts2.T, desc2.T)
        matches = tracker.get_matches()  # [4, L]

        np.savez_compressed(
            out_file,
            image=pair["image"],
            warped_image=pair["warped_image"],
            prob=pts1,
            warped_prob=pts2,
            desc=desc1,
            warped_desc=desc2,
            homography=pair["homography"],
            matches=matches.T if matches is not None else np.zeros((0, 4)),
        )
        count += 1
    return count


def run_sequence_export(dd_fn, images: Iterable[Tuple[str, np.ndarray]], out_root: Path) -> int:
    """Write ``<out_root>/<name>.npz`` with the valid rows of ``pts`` (x, y,
    score) and ``desc`` for every (name, image [H, W]) pair, skipping files
    that exist (a stopped run resumes); returns how many were written.
    Names may hold a directory (``<scene>/<frame>``)."""
    out_root = Path(out_root)
    count = 0
    for name, image in images:
        out_file = out_root / f"{name}.npz"
        if out_file.exists():
            continue
        out_file.parent.mkdir(parents=True, exist_ok=True)
        pts, desc = _host(dd_fn(image))
        np.savez_compressed(out_file, pts=pts, desc=desc)
        count += 1
    return count
