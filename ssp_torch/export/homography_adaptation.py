"""Homography-adaptation pseudo-label export (port of
``ssp/export/homography_adaptation.py``).

For each image a stack of ``num`` random warps (the identity in slot 0) goes
through the detector; the heatmaps are warped back, masked, aggregated as
Σheat/Σmask (or their maximum), and NMS + top-k selects the pseudo-label
keypoints, written as one npz per image.  Sampling, warping, the batched
forward, the inverse warp, aggregation, NMS and top-k all run on the
device; the host decodes images and writes the files.

The three stages are plain functions under ``torch.inference_mode()``:
(1) the warp stack of a whole group of images, (2) forward + back-warp +
masked accumulation per chunk of warps, (3) aggregate + NMS + top-k.  With
``one_dispatch`` the JAX package compiles the same chain into one program,
a ``lax.scan`` over chunks that tile every image's warps alike; here that
chain is one CUDA graph per group shape (``ssp_torch.graphs``), fed by a
host prologue that draws the group's homographies and makes the warp plans
of both warps, so a group costs one graph launch instead of thousands of
eager ones.  On the CPU the same chain runs eagerly.  The JAX package's
``mesh`` splits each group over the devices and its processes each write
their rows; here :func:`run_ha_export` takes a ``rank`` and a ``world``, and
each rank (one per card) exports its share of the image list and writes
only its own files.

Homographies are sampled on the host, from per-image CPU generators (a few
hundred 3×3 matrices per group): the same seed gives the same homographies
on any device, and the warp's rotation buckets are known without waiting
for the card.  Sums over the warps of one image are taken chunk by chunk in
a fixed order (a per-image ``sum``/``amax`` over the chunk's slice, no
atomics), so the same image with the same homographies gives the same
points bit for bit, whatever group it is exported in.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ssp_torch._device import resolve_device, to_device
from ssp_torch.core.grid import flatten_detection
from ssp_torch.core.homography import inv3, sample_homographies
from ssp_torch.core.warp import compute_valid_mask, inv_warp_image
from ssp_torch.graphs import CapturedRegion
from ssp_torch.kernels.nms import nms_plain
from ssp_torch.kernels.warp_twopass import inv_warp_image_twopass, twopass_apply, twopass_plan
from ssp_torch.postprocess.nms import batched_nms
from ssp_torch.postprocess.points import extract_keypoints, soft_argmax_refine

DEFAULT_HA = {
    "num": 100,
    "aggregation": "sum",
    "filter_counts": 0,
    "homographies": {
        "params": {
            "translation": True,
            "rotation": True,
            "scaling": True,
            "perspective": True,
            "scaling_amplitude": 0.2,
            "perspective_amplitude_x": 0.2,
            "perspective_amplitude_y": 0.2,
            "allow_artifacts": True,
            "patch_ratio": 0.85,
        }
    },
}

Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def _gather_warp(img: torch.Tensor, Hm: torch.Tensor) -> torch.Tensor:
    """The gather warp with the two-pass warp's signature: img [M, H, W],
    Hm [N, 3, 3] → [N, H, W]."""
    M, N = img.shape[0], Hm.shape[0]
    src = img[:, None].expand(M, N // M, *img.shape[1:]).reshape(N, *img.shape[1:], 1)
    return inv_warp_image(src, to_device(Hm, img.device))[..., 0]


def make_ha_fn(
    apply_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    *,
    device="cuda",
    num_h: int = 100,
    homography_params: Optional[Dict[str, Any]] = None,
    erosion_radius: int = 3,
    aggregation: str = "sum",
    filter_counts: int = 0,
    top_k: int = 600,
    conf_thresh: float = 0.015,
    nms_radius: int = 4,
    subpixel: bool = False,
    patch_size: int = 5,
    chunk: int = 100,
    use_twopass: bool = True,
    one_dispatch: bool = False,
    reference: bool = False,
):
    """Build the per-image-group HA callable.

    ``apply_fn(images [B, H, W, 1]) → {"semi", ...}`` is the detector on
    ``device`` (``ssp_torch.models.fast_infer.best_apply_fn``).  Returns
    ``ha(images [G, H, W], generator=None, homographies=None) → (pts [G,
    top_k, 3], valid [G, top_k])`` on ``device``; an unbatched ``[H, W]``
    image gives unbatched results.

    * ``generator``: one ``torch.Generator`` for the whole group, or one per
      image; each image draws its ``num_h − 1`` homographies from it.
    * ``homographies [G, num_h − 1, 3, 3]``: taken instead of sampling (the
      identity is prepended here), so that two implementations can be fed
      the same warps.

    The JAX package's parameters.  ``one_dispatch=True`` runs a group as one
    CUDA graph on a card (module docstring; captured at the first group of
    each shape, after its eager warm-up calls), eagerly on the CPU: the
    warps of each image tiled into ``num_h / chunk_n`` chunks of ``chunk_n``,
    the largest divisor of ``num_h`` with ``G·chunk_n ≤ chunk``, and the
    chunks summed in order, as the JAX package's ``one_dispatch``; the
    results agree with the staged chain's to fp32 accumulation order (the
    same bits where a chunk holds all of one image's warps, as with one
    image per group).  ``ha.regions`` holds the captured regions by ``(G, H,
    W)``.  ``reference=True`` runs the plain PyTorch versions of the
    resample and NMS kernels instead of the kernels (the card-side check of
    the kernels; give it an ``apply_fn`` built the same way).
    """
    if aggregation not in ("sum", "max"):
        raise ValueError(f"aggregation must be 'sum' or 'max', got {aggregation!r}")
    dev = resolve_device(device)
    h_params = dict(homography_params or DEFAULT_HA["homographies"]["params"])
    chunk = min(chunk, num_h)
    if use_twopass:
        warp = lambda img, Hm: inv_warp_image_twopass(img, Hm, reference=reference)  # noqa: E731
    else:
        warp = _gather_warp
    suppress = nms_plain if reference else batched_nms

    def sample(G: int, generator: Generators) -> torch.Tensor:
        gens = list(generator) if isinstance(generator, (list, tuple)) else [generator] * G
        if len(gens) != G:
            raise ValueError(f"{len(gens)} generators for {G} images")
        return torch.stack([sample_homographies(num_h - 1, generator=g, shift=-1.0, **h_params)
                            .cpu() for g in gens])

    def warp_stage(images: torch.Tensor, Hs: torch.Tensor) -> torch.Tensor:
        """[G, H, W], [G, N, 3, 3] → the flat warp stack [G·N, H, W]."""
        return warp(images, Hs.reshape(-1, 3, 3))

    def chunk_heat(imgs, Hs_inv, back_warp):
        """One chunk of warped images [n, H, W] with their inverse
        homographies (on the device): the forward, and the back-warped heat
        (``back_warp(heat)``) times the valid mask; returns both [n, H, W].

        Heat and counts are masked by the *same* closed-form back-warped
        valid mask (half-plane test, no resampling), so the mean heat's
        numerator and denominator always agree.  With ``erosion_radius`` ≥ 1
        the bilinear back-warp's 1-px blend ring at the un-eroded boundary
        lies outside the eroded mask, so no padding survives the multiply.
        """
        heat = flatten_detection(apply_fn(imgs[..., None])["semi"])[..., 0].contiguous()
        mask = compute_valid_mask(heat.shape[-2:], Hs_inv, erosion_radius)
        return back_warp(heat) * mask, mask

    def forward_stage(total, counts, maxs, imgs, Hs_inv, segments) -> None:
        """One chunk of the flat stack (:func:`chunk_heat`), accumulated into
        the per-image ``total``/``counts``/``maxs`` in place.  ``segments``
        lists (image, start, end) of the chunk's slices."""
        back, mask = chunk_heat(imgs, to_device(Hs_inv, dev), lambda h: warp(h, Hs_inv))
        for g, a, b in segments:
            total[g] += back[a:b].sum(dim=0)
            counts[g] += mask[a:b].sum(dim=0)
            if aggregation == "max":
                maxs[g] = torch.maximum(maxs[g], back[a:b].amax(dim=0))

    def finish_stage(total, counts, maxs):
        agg = maxs if aggregation == "max" else total / (counts + 1e-6)
        if filter_counts > 0:
            # drop pixels observed by too few warps
            agg = torch.where(counts >= filter_counts, agg, torch.zeros_like(agg))
        # suppress on the whole group (the fused kernel on the card), then
        # extract with NMS already applied
        agg_nms = suppress(agg.contiguous(), nms_radius, border=4)
        pts, valid = extract_keypoints(agg_nms, k=top_k, conf_thresh=conf_thresh,
                                       nms_radius=0, border=0, nms_iterations=1)
        if subpixel:
            pts = soft_argmax_refine(agg, pts, patch_size)
        return pts, valid

    def one_dispatch_chain(buf: Dict[str, torch.Tensor]):
        """The whole group from the prologue's tensors (on the group's
        device): warp stack, per chunk :func:`chunk_heat` and the masked
        sums, aggregate + NMS + top-k.  Reads nothing back to the
        host, so a card captures it as one graph."""
        images = buf["images"]
        G, H_img, W_img = images.shape
        cn = next(c for c in range(min(num_h, max(1, chunk // G)), 0, -1) if num_h % c == 0)
        if use_twopass:
            stack = twopass_apply(images, _sub(buf, "fwd."), reference)
            back_plan = {k: v.reshape(G, num_h, *v.shape[1:])
                         for k, v in _sub(buf, "back.").items()}
        else:
            stack = _gather_warp(images, buf["Hs"])
        stack = stack.reshape(G, num_h, H_img, W_img)
        Hs_inv = buf["Hs_inv"].reshape(G, num_h, 3, 3)
        total = torch.zeros(G, H_img, W_img, device=images.device)
        counts, maxs = torch.zeros_like(total), torch.zeros_like(total)
        for c in range(0, num_h, cn):
            imgs = stack[:, c:c + cn].reshape(G * cn, H_img, W_img)
            hinv = Hs_inv[:, c:c + cn].reshape(G * cn, 3, 3)
            if use_twopass:
                plan = {k: v[:, c:c + cn].reshape(G * cn, *v.shape[2:])
                        for k, v in back_plan.items()}
                back_warp = lambda h: twopass_apply(h, plan, reference)  # noqa: E731
            else:
                back_warp = lambda h: _gather_warp(h, hinv)  # noqa: E731
            back, mask = chunk_heat(imgs, hinv, back_warp)
            back = back.reshape(G, cn, H_img, W_img)
            total = total + back.sum(dim=1)
            counts = counts + mask.reshape(G, cn, H_img, W_img).sum(dim=1)
            if aggregation == "max":
                maxs = torch.maximum(maxs, back.amax(dim=1))
        return finish_stage(total, counts, maxs)

    regions: Dict[Tuple[int, int, int], CapturedRegion] = {}

    def run_one_dispatch(images: torch.Tensor, Hs: torch.Tensor, Hs_inv: torch.Tensor):
        """The host prologue (the warp plans of both warps) and the chain:
        one graph replay on a card, eagerly on the CPU."""
        G, H_img, W_img = images.shape
        buf = {"images": images, "Hs_inv": Hs_inv}
        if use_twopass:
            buf.update({f"fwd.{k}": v for k, v in twopass_plan(Hs, H_img, W_img).items()})
            buf.update({f"back.{k}": v for k, v in twopass_plan(Hs_inv, H_img, W_img).items()})
        else:
            buf["Hs"] = Hs
        if dev.type != "cuda":
            return one_dispatch_chain({k: v.to(dev) for k, v in buf.items()})
        region = regions.get((G, H_img, W_img))
        if region is None:
            region = regions[(G, H_img, W_img)] = CapturedRegion(one_dispatch_chain, buf,
                                                                 device=dev)
        pts, valid = region(buf)
        return pts.clone(), valid.clone()  # the next replay overwrites the outputs

    @torch.inference_mode()
    def ha(images, generator: Generators = None, homographies: Optional[torch.Tensor] = None):
        images = torch.as_tensor(images, dtype=torch.float32)
        if not one_dispatch:  # the graph's prologue copies host images itself
            images = to_device(images, dev)
        squeeze = images.dim() == 2
        if squeeze:
            images = images[None]
            if homographies is not None and homographies.dim() == 3:
                homographies = homographies[None]
        G, H_img, W_img = images.shape
        if homographies is None:
            Hs = sample(G, generator)
        else:
            Hs = torch.as_tensor(homographies, dtype=torch.float32).cpu()
            if Hs.shape != (G, num_h - 1, 3, 3):
                raise ValueError(f"homographies must be [{G}, {num_h - 1}, 3, 3], got "
                                 f"{tuple(Hs.shape)}")
        # identity in slot 0, as the reference sets H[0] = I
        Hs = torch.cat([torch.eye(3).expand(G, 1, 3, 3), Hs], dim=1)
        Hs_inv = inv3(Hs).reshape(-1, 3, 3)
        if one_dispatch:
            pts, valid = run_one_dispatch(images, Hs.reshape(-1, 3, 3), Hs_inv)
            return (pts[0], valid[0]) if squeeze else (pts, valid)
        stack = warp_stage(images, Hs)

        total = torch.zeros(G, H_img, W_img, device=dev)
        counts = torch.zeros_like(total)
        maxs = torch.zeros_like(total)
        n_total = G * num_h
        for s in range(0, n_total, chunk):
            e = min(s + chunk, n_total)  # the last chunk may be short
            segments = [(g, max(g * num_h, s) - s, min((g + 1) * num_h, e) - s)
                        for g in range(s // num_h, (e - 1) // num_h + 1)]
            forward_stage(total, counts, maxs, stack[s:e], Hs_inv[s:e], segments)
        pts, valid = finish_stage(total, counts, maxs)
        return (pts[0], valid[0]) if squeeze else (pts, valid)

    ha.regions = regions
    return ha


def _sub(buf: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``buf`` under ``prefix``, with the prefix cut."""
    return {k[len(prefix):]: v for k, v in buf.items() if k.startswith(prefix)}


def _image_generator(seed: int, position: int) -> torch.Generator:
    """The CPU generator of the image at ``position`` of the export's list.
    Keyed by position, not drawn in sequence: a resumed run must give each
    image the homographies a fresh run would (skipped images draw nothing)."""
    state = np.random.SeedSequence([seed, position]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))


def run_ha_export(
    ha_fn,
    images: Iterable[Tuple[str, np.ndarray]],
    out_dir: Path,
    *,
    seed: int = 0,
    group: int = 1,
    depth: int = 3,
    rank: int = 0,
    world: int = 1,
) -> int:
    """Drive the export: iterate (name, image [H, W]) pairs, skip those whose
    npz exists (a stopped run resumes), write ``<name>.npz`` with
    ``pts [n, 3]`` (x, y, score) for the others; returns how many were
    written.

    ``group`` images go through ``ha_fn`` per call; the last group is padded
    to ``group`` with its last image and the padding is cut from the
    result.  ``depth`` is the software-pipeline depth: a group's points are
    copied to pinned host memory without blocking and written ``depth``
    groups later, so the host never waits for the group it has just queued.

    ``rank`` of ``world`` exports the images at the positions of the list
    congruent to ``rank`` modulo ``world`` and writes only their files, as
    each JAX process writes its rows.  The homographies are keyed by the
    position, so every image gets the points of a one-process run, and
    skipped files do not move any position.
    """
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not one of {world} ranks")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    count = 0

    def group_iter():
        pending: list = []
        for idx, (name, img) in enumerate(images):
            if idx % world != rank or (out_dir / f"{name}.npz").exists():
                continue
            pending.append((name, img, idx))
            if len(pending) >= group:
                yield pending
                pending = []
        if pending:
            yield pending

    def compute(pending):
        n_real = len(pending)
        padded = pending + [pending[-1]] * (group - n_real)
        imgs = torch.from_numpy(np.stack([np.asarray(i, np.float32) for _, i, _ in padded]))
        gens = [_image_generator(seed, i) for _, _, i in padded]
        pts, valid = ha_fn(imgs, generator=gens)
        pts, valid = pts[:n_real], valid[:n_real]
        done = None
        if pts.is_cuda:  # start the copy-back now, wait for it at write time
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (pts, valid)]
            for h, t in zip(host, (pts, valid)):
                h.copy_(t, non_blocking=True)
            pts, valid = host
            done = torch.cuda.Event()
            done.record()
        return [n for n, _, _ in pending], pts, valid, done

    def write_out(names, pts_b, valid_b, done):
        nonlocal count
        if done is not None:
            done.synchronize()
        for name, pts, valid in zip(names, pts_b.numpy(), valid_b.numpy()):
            _write(out_dir / f"{name}.npz", pts, valid)
            count += 1

    inflight: deque = deque()
    for pending in group_iter():
        inflight.append(compute(pending))
        while len(inflight) > depth:
            write_out(*inflight.popleft())
    while inflight:
        write_out(*inflight.popleft())
    return count


def _write(path: Path, pts: np.ndarray, valid: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, pts=pts[valid])
