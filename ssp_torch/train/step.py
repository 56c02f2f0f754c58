"""The training and validation step (port of ``ssp/train/step.py``;
reference ``train_val_sample``, ``Train_model_heatmap_all.py:195-572``).

Two forwards, the image's then the warped image's, with the BatchNorm
statistics chained (the second forward's running averages start from the
first's, as the JAX step threads ``batch_stats``); the detector BCE on
both, the sparse or the dense descriptor loss across the pair, the semantic
CE on both (fused: the 1/8-resolution logits, ``semantic_loss_coarse``), and
the Kendall combination or the plain sum.  :func:`train_step` makes one backward and one
Adam update; :func:`accum_train_step` splits the batch into micro-batches,
sums their gradients and makes one update.  Metrics stay on the device as
0-d tensors: reading them is the caller's choice of when to wait for the
card.

In a process group of W > 1 ranks (``ssp_torch.parallel``) each rank holds
its rows of the global batch and the step is the global batch's, as the JAX
step is over its data mesh: the losses' normalisers (the batch size, the
valid cells, the labelled pixels) are the global batch's, summed over the
ranks once per forward pair (:func:`global_totals`), so each rank's loss is
its additive share of the global loss; BatchNorm takes the global moments
(``ssp_torch.models.superpoint.BatchNorm``); after the backward the
gradients of the parameters and of the ηs, which live outside the module,
are summed over the ranks together with the metrics (:func:`reduce_step`),
so every rank makes the same update and reports the global metrics.  A mean
of per-rank losses, as a gradient mean over replicas gives, would be another
loss wherever a denominator depends on the data.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ssp_torch.core.grid import labels_to_cells, space_to_depth
from ssp_torch.losses import (descriptor_loss_dense, detector_loss, multi_task_loss,
                              semantic_loss, semantic_loss_coarse)
from ssp_torch.losses.descriptor_sparse import SparseDraws, descriptor_loss_sparse
from ssp_torch.parallel import mesh
from ssp_torch.train.state import TrainState


def cell_valid_mask(mask_2d: torch.Tensor) -> torch.Tensor:
    """Pixel mask [B, H, W] → cell mask [B, Hc, Wc]: a cell is valid iff all
    its 64 pixels are (reference ``getMasks``)."""
    return space_to_depth(mask_2d[..., None]).prod(dim=-1)


def global_totals(**local: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The sums over the ranks of these 0-d local normalisers, detached, in
    one all-reduce (at the first one's type)."""
    names = list(local)
    dt = local[names[0]].dtype
    sums = mesh.global_sum(torch.stack([local[k].to(dt) for k in names]))
    return dict(zip(names, sums))


def reduce_step(state: TrainState, metrics: Dict[str, torch.Tensor], *,
                grads: bool = True) -> Dict[str, torch.Tensor]:
    """On W > 1 ranks: every gradient of ``state`` (the module's and the
    ηs'; not with ``grads=False``, in evaluation) and every additive metric
    (all but the ηs) summed over the ranks, in place, in one all-reduce per
    type; returns the global metrics."""
    if mesh.world() == 1:
        return metrics
    shared = [k for k in metrics if not k.startswith("eta_")]
    vec = torch.stack([metrics[k].to(metrics[shared[0]].dtype) for k in shared])
    params = [*state.model.parameters(), state.etas] if grads else []
    mesh.reduce_sum_([p.grad for p in params if p.grad is not None] + [vec])
    return dict(metrics, **dict(zip(shared, vec)))


def compute_losses(
    model: torch.nn.Module,
    etas: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    *,
    semantic: bool,
    warped_pair: bool,
    det_loss_type: str = "softmax",
    desc_loss: str = "sparse",
    desc_params: Optional[Dict[str, Any]] = None,
    lambda_loss: float = 1.0,
    multi_task: bool = True,
    ignore_class: int = 133,
    sem_fused: bool = True,
    generator: Optional[torch.Generator] = None,
    desc_draws: Optional[SparseDraws] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of ``batch`` in the module's current mode (``train()``:
    batch statistics, running averages updated; ``eval()``: running ones).
    ``desc_loss`` is ``"sparse"`` (its draws are ``desc_draws`` or come from
    ``generator``) or ``"dense"``; ``desc_params`` are that loss's keywords."""
    if desc_loss not in ("sparse", "dense"):
        raise ValueError(f"desc_loss {desc_loss!r}: 'sparse' or 'dense'")
    kw = {"upsample_sem": False} if (semantic and sem_fused) else {}
    cmask1 = cell_valid_mask(batch["valid_mask"])
    cmask2 = cell_valid_mask(batch["warped_valid_mask"]) if warped_pair else None
    tot: Dict[str, Optional[torch.Tensor]] = dict.fromkeys(
        ("batch", "cells", "sem", "cells_warp", "sem_warp"))
    if mesh.world() > 1:
        local = {"batch": torch.full((), cmask1.shape[0], dtype=cmask1.dtype,
                                     device=cmask1.device), "cells": cmask1.sum()}
        if semantic:
            local["sem"] = (batch["sem"] != ignore_class).sum()
        if warped_pair:
            local["cells_warp"] = cmask2.sum()
            if semantic:
                local["sem_warp"] = (batch["warped_sem"] != ignore_class).sum()
        tot.update(global_totals(**local))

    def sem_ce(out, labels, total):
        if sem_fused:
            return semantic_loss_coarse(out["sem_coarse"], labels, ignore_class,
                                        valid_total=total)
        return semantic_loss(out["sem"], labels, ignore_class, valid_total=total)

    out1 = model(batch["image"], **kw)
    loss_det = detector_loss(out1["semi"], labels_to_cells(batch["labels_2d"]), cmask1,
                             det_loss_type, mask_total=tot["cells"], batch_total=tot["batch"])
    zero = torch.zeros((), device=loss_det.device)
    loss_sem = sem_ce(out1, batch["sem"], tot["sem"]) if semantic else zero
    loss_det_warp = loss_sem_warp = loss_desc = pos_term = neg_term = zero

    if warped_pair:
        out2 = model(batch["warped_image"], **kw)
        loss_det_warp = detector_loss(out2["semi"], labels_to_cells(batch["warped_labels_2d"]),
                                      cmask2, det_loss_type, mask_total=tot["cells_warp"],
                                      batch_total=tot["batch"])
        if semantic:
            loss_sem_warp = sem_ce(out2, batch["warped_sem"], tot["sem_warp"])
        if lambda_loss > 0 and desc_loss == "dense":
            loss_desc, _, pos_term, neg_term = descriptor_loss_dense(
                out1["desc"], out2["desc"], batch["H_pair"], cmask2, **(desc_params or {}),
                valid_total=tot["cells_warp"], batch_total=tot["batch"])
        elif lambda_loss > 0:
            loss_desc, _, pos_term, neg_term = descriptor_loss_sparse(
                out1["desc"], out2["desc"], batch["H_pair"], desc_draws, generator=generator,
                batch_total=tot["batch"], **(desc_params or {}))

    if multi_task:
        loss = multi_task_loss(etas, loss_det + loss_det_warp, pos_term, neg_term,
                               (loss_sem + loss_sem_warp) if semantic else None,
                               eta_share=None if tot["batch"] is None else 1.0 / mesh.world())
    else:
        loss = loss_det + loss_det_warp + loss_sem + loss_sem_warp
        if lambda_loss > 0:
            loss = loss + lambda_loss * loss_desc

    e = etas.detach().clone()  # the ηs before the update, which changes them in place
    metrics = {
        "loss": loss.detach(),
        "loss_det": loss_det.detach(),
        "loss_det_warp": loss_det_warp.detach(),
        "loss_desc": loss_desc.detach(),
        "loss_sem": loss_sem.detach(),
        "loss_sem_warp": loss_sem_warp.detach(),
        "positive_dist": pos_term.detach(),
        "negative_dist": neg_term.detach(),
        "eta_det": e[0],
        "eta_desc": e[1],
        "eta_sem": e[2],
    }
    return loss, metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], **kwargs) -> Dict[str, torch.Tensor]:
    """One update: the losses in training mode, one backward, one Adam step
    at the schedule's lr, the step count advanced.  ``kwargs`` are
    :func:`compute_losses`'s.  The metrics' ηs are those before the update."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = compute_losses(state.model, state.etas, batch, **kwargs)
    loss.backward()
    metrics = reduce_step(state, metrics)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics


def accum_train_step(state: TrainState, batch: Dict[str, torch.Tensor], r: int,
                     **kwargs) -> Dict[str, torch.Tensor]:
    """One update from ``r`` micro-batches (port of ``make_accum_train_step``;
    reference ``Train_model_heatmap_all.py:406-413``): the global batch of
    r·b splits into ``r`` consecutive micro-batches of b; each takes its own
    training-mode forward (the BatchNorm statistics chain through them) and
    its own backward into the same ``.grad``, so the gradients of the
    parameters and ηs are *summed*, each micro-batch's losses normalised
    over b; then one Adam step and one schedule step.  The sparse loss draws
    per micro-batch from ``generator``.  The metrics are the mean over the
    micro-batches."""
    n = batch["image"].shape[0]
    if n % r:
        raise ValueError(f"a batch of {n} does not split into {r} micro-batches")
    b = n // r
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    per_micro = []
    for i in range(r):
        micro = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        loss, metrics = compute_losses(state.model, state.etas, micro, **kwargs)
        loss.backward()
        per_micro.append(metrics)
    metrics = reduce_step(state, {k: torch.stack([m[k] for m in per_micro]).mean()
                                  for k in per_micro[0]})
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics


def eval_step(state: TrainState, batch: Dict[str, torch.Tensor], **kwargs) -> Dict[str, torch.Tensor]:
    """The losses in evaluation mode (running BatchNorm statistics), no
    gradient; the module's mode is restored after."""
    was_training = state.model.training
    state.model.eval()
    try:
        with torch.no_grad():
            _, metrics = compute_losses(state.model, state.etas, batch, **kwargs)
    finally:
        state.model.train(was_training)
    return reduce_step(state, metrics, grads=False)
