"""Semantic-head evaluation of a Semantic SuperPoint checkpoint (port of
``scripts/eval_wsem_semantic.py``).

Runs the 133-class ``sem`` head over the val split of a COCO tree through
the ``Coco_sem`` reader (PNG raw panoptic ids → the 133-class table),
takes the argmax per pixel and reports pixel accuracy, mean class accuracy
and mean IoU (``ssp_torch.evaluations.semantic``) over the confusion
matrix, with the JAX tool's JSON keys.

Usage::

  python -m ssp_torch.cli.eval_semantic CKPT [--root datasets/COCO240]
      [--sem-labels datasets/COCO240/annotations] [--batch 8] [--resize 240 320]
      [--out FILE] [--cm FILE.npy] [--device cpu]

``CKPT`` is an ``.npz`` of weights or a reference ``.pth.tar`` checkpoint.
The forward runs on ``--device`` (the card unless ``cpu``): the folded bf16
forward of the exports (``best_apply_fn``), as the JAX tool runs its flax
module at flax's default bf16.  ``--cm`` also saves the confusion matrix.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ssp_torch.data.coco import CocoSemDataset
from ssp_torch.data.coco_labels import IGNORE_CLASS, N_CLASSES
from ssp_torch.evaluations.semantic import confusion_matrix, semantic_metrics


def evaluate(ckpt, root, sem_labels, *, batch: int = 8, resize=(240, 320),
             device="cuda") -> Tuple[Dict, np.ndarray]:
    """(metrics, confusion matrix [133, 133], rows the target class) of the
    weights at ``ckpt`` over the val split under ``root``."""
    from ssp_torch._device import resolve_device
    from ssp_torch.models.fast_infer import best_apply_fn
    from ssp_torch.models.weights import load_weights

    dev = resolve_device(device)
    h, w = resize
    ds = CocoSemDataset(task="val", root=root, sem_labels=sem_labels,
                        preprocessing={"resize": [h, w]})
    n = len(ds)
    if n == 0:
        raise FileNotFoundError(f"empty val split under {root}")
    model = load_weights(ckpt, "SuperPointNet_gauss2_ssmall", {"n_classes": N_CLASSES},
                         device=dev)
    apply = best_apply_fn(model, input_hw=(h, w), device=dev)

    cm = np.zeros((N_CLASSES, N_CLASSES), np.int64)
    t0 = time.perf_counter()
    # every index once: the last batch is shorter, not padded from the start
    for start in range(0, n, batch):
        samples = [ds[i] for i in range(start, min(start + batch, n))]
        images = torch.from_numpy(np.stack([s["image"] for s in samples]).astype(np.float32))
        with torch.inference_mode():
            pred = apply(images.to(dev)[..., None])["sem"].argmax(-1).cpu().numpy()
        cm += confusion_matrix(pred, np.stack([s["sem"] for s in samples]), N_CLASSES,
                               IGNORE_CLASS)
    dt = time.perf_counter() - t0

    m = semantic_metrics(cm)
    # the stand-in corpus's labels are 134 gray bins (scripts/make_coco_sem_labels.py),
    # so accuracy within ±k adjacent bins (train ids are bin-ordered) says whether
    # the head learned the appearance → class mapping to near-bin resolution
    idx = np.abs(np.arange(N_CLASSES)[:, None] - np.arange(N_CLASSES)[None, :])
    tot = max(cm.sum(), 1)
    for k in (1, 4):
        m[f"accuracy_within_{k}_bins"] = float(cm[idx <= k].sum() / tot)
    m["images"] = n
    m["img_per_s"] = round(n / dt, 2)
    m["ckpt"] = str(ckpt)
    return m, cm


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", help="weights: .npz or a reference .pth.tar")
    ap.add_argument("--root", default="datasets/COCO240")
    ap.add_argument("--sem-labels", default="datasets/COCO240/annotations")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--resize", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--out", default=None, help="metrics json path")
    ap.add_argument("--cm", default=None, help="confusion matrix .npy path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    m, cm = evaluate(args.ckpt, args.root, args.sem_labels, batch=args.batch,
                     resize=tuple(args.resize), device=args.device)
    print(json.dumps(m))
    if args.out:
        Path(args.out).write_text(json.dumps(m, indent=1) + "\n")
    if args.cm:
        np.save(args.cm, cm)
    return m


if __name__ == "__main__":
    main()
