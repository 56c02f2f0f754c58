"""Semantic-segmentation metrics: pixel accuracy and mean IoU (port of
``ssp/evaluations/semantic.py``; host numpy, the same arithmetic).

The reference evaluates its semantic head only indirectly (through
Semantic_ORB_SLAM2 trajectory error, README.md:26-29) and reports
pixel-level quality in the paper; this module provides the standard
confusion-matrix metrics for the ``sem`` head so segmentation quality
is measurable inside this framework.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(
    pred: np.ndarray, target: np.ndarray, n_classes: int, ignore_class: int = 133
) -> np.ndarray:
    """[n_classes, n_classes] counts over all non-ignored pixels;
    rows = target class, cols = predicted class."""
    pred = np.asarray(pred).reshape(-1)
    target = np.asarray(target).reshape(-1)
    # ignore the declared ignore class AND any out-of-range target id
    # (e.g. a 255 void label under a non-contiguous convention) —
    # clipping only pred while letting a wild target index through
    # would corrupt or crash the bincount reshape
    keep = (target != ignore_class) & (target >= 0) & (target < n_classes)
    pred, target = pred[keep], target[keep]
    idx = target.astype(np.int64) * n_classes + np.clip(pred, 0, n_classes - 1)
    return np.bincount(idx, minlength=n_classes * n_classes).reshape(
        n_classes, n_classes
    )


def semantic_metrics(cm: np.ndarray) -> Dict[str, float]:
    """Pixel accuracy, mean class accuracy, and mean IoU over the
    classes that appear in the targets (absent classes don't dilute the
    mean — the usual convention)."""
    cm = np.asarray(cm, np.float64)
    total = cm.sum()
    tp = np.diag(cm)
    target_count = cm.sum(axis=1)
    pred_count = cm.sum(axis=0)
    present = target_count > 0
    union = target_count + pred_count - tp
    iou = np.where(union > 0, tp / np.maximum(union, 1), 0.0)
    acc = np.where(present, tp / np.maximum(target_count, 1), 0.0)
    return {
        "pixel_accuracy": float(tp.sum() / max(total, 1)),
        "mean_class_accuracy": float(acc[present].mean()) if present.any() else 0.0,
        "mean_iou": float(iou[present].mean()) if present.any() else 0.0,
    }


def evaluate_semantic(
    logits_or_pred: np.ndarray,
    target: np.ndarray,
    n_classes: int = 133,
    ignore_class: int = 133,
) -> Dict[str, float]:
    """End-to-end: ``logits_or_pred`` is either class logits
    [..., n_classes] (argmax'd here) or an integer class map."""
    arr = np.asarray(logits_or_pred)
    pred = arr.argmax(-1) if arr.ndim == np.asarray(target).ndim + 1 else arr
    cm = confusion_matrix(pred, target, n_classes, ignore_class)
    return semantic_metrics(cm)
