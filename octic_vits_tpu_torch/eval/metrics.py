"""Evaluation metrics on the host (counterpart of octic_vits_tpu/eval/metrics.py,
reference: dinov2/eval/metrics.py:20-113). Numpy, as in JAX; tensors are
copied to the host first. `as_tensor` is the suites' rule for where an
array input goes: to the card."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from octic_vits_tpu_torch.models.registry import resolve_device


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device, bf16 widened to f32) or array-like as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def as_tensor(x, device=None) -> torch.Tensor:
    """`x` where it lives if it is a tensor, else on `device` (the card when
    none is named; see ``resolve_device``): where every suite computes."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def topk_accuracy(logits, labels, ks: Sequence[int] = (1, 5)) -> Dict[str, float]:
    logits = to_numpy(logits)
    labels = to_numpy(labels)
    order = np.argsort(-logits, axis=-1)
    out = {}
    for k in ks:
        hit = (order[:, :k] == labels[:, None]).any(-1)
        out[f"top{k}"] = float(hit.mean())
    return out


def real_labels_accuracy(logits, real_labels: Sequence[Sequence[int]], k: int = 1) -> float:
    """ImageNet-ReaL accuracy: a prediction is correct if it is in the
    sample's set of re-assessed labels; samples with empty label sets are
    skipped (reference: dinov2/eval/metrics.py ImageNetReaLAccuracy)."""
    order = np.argsort(-to_numpy(logits), axis=-1)[:, :k]
    hits, total = 0, 0
    for preds, labels in zip(order, real_labels):
        if not len(labels):
            continue
        total += 1
        if any(p in labels for p in preds):
            hits += 1
    return hits / max(total, 1)


def confusion_matrix(pred: np.ndarray, target: np.ndarray, num_classes: int,
                     ignore_index: int = 255) -> np.ndarray:
    pred, target = to_numpy(pred), to_numpy(target)
    valid = target != ignore_index
    p = pred[valid].astype(np.int64)
    t = target[valid].astype(np.int64)
    cm = np.bincount(t * num_classes + p, minlength=num_classes**2)
    return cm.reshape(num_classes, num_classes)


def miou_from_confusion(cm: np.ndarray, exclude: Sequence[int] = ()) -> Dict[str, float]:
    """mIoU + per-pixel acc (segmentation probing;
    reference: dinov2/eval/segmentation/eval_segmentation.py:50-67).
    `exclude` removes ignore-label classes (e.g. ADE20K raw label 0) from
    the macro average even when a probe predicts them."""
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), np.nan)
    for c in exclude:
        if 0 <= c < len(iou):
            iou[c] = np.nan
    acc = inter.sum() / max(cm.sum(), 1)
    return {"miou": float(np.nanmean(iou)), "acc": float(acc)}
