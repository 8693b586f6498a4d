"""Segmentation metrics (counterpart of the JAX package's ops/metrics.py).

The confusion matrix is counted on the device; only the (C, C) counts go to
the host, where the GFS metric (numpy) reduces them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, num_classes: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Confusion counts cm[gt, pred] over all elements, (C, C) float32.

    pred/gt: integer tensors of one shape; `mask` (same shape, optional)
    leaves out elements such as the padded rows of a final short batch.
    """
    cell = gt.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    weights = (torch.ones(cell.shape, device=cell.device) if mask is None
               else mask.reshape(-1).to(torch.float32))
    # scatter_add, not bincount: bincount sizes its output from a device
    # max, which waits for the device on every call
    counts = torch.zeros(num_classes * num_classes, device=cell.device)
    counts.scatter_add_(0, cell, weights)
    return counts.reshape(num_classes, num_classes)


def iou_from_confusion(cm: np.ndarray, safe: bool = False) -> np.ndarray:
    """Per-class IoU from a confusion matrix cm[gt, pred].

    With safe=False, a never-seen class (zero denominator) raises
    FloatingPointError, matching the reference's ZeroDivisionError from its
    per-point Python loop (runs/eval.py:57). safe=True yields 0 instead.
    """
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    denom = cm.sum(axis=0) + cm.sum(axis=1) - tp
    if safe:
        return np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
    with np.errstate(divide="raise", invalid="raise"):
        return tp / denom


def overall_accuracy_and_miou(cm: np.ndarray,
                              skip_class0_in_miou: bool = True
                              ) -> Tuple[float, float, np.ndarray]:
    """Pre-training metric (reference pretrain/runs/pre_train.py:51-83):
    overall accuracy + mean IoU over classes 1..C-1 (class 0 is the
    background); a class never seen scores 0."""
    cm = np.asarray(cm, dtype=np.float64)
    oa = float(np.trace(cm) / cm.sum())
    iou = iou_from_confusion(cm, safe=True)
    miou = float(np.mean(iou[1:] if skip_class0_in_miou else iou))
    return oa, miou, iou


def gfs_miou(
    cm_learning_order: np.ndarray,
    all_learning_order: Sequence[int],
    novel_class_names: Sequence[int],
    scannet: bool = False,
) -> Tuple[float, float, float, float, np.ndarray]:
    """GFS metric: base/novel/mean/harmonic-mean mIoU.

    Args:
      cm_learning_order: (C, C) confusion counts where ids are LEARNING-order
        ids (base classes first, then novel), as produced during evaluation.
      all_learning_order: all_learning_order[i] = class-NAME id of learning
        id i (reference train.py:341-342).
      novel_class_names: class-name ids of the novel classes.
      scannet: skip class-name id 0 ("unannotated") from all aggregates
        (reference runs/eval.py:79-106).
    Returns:
      (mean_iou, base_iou, novel_iou, hm_iou, per_class_iou_in_name_order)
    """
    order = np.asarray(all_learning_order)
    num_class = len(order)
    # permute learning-order ids -> class-name ids (reference runs/eval.py:41-48)
    perm = np.zeros(num_class, dtype=np.int64)
    perm[np.arange(num_class)] = order
    cm_name = np.zeros_like(cm_learning_order, dtype=np.float64)
    cm_name[perm[:, None], perm[None, :]] = np.asarray(cm_learning_order,
                                                       dtype=np.float64)

    iou = iou_from_confusion(cm_name)
    novel = set(int(c) for c in novel_class_names)

    base_list, novel_list = [], []
    for c in range(num_class):
        if scannet and c == 0:
            continue
        (novel_list if c in novel else base_list).append(iou[c])

    iou_list = iou[1:] if scannet else iou
    mean_iou = float(np.mean(iou_list))
    base_iou = float(np.mean(base_list))
    novel_iou = float(np.mean(novel_list))
    hm = 2.0 * base_iou * novel_iou / (base_iou + novel_iou)
    return mean_iou, base_iou, novel_iou, float(hm), iou_list
