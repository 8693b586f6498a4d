"""Segmentation metrics (counterpart of the JAX package's ops/metrics.py).

The confusion matrix is counted on the device; only the (C, C) counts go to
the host, where the GFS metric (numpy) reduces them. The few-shot metric of
the baselines accumulates each episode's (n_way+1)^2 counts into the global
matrix on the device or on the host (`fewshot_accumulate`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

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


def intersection_and_union(pred: torch.Tensor, gt: torch.Tensor,
                           num_classes: int, ignore_index: int = 255
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Histogram IoU counts (reference util/util.py:64-104): per-class
    intersection, union and target-area counts, (num_classes,) int64 each.
    Elements whose gt is `ignore_index` count nowhere."""
    pred = pred.reshape(-1).long()
    gt = gt.reshape(-1).long()
    valid = gt != ignore_index
    overflow = torch.full_like(gt, num_classes)
    pred = torch.where(valid, pred, overflow)
    gt = torch.where(valid, gt, overflow)

    def count(x):
        hist = torch.zeros(num_classes + 1, dtype=torch.long,
                           device=x.device)
        hist.scatter_add_(0, x, torch.ones_like(x))
        return hist[:num_classes]

    area_inter = count(torch.where(pred == gt, pred, overflow))
    area_pred, area_gt = count(pred), count(gt)
    return area_inter, area_pred + area_gt - area_inter, area_gt


def fewshot_accumulate(cm_global: Union[np.ndarray, torch.Tensor],
                       cm_episode: Union[np.ndarray, torch.Tensor],
                       label2class: Sequence[int],
                       test_classes: Sequence[int]) -> None:
    """Add one episode's (n_way+1, n_way+1) confusion counts into the
    global (len(test_classes)+1, ...) matrix, episode label i + 1 at
    test_classes.index(label2class[i]) + 1 and the background at 0
    (reference pretrain/runs/eval.py:35-60). A tensor `cm_global` is added
    to on its device, without a host sync; an array on the host."""
    classes = [int(c) for c in test_classes]
    perm = np.zeros(len(label2class) + 1, dtype=np.int64)
    for i, cls in enumerate(label2class):
        perm[i + 1] = classes.index(int(cls)) + 1
    if isinstance(cm_global, torch.Tensor):
        p = torch.from_numpy(perm).to(cm_global.device)
        cm_global[p[:, None], p[None, :]] += cm_episode.to(cm_global.dtype)
        return
    cm_global[perm[:, None], perm[None, :]] += np.asarray(cm_episode,
                                                          np.float64)


def fewshot_miou(cm_global: np.ndarray) -> Tuple[float, np.ndarray]:
    """The classic few-shot metric: per-class IoU, and its mean over the
    foreground classes only (reference pretrain/runs/eval.py:62-70)."""
    iou = iou_from_confusion(cm_global, safe=True)
    return float(np.mean(iou[1:])), iou
