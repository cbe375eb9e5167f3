"""Confusion-matrix accumulation and semantic-segmentation metrics
(catseg_tpu/evaluation/miou.py).

The (K+1, K+1) confusion matrix is indexed [pred, gt]; its last row and
column are the void class, where every ground-truth pixel at the ignore label
goes.  Each update is one ``torch.bincount`` on the predictions' device into
an int64 matrix kept there, so predictions never leave the card; the metrics
are numpy on the host, as in the JAX package.  With ``clamp_background``
(the VOC-b protocol) every prediction above class 20 counts as background
class 20.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ConfusionAccumulator", "confusion_update", "gzero_metrics", "semseg_metrics"]


def confusion_update(cm: torch.Tensor, pred: torch.Tensor, gt: torch.Tensor, ignore_mask: torch.Tensor,
                     num_classes: int, clamp_background: bool = False) -> torch.Tensor:
    """Add one batch of (pred, gt) pairs into ``cm`` (K+1, K+1) int64, in place.

    pred, gt: integer tensors of one shape on cm's device; ignore_mask: bool,
    True where gt is void (or padding)."""
    K = num_classes
    pred = pred.long()
    if clamp_background:
        pred = pred.clamp_max(20)
    gt = torch.where(ignore_mask, K, gt.long().clamp(0, K - 1))
    idx = (pred * (K + 1) + gt).reshape(-1)
    cm += torch.bincount(idx, minlength=(K + 1) * (K + 1)).reshape(K + 1, K + 1)
    return cm


class ConfusionAccumulator:
    """Running confusion matrix on ``device`` (the card unless told otherwise)."""

    def __init__(self, num_classes: int, ignore_label: int, clamp_background: bool = False,
                 device="cuda"):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.clamp_background = clamp_background
        self.device = torch.device(device)
        self.cm = torch.zeros((num_classes + 1, num_classes + 1), dtype=torch.int64, device=self.device)

    def update(self, pred, gt) -> None:
        pred = torch.as_tensor(pred, device=self.device)
        gt = torch.as_tensor(gt, device=self.device)
        confusion_update(self.cm, pred, gt, gt == self.ignore_label, self.num_classes,
                         self.clamp_background)

    def matrix(self) -> np.ndarray:
        return self.cm.cpu().numpy()

    def metrics(self) -> dict:
        return semseg_metrics(self.matrix())


def semseg_metrics(conf: np.ndarray) -> dict:
    """detectron2-identical mIoU/fwIoU/mACC/pACC + per-class IoU/ACC."""
    conf = np.asarray(conf, dtype=np.float64)
    K = conf.shape[0] - 1
    acc = np.full(K, np.nan)
    iou = np.full(K, np.nan)
    tp = conf.diagonal()[:-1]
    pos_gt = conf[:-1, :-1].sum(axis=0)
    class_weights = pos_gt / max(pos_gt.sum(), 1)
    pos_pred = conf[:-1, :-1].sum(axis=1)
    acc_valid = pos_gt > 0
    acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
    union = pos_gt + pos_pred - tp
    iou_valid = np.logical_and(acc_valid, union > 0)
    iou[iou_valid] = tp[iou_valid] / union[iou_valid]
    macc = np.sum(acc[acc_valid]) / max(acc_valid.sum(), 1)
    miou = np.sum(iou[iou_valid]) / max(iou_valid.sum(), 1)
    fiou = np.sum(iou[iou_valid] * class_weights[iou_valid])
    pacc = tp.sum() / max(pos_gt.sum(), 1)
    return {
        "mIoU": 100 * miou,
        "fwIoU": 100 * fiou,
        "mACC": 100 * macc,
        "pACC": 100 * pacc,
        "IoU": 100 * iou,
        "ACC": 100 * acc,
    }


def gzero_metrics(conf: np.ndarray, seen: list[int], unseen: list[int]) -> dict:
    """Generalized zero-shot split metrics: per-class IoU partitioned into
    seen/unseen + their harmonic mean."""
    m = semseg_metrics(conf)
    iou = m["IoU"]
    seen_iou = np.nanmean(iou[list(seen)])
    unseen_iou = np.nanmean(iou[list(unseen)])
    harmonic = 2 * seen_iou * unseen_iou / max(seen_iou + unseen_iou, 1e-12)
    m.update({"mIoU_seen": seen_iou, "mIoU_unseen": unseen_iou, "hIoU": harmonic})
    return m
