"""Mean intersection-over-union for semantic segmentation.

A copy of ``em_adapt_tpu/eval/miou.py`` in PyTorch: the confusion matrix
of one batch is one ``bincount`` on the predictions' device, and the
streaming total stays there in int64 (no int32 window to flush), so a
batch adds no host sync. IoU_c = TP / (TP + FP + FN), averaged over the
classes that appear in the ground truth or the prediction.
"""

from __future__ import annotations

import numpy as np
import torch

from em_adapt_torch.data.voc import VOC_CLASS_NAMES  # noqa: F401  (re-exported)


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[C, C] int64 counts; rows = ground truth, cols = prediction. Pixels
    with gt outside [0, C) (the 255 void label) are ignored, and so are
    out-of-range predictions (no index wraps into another cell)."""
    pred = pred.reshape(-1).long()
    gt = gt.reshape(-1).to(pred.device).long()
    valid = (gt >= 0) & (gt < num_classes) & (pred >= 0) & (pred < num_classes)
    idx = torch.where(valid, gt * num_classes + pred, num_classes * num_classes)
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


def miou_from_confusion(cm) -> tuple[float, np.ndarray]:
    """(mean IoU, per-class IoU). Classes absent from both gt and pred get
    NaN and are excluded from the mean (standard VOC practice)."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.where(denom > 0, tp / denom, np.nan)
    return float(np.nanmean(iou)), iou


class ConfusionAccumulator:
    """Streaming confusion matrix over batches, int64 on the device of the
    first predictions it is given, plus an int64 host part
    (:meth:`update_host`)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self._total: torch.Tensor | None = None
        self._host = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: torch.Tensor, gt: torch.Tensor) -> None:
        cm = confusion_matrix(pred, gt, self.num_classes)
        self._total = cm if self._total is None else self._total + cm

    def update_host(self, pred: np.ndarray, gt: np.ndarray) -> None:
        """Add host arrays of any shape (the VOC protocol's per-image
        original sizes) with one int64 ``np.bincount``, the semantics of
        :func:`confusion_matrix`: gt outside [0, C) is void, and so is an
        out-of-range prediction. Summed into the total ``update`` feeds."""
        pred = np.asarray(pred).reshape(-1).astype(np.int64)
        gt = np.asarray(gt).reshape(-1).astype(np.int64)
        c = self.num_classes
        valid = (gt >= 0) & (gt < c) & (pred >= 0) & (pred < c)
        self._host += np.bincount(gt[valid] * c + pred[valid], minlength=c * c).reshape(c, c)

    def matrix(self) -> np.ndarray:
        """The accumulated [C, C] int64 confusion matrix (host copy)."""
        if self._total is None:
            return self._host.copy()
        return self._total.cpu().numpy() + self._host

    def result(self) -> tuple[float, np.ndarray]:
        return miou_from_confusion(self.matrix())
