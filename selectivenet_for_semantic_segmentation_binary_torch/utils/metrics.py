"""Confusion-matrix evaluator and scalar segmentation metrics.

Counterpart of the JAX package's ``utils/metrics.py`` (reference
utils/compute_metric.py), a copy (the port imports nothing of the JAX
package) pinned to it by ``tests/test_torch_metrics.py``:

* ``Evaluator`` (:33-119): the same getter names and formulas; selective
  mode counts only pixels with ``selection == 1``. ``add_batch`` takes numpy
  arrays or torch tensors; a tensor batch is counted on its own device by
  ``ops.confusion.confusion_matrix_update`` (fixed shape, no sync), and the
  (C, C) float64 matrix on the host receives it;
* ``get_performance`` (:122-163): accuracy, recall, precision, F1 and the
  ROC AUC of one patch or one stitched slide;
* ``compute_IoU`` / ``compute_mIOU`` (:166-177).

The JAX version takes its AUC from scikit-learn's ``roc_auc_score``.
``roc_auc`` below computes the same curve and the same trapezoid sum, in
the same order, with numpy alone, so the value is scikit-learn's bit for
bit; where scikit-learn raises or declines (one class, an empty or
non-finite input) it is NaN, as the JAX version's ``except`` makes it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.confusion import confusion_matrix_update


def _shape(a) -> tuple:
    """An array's or a tensor's shape; ``np.shape`` would copy a CUDA tensor."""
    return tuple(a.shape) if hasattr(a, "shape") else np.shape(a)


class Evaluator:
    """Streaming confusion-matrix metrics; rows are ground truth (reference
    compute_metric.py:4-84)."""

    def __init__(self, num_class: int, selective: bool = False):
        self.num_class = num_class
        self.selective = selective
        self.confusion_matrix = np.zeros((num_class, num_class), dtype=np.float64)

    # -- accumulation ------------------------------------------------------
    def _generate_matrix(self, label, pred, selection=None) -> np.ndarray:
        label = np.asarray(label)
        pred = np.asarray(pred)
        mask = (label >= 0) & (label < self.num_class)
        if self.selective:
            mask = mask & (np.asarray(selection) == 1)
        flat = self.num_class * label[mask].astype(np.int64) + pred[mask].astype(np.int64)
        count = np.bincount(flat, minlength=self.num_class ** 2)
        return count.reshape(self.num_class, self.num_class)

    def add_batch(self, label, pred, selection=None) -> None:
        assert _shape(label) == _shape(pred)
        if torch.is_tensor(label) or torch.is_tensor(pred):
            device = (label if torch.is_tensor(label) else pred).device
            label, pred = (torch.as_tensor(t, device=device) for t in (label, pred))
            sel = torch.as_tensor(selection, device=device) if self.selective else None
            cm = confusion_matrix_update(label, pred, self.num_class, sel).cpu().numpy()
        else:
            cm = self._generate_matrix(label, pred, selection=selection)
        self.confusion_matrix += cm

    def add_confusion_matrix(self, cm) -> None:
        """Accumulate a (C, C) count matrix computed on the device."""
        self.confusion_matrix += np.asarray(cm, dtype=np.float64)

    def reset(self) -> None:
        self.confusion_matrix = np.zeros((self.num_class, self.num_class), dtype=np.float64)

    # -- getters (names preserved from the reference) -----------------------
    def Confusion_Matrix(self) -> np.ndarray:
        print(self.confusion_matrix)
        return self.confusion_matrix

    def get_Pixel_Accuracy(self) -> float:
        cm = self.confusion_matrix
        return float(np.diag(cm).sum() / cm.sum())

    def get_Pixel_Accuracy_Class(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(self.confusion_matrix) / self.confusion_matrix.sum(axis=1)
        return float(np.nanmean(acc))

    def get_Pixel_Accuracy_Class_S(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(self.confusion_matrix) / self.confusion_matrix.sum(axis=1)

    def get_Precision(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(self.confusion_matrix) / self.confusion_matrix.sum(axis=0)

    def get_Recall(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(self.confusion_matrix) / self.confusion_matrix.sum(axis=1)

    def get_F1_Score(self, prec, recall) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return 2 * (prec * recall) / (prec + recall)

    def _iou(self) -> np.ndarray:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))

    def get_mIoU(self) -> float:
        return float(np.nanmean(self._iou()))

    def get_IoU_Class(self) -> np.ndarray:
        return self._iou()

    def get_FWIoU(self) -> float:
        cm = self.confusion_matrix
        freq = cm.sum(axis=1) / cm.sum()
        iu = self._iou()
        return float((freq[freq > 0] * iu[freq > 0]).sum())

    def get_Dice_Score(self) -> np.ndarray:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            return 2 * np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0))


def roc_auc(label, score) -> float:
    """Binary ROC AUC as scikit-learn's ``roc_auc_score`` computes it: scores
    sorted descending (stable), one ROC point at the end of each run of tied
    scores, collinear points dropped, (0, 0) prepended, and the trapezoid
    sum over the curve. NaN where scikit-learn has no value: labels other
    than a {0, 1} or {-1, 1} pair, an empty or a non-finite input."""
    label = np.asarray(label).ravel()
    score = np.asarray(score).ravel()
    if label.size == 0 or label.size != score.size or not np.all(np.isfinite(score)):
        return np.nan
    classes = np.unique(label)
    if not (np.array_equal(classes, [0, 1]) or np.array_equal(classes, [-1, 1])):
        return np.nan
    order = np.argsort(score, kind="stable")[::-1]
    positive = (label[order] == 1).astype(np.float64)
    ends = np.r_[np.nonzero(np.diff(score[order]))[0], label.size - 1]
    tps = np.cumsum(positive, dtype=np.float64)[ends]
    fps = 1 + ends.astype(np.float64) - tps
    if fps.shape[0] > 2:
        corner = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[corner], tps[corner]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0, dtype=np.float64))


def get_performance(label, output, predict, isprint: bool = False):
    """Pixel-level accuracy/recall/precision/F1/AUC of one patch or WSI
    (reference compute_metric.py:93-148).

    Args:
        label: ground truth mask in {0, 1}.
        output: continuous scores (for the ROC AUC).
        predict: binarized prediction in {0, 1}.
    Returns:
        (accuracy, recall, precision, f1_score, auc_score); undefined values NaN.
    """
    label = np.asarray(label).flatten()
    output = np.asarray(output).flatten()
    predict = np.asarray(predict).flatten()

    c1 = int((label == 1).sum())
    c0 = int((label == 0).sum())
    tp = int(((label == 1) & (predict == 1)).sum())
    tn = int(((label == 0) & (predict == 0)).sum())
    p1 = int((predict == 1).sum())

    accuracy = (tp + tn) / (c1 + c0)

    recall = tp / c1 if c1 != 0 else np.nan
    precision = tp / p1 if p1 != 0 else np.nan
    f1_score = np.nan
    if not np.isnan(recall) and not np.isnan(precision) and (recall + precision) != 0:
        f1_score = 2 * recall * precision / (recall + precision)

    auc_score = roc_auc(label, output)

    if isprint:
        print(
            f"accuracy: {accuracy:.3f} | recall: {recall:.3f} | precision: {precision:.3f}"
            f" | f1 score: {f1_score:.3f} | AUC score: {auc_score:.3f}"
        )
    return accuracy, recall, precision, f1_score, auc_score


def compute_IoU(label, pred, index, EPS: float = 1e-6) -> float:
    """Single-class IoU with epsilon smoothing (compute_metric.py:150-161)."""
    tl = (np.asarray(label) == index)
    tp = (np.asarray(pred) == index)
    intersect = float((tl & tp).sum())
    union = float((tl | tp).sum())
    return (intersect + EPS) / (union + EPS)


def compute_mIOU(label, pred, n_class: int = 2) -> float:
    """Mean IoU over classes (compute_metric.py:163-168)."""
    return sum(compute_IoU(label, pred, i) for i in range(n_class)) / float(n_class)
