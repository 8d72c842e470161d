"""Confusion-matrix evaluator (numpy, host side).

Counterpart of the JAX package's ``utils/metrics.py:33-119`` (reference
utils/compute_metric.py:4-84): the same getter names and formulas, without
``add_batch``: the port's eval step counts on the device and hands over
finished matrices. Copied until the JAX package's
``utils/metrics.py`` imports without JAX (ROADMAP A0).
"""

from __future__ import annotations

import numpy as np


class Evaluator:
    """Streaming confusion-matrix metrics; rows are ground truth."""

    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class, num_class), dtype=np.float64)

    def add_confusion_matrix(self, cm) -> None:
        """Accumulate a (C, C) count matrix computed on the device."""
        self.confusion_matrix += np.asarray(cm, dtype=np.float64)

    def get_Pixel_Accuracy(self) -> float:
        cm = self.confusion_matrix
        return float(np.diag(cm).sum() / cm.sum())

    def get_Pixel_Accuracy_Class(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(self.confusion_matrix) / self.confusion_matrix.sum(axis=1)
        return float(np.nanmean(acc))

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
