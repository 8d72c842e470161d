"""Confusion-matrix counting on the batch's device.

Counterpart of the JAX package's ``ops/confusion.py:27-99``. Pixels count
iff ``0 <= label < num_class`` (so ``PAD_LABEL`` padding drops out) and, in
selective mode, ``selection == 1``; rows are ground truth, columns
predictions. The JAX version's one-hot matrix product exists only to keep
the count on the TPU's matrix unit; here it is a plain ``torch.bincount``.
"""

from __future__ import annotations

from typing import Optional

import torch

# Label value that pads partial batches up to the static batch size; any
# value outside [0, num_class) works because of the validity mask.
PAD_LABEL = 255


def confusion_matrix_update(label: torch.Tensor, pred: torch.Tensor,
                            num_class: int,
                            selection: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (num_class, num_class) int64 confusion counts of one batch."""
    label = label.long()
    pred = pred.long()
    valid = (label >= 0) & (label < num_class)
    if selection is not None:
        valid = valid & (selection.long() == 1)
    flat = num_class * label[valid] + pred[valid]
    return torch.bincount(flat, minlength=num_class ** 2).reshape(num_class, num_class)
