"""Confusion-matrix counting on the batch's device.

Counterpart of the JAX package's ``ops/confusion.py:27-99``. Pixels count
iff ``0 <= label < num_class`` (so ``PAD_LABEL`` padding drops out) and, in
selective mode, ``selection == 1``; rows are ground truth, columns
predictions. A prediction outside ``[0, num_class)`` counts nowhere, as its
one-hot row is zero in the JAX version.

The JAX version's one-hot matrix product exists only to keep the count on
the TPU's matrix unit. Here the count has a fixed shape too, so that it
never waits for the host: every pixel gets a cell ``num_class * label +
pred`` where it counts and a spare cell where it does not, and each of the
``num_class**2`` cells is one comparison and one sum over the batch.
(Boolean indexing or ``torch.bincount`` would size their output from the
data, a device-to-host sync on every batch; an ``index_add_`` of ones
serialises on the atomics of a handful of cells, ~6 ms a batch of
128x256x256 on an H100.)
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
    label = label.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (label >= 0) & (label < num_class) & (pred >= 0) & (pred < num_class)
    if selection is not None:
        valid = valid & (selection.reshape(-1).long() == 1)
    cells = num_class ** 2
    index = torch.where(valid, num_class * label + pred, cells)
    counts = [(index == c).sum() for c in range(cells)]
    return torch.stack(counts).reshape(num_class, num_class)
