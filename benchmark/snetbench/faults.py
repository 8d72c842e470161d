"""Faults planted underneath a training cell's timed path, for the readings
``controls.py`` takes on the chip: ``planted(name)`` runs the program with
the fault named.

* ``no_exchange``: the gradient mean over the fleet's ranks
  (``train_lib.mean_gradients``) taken out;
* ``loss_altered_in_window``: the loss times 1.05 from the program's fourth
  train step on, the window's first (set-up takes three).
"""

from __future__ import annotations

import contextlib

NAMES = ("no_exchange", "loss_altered_in_window")


@contextlib.contextmanager
def planted(name: str):
    from selectivenet_for_semantic_segmentation_binary_torch import train_lib

    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r} (expected one of {NAMES})")
    real_mean, real_losses, calls = train_lib.mean_gradients, train_lib._losses, [0]

    def altered(*a, **k):
        calls[0] += 1
        loss, extras, output, selection = real_losses(*a, **k)
        return (loss * 1.05 if calls[0] >= 4 else loss), extras, output, selection

    if name == "no_exchange":
        train_lib.mean_gradients = lambda params, pg: None
    else:
        train_lib._losses = altered
    try:
        yield
    finally:
        train_lib.mean_gradients, train_lib._losses = real_mean, real_losses
