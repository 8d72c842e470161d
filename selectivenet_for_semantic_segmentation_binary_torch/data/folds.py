"""Test-fold list construction.

Counterpart of the JAX package's ``data/folds.py:64-68`` (reference
utils/data_utils.py:76-86), copied until the JAX package's ``data/`` imports
without JAX (ROADMAP A0).
"""

from __future__ import annotations

import numpy as np


def construct_test(data_dir: str, test_fold: int = 1) -> np.ndarray:
    """The held-out fold's stacked (input, label) filename pairs."""
    tumorable = np.load(f"{data_dir}/{test_fold}-fold_tumorable_data.npy")
    non_tumorable = np.load(f"{data_dir}/{test_fold}-fold_non_tumorable_data.npy")
    return np.vstack([np.asarray(tumorable), np.asarray(non_tumorable)])
