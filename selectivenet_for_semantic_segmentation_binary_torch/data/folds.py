"""5-fold cross-validation list construction.

Counterpart of the JAX package's ``data/folds.py:27-68`` (reference
utils/data_utils.py:44-86), copied until the JAX package's ``data/`` imports
without JAX (ROADMAP A0):

* training pool = the four non-test folds' ``{i}-fold_tumorable_data.npy``
  and ``{i}-fold_non_tumorable_data.npy`` lists of (input, label) filename
  pairs, split 80/20 into train and valid separately per class, by
  choice-without-replacement from one ``RandomState(seed)`` (tumorable
  first), the sequence the reference's ``np.random.seed(42)`` gives;
* test = the held-out fold's two lists stacked.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def split_train_valid(train_list, valid_ratio: float = 0.2,
                      rs: np.random.RandomState = None):
    """Choice-without-replacement 80/20 split (data_utils.py:50-54)."""
    if rs is None:
        rs = np.random.RandomState(42)
    train_list = np.asarray(train_list)
    total_n = len(train_list)
    valid_idx = rs.choice(total_n, size=int(total_n * valid_ratio), replace=False)
    train_idx = np.setdiff1d(np.arange(total_n), valid_idx)
    return train_list[train_idx], train_list[valid_idx]


def construct_train_valid(data_dir: str, test_fold: int = 5,
                          seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """The (train, valid) filename-pair lists (data_utils.py:56-74)."""
    folds = [i for i in (1, 2, 3, 4, 5) if i != test_fold]
    tumorable = np.concatenate([np.load(f"{data_dir}/{i}-fold_tumorable_data.npy")
                                for i in folds])
    non_tumorable = np.concatenate([np.load(f"{data_dir}/{i}-fold_non_tumorable_data.npy")
                                    for i in folds])
    rs = np.random.RandomState(seed)
    t_train, t_valid = split_train_valid(tumorable, 0.2, rs)
    n_train, n_valid = split_train_valid(non_tumorable, 0.2, rs)
    return np.vstack([t_train, n_train]), np.vstack([t_valid, n_valid])


def construct_test(data_dir: str, test_fold: int = 1) -> np.ndarray:
    """The held-out fold's stacked (input, label) filename pairs."""
    tumorable = np.load(f"{data_dir}/{test_fold}-fold_tumorable_data.npy")
    non_tumorable = np.load(f"{data_dir}/{test_fold}-fold_non_tumorable_data.npy")
    return np.vstack([np.asarray(tumorable), np.asarray(non_tumorable)])
