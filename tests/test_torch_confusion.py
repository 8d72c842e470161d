"""The port's confusion count (``ops/confusion.py``) against the JAX package's
(``ops/confusion.py::confusion_matrix_update``) on the same seeded numpy
labels, predictions and selections: integer for integer, with PAD_LABEL
padding, rejected pixels, predictions out of range and batches where nothing
counts. The count has a fixed shape: it runs on meta tensors, which have no
data, so nothing in it waits for the host."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch.ops.confusion import (
    PAD_LABEL, confusion_matrix_update)
from selectivenet_for_semantic_segmentation_binary_tpu.ops.confusion import (
    confusion_matrix_update as jax_confusion_matrix_update)


def _case(name, rng):
    """(label, pred, selection or None, num_class) of one named case."""
    shape = (3, 17, 23)
    if name == "binary":
        return rng.integers(0, 2, shape), rng.integers(0, 2, shape), None, 2
    if name == "binary_selective":
        return (rng.integers(0, 2, shape), rng.integers(0, 2, shape),
                rng.integers(0, 2, shape), 2)
    if name == "pad_label":
        lab = rng.integers(0, 2, shape)
        lab[-1] = PAD_LABEL  # a fully padded sample
        lab.reshape(-1)[::7] = PAD_LABEL
        return lab, rng.integers(0, 2, shape), rng.integers(0, 2, shape), 2
    if name == "negative_label":
        lab = rng.integers(-1, 3, shape)
        return lab, rng.integers(0, 3, shape), None, 3
    if name == "all_rejected":
        return (rng.integers(0, 2, shape), rng.integers(0, 2, shape),
                np.zeros(shape, np.int64), 2)
    if name == "all_padded":
        return (np.full(shape, PAD_LABEL), rng.integers(0, 2, shape),
                rng.integers(0, 2, shape), 2)
    if name == "multiclass":
        return rng.integers(0, 5, shape), rng.integers(0, 5, shape), None, 5
    if name == "selection_values":
        # only selection == 1 counts, not any nonzero value
        return (rng.integers(0, 2, shape), rng.integers(0, 2, shape),
                rng.integers(0, 3, shape), 2)
    raise ValueError(name)


CASES = ("binary", "binary_selective", "pad_label", "negative_label", "all_rejected",
         "all_padded", "multiclass", "selection_values")


@pytest.mark.parametrize("name", CASES)
def test_confusion_matches_jax(name):
    rng = np.random.default_rng(CASES.index(name))
    lab, pred, sel, k = _case(name, rng)
    got = confusion_matrix_update(torch.from_numpy(lab), torch.from_numpy(pred), k,
                                  None if sel is None else torch.from_numpy(sel))
    want = jax_confusion_matrix_update(jnp.asarray(lab), jnp.asarray(pred), k,
                                       None if sel is None else jnp.asarray(sel))
    assert got.dtype == torch.int64 and got.shape == (k, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name in ("all_rejected", "all_padded"):
        assert int(got.sum()) == 0


@pytest.mark.parametrize("dtypes", [(torch.uint8, torch.bool), (torch.int32, torch.int64),
                                    (torch.int64, torch.int32)],
                         ids=["uint8_bool", "int32_int64", "int64_int32"])
def test_confusion_input_dtypes(dtypes):
    """The label and prediction types the steps hand over count the same."""
    rng = np.random.default_rng(11)
    lab = rng.integers(0, 2, (2, 9, 9))
    pred = rng.integers(0, 2, (2, 9, 9))
    want = confusion_matrix_update(torch.from_numpy(lab), torch.from_numpy(pred), 2)
    got = confusion_matrix_update(torch.from_numpy(lab).to(dtypes[0]),
                                  torch.from_numpy(pred).to(dtypes[1]), 2)
    assert torch.equal(got, want)


def test_confusion_of_an_empty_batch():
    got = confusion_matrix_update(torch.zeros((0, 4, 4), dtype=torch.uint8),
                                  torch.zeros((0, 4, 4), dtype=torch.bool), 2,
                                  torch.zeros((0, 4, 4), dtype=torch.int64))
    assert torch.equal(got, torch.zeros((2, 2), dtype=torch.int64))


def test_confusion_has_a_fixed_shape():
    """Boolean indexing and bincount size their output from the data and
    fail on meta tensors; the fixed-shape count runs on them."""
    lab = torch.empty((2, 8, 8), dtype=torch.uint8, device="meta")
    pred = torch.empty((2, 8, 8), dtype=torch.bool, device="meta")
    sel = torch.empty((2, 8, 8), dtype=torch.int64, device="meta")
    got = confusion_matrix_update(lab, pred, 2, sel)
    assert got.device.type == "meta" and got.shape == (2, 2) and got.dtype == torch.int64
