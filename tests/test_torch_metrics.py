"""The port's ``utils/metrics.py`` against the JAX package's, on seeded
numpy inputs: every ``Evaluator`` getter (selective and not, numpy and torch
batches), ``get_performance`` (whose JAX AUC is scikit-learn's) and the
IoU helpers. Every comparison is exact (NaN equal to NaN)."""

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.utils import metrics as jax_metrics
from selectivenet_for_semantic_segmentation_binary_torch.utils import metrics

GETTERS = ("get_Pixel_Accuracy", "get_Pixel_Accuracy_Class", "get_Pixel_Accuracy_Class_S",
           "get_Precision", "get_Recall", "get_mIoU", "get_IoU_Class", "get_FWIoU",
           "get_Dice_Score")


def _batches(num_class, seed, n=3):
    """(label, pred, selection) batches with some padding labels (255)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = rng.integers(0, num_class, (2, 16, 16)).astype(np.uint8)
        label[:, :2] = 255
        pred = rng.integers(0, num_class, (2, 16, 16)).astype(np.uint8)
        selection = (rng.random((2, 16, 16)) < 0.7).astype(np.uint8)
        out.append((label, pred, selection))
    return out


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("selective", [False, True], ids=["plain", "selective"])
@pytest.mark.parametrize("num_class", [2, 3])
def test_evaluator_getters_match_jax(num_class, selective, kind, capsys):
    want = jax_metrics.Evaluator(num_class, selective=selective)
    got = metrics.Evaluator(num_class, selective=selective)
    for label, pred, sel in _batches(num_class, seed=num_class + 10 * selective):
        want.add_batch(label, pred, sel)
        if kind == "torch":
            got.add_batch(torch.from_numpy(label), torch.from_numpy(pred),
                          torch.from_numpy(sel))
        else:
            got.add_batch(label, pred, sel)
    _same(got.Confusion_Matrix(), want.Confusion_Matrix())
    assert got.confusion_matrix.dtype == np.float64
    for name in GETTERS:
        _same(getattr(got, name)(), getattr(want, name)())
    _same(got.get_F1_Score(got.get_Precision(), got.get_Recall()),
          want.get_F1_Score(want.get_Precision(), want.get_Recall()))
    printed = capsys.readouterr().out
    assert printed.count("[") >= 2  # Confusion_Matrix prints, as in JAX
    got.reset()
    want.reset()
    _same(got.confusion_matrix, want.confusion_matrix)


def test_evaluator_with_an_empty_class_matches_jax():
    """A class never labelled nor predicted: the NaN getters and FWIoU's
    frequency mask."""
    label = np.zeros((4, 4), np.uint8)
    pred = np.zeros((4, 4), np.uint8)
    pred[0, 0] = 1
    want, got = jax_metrics.Evaluator(3), metrics.Evaluator(3)
    want.add_batch(label, pred)
    got.add_batch(label, pred)
    for name in GETTERS:
        _same(getattr(got, name)(), getattr(want, name)())


def _perf_cases():
    rng = np.random.default_rng(5)
    label = (rng.random((2, 24, 24)) < 0.4).astype(np.uint8)
    score = rng.random((2, 24, 24)).astype(np.float32)
    tied = (rng.integers(0, 256, score.shape) / 255.0).astype(np.float32)
    coarse = (rng.integers(0, 4, score.shape) / 3.0).astype(np.float32)
    return {
        "random": (label, score, (score > 0.5).astype(np.uint8)),
        "tied_scores": (label, tied, (tied > 0.5).astype(np.uint8)),
        "coarse_ties": (label, coarse, (coarse > 0.5).astype(np.uint8)),
        "informative": (label, np.clip(score * 0.6 + label * 0.5, 0, 1),
                        (score * 0.6 + label * 0.5 > 0.5).astype(np.uint8)),
        "all_negative_pred": (label, score, np.zeros_like(label)),
        "one_class_0": (np.zeros_like(label), score, (score > 0.5).astype(np.uint8)),
        "one_class_1": (np.ones_like(label), score, (score > 0.5).astype(np.uint8)),
        "constant_score": (label, np.full_like(score, 0.25), np.zeros_like(label)),
        "one_pixel_each": (np.array([0, 1], np.uint8), np.array([0.3, 0.3], np.float32),
                           np.array([0, 0], np.uint8)),
    }


@pytest.mark.parametrize("case", list(_perf_cases()))
def test_get_performance_matches_jax(case):
    label, score, pred = _perf_cases()[case]
    got = metrics.get_performance(label, score, pred)
    want = jax_metrics.get_performance(label, score, pred)
    assert len(got) == len(want) == 5
    _same(np.array(got, np.float64), np.array(want, np.float64))
    if case.startswith("one_class"):
        assert np.isnan(got[4])
    else:
        assert np.isfinite(got[4])


def test_roc_auc_equals_scikit_learn_on_many_tied_sets():
    """The trapezoid over scikit-learn's curve, bit for bit, where the rank
    (Mann-Whitney) formula differs in the last bits."""
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(6)
    for t in range(40):
        n = int(rng.integers(2, 5000))
        label = (rng.random(n) < rng.random()).astype(np.uint8)
        score = (rng.integers(0, 256, n) / 255.0).astype(np.float32) if t % 2 else \
            rng.random(n).astype(np.float32)
        if label.min() == label.max():
            continue
        assert metrics.roc_auc(label, score) == roc_auc_score(label, score)


def test_roc_auc_is_nan_where_scikit_learn_has_no_value():
    assert np.isnan(metrics.roc_auc(np.array([], np.uint8), np.array([], np.float32)))
    assert np.isnan(metrics.roc_auc(np.array([0, 1]), np.array([0.2, np.nan])))
    assert np.isnan(metrics.roc_auc(np.array([0, 2]), np.array([0.2, 0.3])))  # not {0, 1}
    assert metrics.roc_auc(np.array([-1, 1]), np.array([0.2, 0.3])) == 1.0


@pytest.mark.parametrize("n_class", [2, 3])
def test_iou_helpers_match_jax(n_class):
    rng = np.random.default_rng(7 + n_class)
    label = rng.integers(0, n_class, (3, 20, 20))
    pred = rng.integers(0, n_class, (3, 20, 20))
    for index in range(n_class + 1):  # the last index is absent: (0 + eps) / (0 + eps)
        assert metrics.compute_IoU(label, pred, index) == jax_metrics.compute_IoU(
            label, pred, index)
    assert metrics.compute_mIOU(label, pred, n_class) == jax_metrics.compute_mIOU(
        label, pred, n_class)
