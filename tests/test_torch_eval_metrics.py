"""The port's eval-metrics op against the JAX package's Pallas kernel.

The JAX ``fused_eval_metrics`` runs interpreted on the CPU, as
tests/test_pallas_metrics.py runs it; the port's side is
``eval_metrics_reference``, the plain version that ``fused_eval_metrics``
dispatches CPU tensors to. Counts must be equal exactly. Logits are kept at
least 1e-4 from ``logit(cut_off)`` so that float32 sigmoid rounding in the
two frameworks cannot flip a pixel; a separate test pins the boundary itself.
The kernel itself runs only on the card: ``chip_smoke.py`` phase 3 and
tests/test_torch_kernels_cuda.py.
"""

import math
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.ops.pallas_metrics import (
    fused_eval_metrics as jax_fused_eval_metrics,
)
from selectivenet_for_semantic_segmentation_binary_torch.ops import eval_metrics as em
from selectivenet_for_semantic_segmentation_binary_torch.ops.confusion import (
    PAD_LABEL,
    confusion_matrix_update,
)

MARGIN = 1e-4


def _away_from(x: np.ndarray, t: float) -> np.ndarray:
    """Push values within MARGIN of t out to t +- 2*MARGIN."""
    near = np.abs(x - t) < MARGIN
    return np.where(near, t + np.where(x >= t, 2 * MARGIN, -2 * MARGIN), x).astype(np.float32)


def _case(rng, shape, *, apply_sigmoid, selective, cut, s_cut, label_dtype, all_pad=False):
    if apply_sigmoid:
        out = rng.standard_normal(shape).astype(np.float32)
        sel = rng.standard_normal(shape).astype(np.float32)
        out = _away_from(out, math.log(cut / (1 - cut)))
        sel = _away_from(sel, math.log(s_cut / (1 - s_cut)))
    else:
        out = _away_from(rng.random(shape).astype(np.float32), cut)
        sel = _away_from(rng.random(shape).astype(np.float32), s_cut)
    lab = rng.integers(0, 2, shape).astype(np.int32)
    if all_pad:
        lab[:] = PAD_LABEL
    elif len(shape) == 3 and shape[0] > 1:
        lab[1] = PAD_LABEL  # a fully padded sample
    return out, (sel if selective else None), lab.astype(label_dtype)


# the six cases of tests/test_pallas_metrics.py, then uint8 labels and an
# all-PAD batch: (shape, apply_sigmoid, selective, cut, s_cut, label dtype, all_pad)
CASES = {
    "plain_awkward_shape": ((4, 33, 47), True, False, 0.5, 0.5, np.int32, False),
    "selective": ((2, 64, 64), True, True, 0.5, 0.5, np.int32, False),
    "padded_sample": ((2, 16, 16), True, False, 0.5, 0.5, np.int32, False),
    "custom_cutoffs": ((1, 32, 32), True, True, 0.3, 0.7, np.int32, False),
    "no_sigmoid": ((1, 32, 32), False, False, 0.5, 0.5, np.int32, False),
    "multi_tile": ((8, 128, 128), True, False, 0.5, 0.5, np.int32, False),
    "uint8_labels_selective": ((3, 40, 24), True, True, 0.3, 0.7, np.uint8, False),
    "all_pad_batch": ((2, 16, 16), True, True, 0.5, 0.5, np.uint8, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_pallas_kernel(name, rng):
    shape, apply_sigmoid, selective, cut, s_cut, label_dtype, all_pad = CASES[name]
    out, sel, lab = _case(rng, shape, apply_sigmoid=apply_sigmoid, selective=selective,
                          cut=cut, s_cut=s_cut, label_dtype=label_dtype, all_pad=all_pad)
    want = jax_fused_eval_metrics(
        jnp.asarray(out), jnp.asarray(lab), None if sel is None else jnp.asarray(sel),
        apply_sigmoid=apply_sigmoid, selective=selective, cut_off=cut,
        s_cut_off=s_cut, interpret=True)
    got = em.fused_eval_metrics(
        torch.from_numpy(out), torch.from_numpy(lab),
        None if sel is None else torch.from_numpy(sel),
        apply_sigmoid=apply_sigmoid, selective=selective, cut_off=cut, s_cut_off=s_cut)
    assert got["cm"].dtype == torch.int64 and got["cm"].shape == (2, 2)
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    assert int(got["n_pix"]) == int(want["n_pix"])
    if selective:
        assert int(got["n_reject"]) == int(want["n_reject"])
    else:
        assert int(got["n_reject"]) == 0
    if all_pad:
        assert int(got["n_pix"]) == 0 and int(got["cm"].sum()) == 0


@pytest.mark.parametrize("apply_sigmoid", [True, False])
def test_value_on_the_cut_off_is_not_positive(apply_sigmoid):
    """Strict ``>``: sigmoid(0) == 0.5 and a raw 0.5 are not above 0.5, in
    the port and in the JAX kernel alike."""
    on_cut = 0.0 if apply_sigmoid else 0.5
    out = np.full((1, 8, 8), on_cut, np.float32)
    lab = np.ones((1, 8, 8), np.int32)
    got = em.fused_eval_metrics(torch.from_numpy(out), torch.from_numpy(lab),
                                apply_sigmoid=apply_sigmoid)
    want = jax_fused_eval_metrics(jnp.asarray(out), jnp.asarray(lab),
                                  apply_sigmoid=apply_sigmoid, interpret=True)
    np.testing.assert_array_equal(got["cm"].numpy(), [[0, 0], [64, 0]])
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))


def test_reference_matches_confusion_matrix_update(rng):
    """The fused op and the general bincount path count the same pixels."""
    out, sel, lab = _case(rng, (3, 20, 28), apply_sigmoid=True, selective=True,
                          cut=0.5, s_cut=0.5, label_dtype=np.int32)
    o, s, l = map(torch.from_numpy, (out, sel, lab))
    got = em.eval_metrics_reference(o, l, s, selective=True)
    pred = torch.sigmoid(o) > 0.5
    sel_mask = (torch.sigmoid(s) > 0.5).long()
    cm = confusion_matrix_update(l, pred, 2, sel_mask)
    assert torch.equal(got["cm"], cm)


def test_cpu_tensors_take_the_plain_version(monkeypatch, rng):
    """CPU tensors dispatch to eval_metrics_reference: no build, no launch."""
    def no_kernel():
        raise AssertionError("the kernel library was requested for CPU tensors")

    monkeypatch.setattr(em, "_kernel", no_kernel)
    calls = []
    orig = em.eval_metrics_reference
    monkeypatch.setattr(em, "eval_metrics_reference",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    before = em.launches
    out = torch.from_numpy(rng.standard_normal((2, 8, 8)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 2, (2, 8, 8)).astype(np.uint8))
    em.fused_eval_metrics(out, lab)
    assert calls == [1] and em.launches == before


def test_other_devices_raise():
    out = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        em.fused_eval_metrics(out, torch.empty((1, 4, 4), dtype=torch.uint8, device="meta"))


def test_importing_kernels_needs_no_nvcc(monkeypatch):
    """Importing the kernel package and the op builds and loads nothing:
    re-executed with the compiler and the library loader made to fail."""
    import ctypes
    import importlib

    from selectivenet_for_semantic_segmentation_binary_torch import kernels

    def refuse(*a, **k):
        raise AssertionError("import tried to build or load a kernel")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(ctypes, "CDLL", refuse)
    importlib.reload(kernels)
    importlib.reload(em)
    assert kernels._libs == {} and em._lib is None


@pytest.mark.parametrize("label_dtype", [np.uint8, np.int32])
def test_offset_views_match_jax_pallas_kernel(label_dtype, rng):
    """Views one element into flat buffers (on the card, the kernel's
    element path) and a length that is not a multiple of 16: the port's
    CPU branch counts as the JAX kernel does on the same values."""
    out, sel, lab = _case(rng, (2, 17, 19), apply_sigmoid=True, selective=True,
                          cut=0.5, s_cut=0.5, label_dtype=label_dtype)
    views = [torch.from_numpy(a).view(-1)[1:] for a in (out, lab, sel)]
    assert views[0].numel() % 16 and em.kernel_path(*views) == "plain"
    got = em.fused_eval_metrics(views[0], views[1], views[2], selective=True)
    want = jax_fused_eval_metrics(*(jnp.asarray(v.numpy().reshape(1, 1, -1)) for v in views[:2]),
                                  jnp.asarray(views[2].numpy().reshape(1, 1, -1)),
                                  selective=True, interpret=True)
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    assert int(got["n_pix"]) == int(want["n_pix"])
    assert int(got["n_reject"]) == int(want["n_reject"])
