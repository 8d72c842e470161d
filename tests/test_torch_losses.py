"""The port's losses against the JAX package's: values and gradients.

Inputs are made with numpy from a seed and fed to both; logits reach +-30,
where a direct log(sigmoid(x)) would be -inf, so the stable log-sigmoid
forms are exercised. Masked cases carry PAD_LABEL = 255 pixels, which must
drop out of every mean. Tolerance: rtol 1e-5, atol 1e-6 on values and
gradients (float32 means over a few hundred elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.ops import losses as jl
from selectivenet_for_semantic_segmentation_binary_torch.ops import losses as pl
from selectivenet_for_semantic_segmentation_binary_torch.ops.confusion import PAD_LABEL

TOL = dict(rtol=1e-5, atol=1e-6)
N, H, W, C = 2, 8, 12, 3


def _data(masked: bool, n_cls: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, n_cls, (N, H, W)).astype(np.int32)
    if masked:
        label[-1, H // 2:] = PAD_LABEL
        label[0, 0, :3] = PAD_LABEL
    out = (rng.standard_normal((N, H, W)) * 4).astype(np.float32)
    out[0, 1, :4] = [30.0, -30.0, 25.0, -25.0]
    sel = (rng.standard_normal((N, H, W)) * 2).astype(np.float32)
    mask = (label >= 0) & (label < n_cls)
    return out, sel, label, mask if masked else None


def _port(fn, arrays, mask, **kw):
    """Loss value(s) and the gradient w.r.t. the first two arrays."""
    ts = [torch.from_numpy(a).requires_grad_(a.dtype == np.float32) for a in arrays]
    m = None if mask is None else torch.from_numpy(mask)
    res = fn(*ts, mask=m, **kw)
    loss = res[0] if isinstance(res, tuple) else res
    loss.backward()
    grads = [t.grad.numpy() if t.grad is not None else np.zeros_like(a)
             for t, a in zip(ts, arrays) if a.dtype == np.float32]
    values = [r.detach().numpy() for r in (res if isinstance(res, tuple) else (res,))]
    return values, grads


def _jax(fn, arrays, mask, **kw):
    n_float = sum(a.dtype == np.float32 for a in arrays)
    m = None if mask is None else jnp.asarray(mask)

    def f(*floats):
        args = list(floats) + [jnp.asarray(a) for a in arrays[n_float:]]
        res = fn(*args, mask=m, **kw)
        return (res[0], res) if isinstance(res, tuple) else (res, (res,))

    grads, values = jax.grad(f, argnums=tuple(range(n_float)), has_aux=True)(
        *[jnp.asarray(a) for a in arrays[:n_float]])
    return [np.asarray(v) for v in values], [np.asarray(g) for g in grads]


def _check(port, want):
    for g, w in zip(port[0], want[0]):
        np.testing.assert_allclose(g, w, **TOL)
    for g, w in zip(port[1], want[1]):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_bce_with_logits(masked):
    out, _, label, mask = _data(masked)
    target = label.astype(np.float32)
    # the target is a float array: both sides take its gradient too
    _check(_port(pl.bce_with_logits, [out, target], mask),
           _jax(jl.bce_with_logits, [out, target], mask))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_softmax_cross_entropy(masked):
    rng = np.random.default_rng(1)
    _, _, label, mask = _data(masked, n_cls=C)
    logits = (rng.standard_normal((N, H, W, C)) * 3).astype(np.float32)
    _check(_port(pl.softmax_cross_entropy, [logits, label], mask),
           _jax(jl.softmax_cross_entropy, [logits, label], mask))


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard_selection"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_selective_risk_b(masked, hard):
    out, sel, label, mask = _data(masked)
    kw = dict(target_coverage=0.8, lamb=2.0, hard_selection=hard)
    # labels as int32: the padded 255s must be clipped and masked, not read
    _check(_port(pl.selective_risk_b, [out, sel, label], mask, **kw),
           _jax(jl.selective_risk_b, [out, sel, label], mask, **kw))


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard_selection"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_selective_risk_ce(masked, hard):
    rng = np.random.default_rng(2)
    _, _, label, mask = _data(masked, n_cls=C)
    out = (rng.standard_normal((N, H, W, C)) * 3).astype(np.float32)
    sel = (rng.standard_normal((N, H, W, 2)) * 2).astype(np.float32)
    kw = dict(target_coverage=0.7, lamb=8.0, hard_selection=hard)
    _check(_port(pl.selective_risk_ce, [out, sel, label], mask, **kw),
           _jax(jl.selective_risk_ce, [out, sel, label], mask, **kw))


def test_masked_loss_equals_the_loss_of_the_valid_samples():
    """A padded batch's masked loss is the unpadded batch's plain loss."""
    out, sel, label, _ = _data(False)
    padded = np.concatenate([label, np.full((1, H, W), PAD_LABEL, np.int32)])
    out_p = np.concatenate([out, np.zeros((1, H, W), np.float32)])
    sel_p = np.concatenate([sel, np.zeros((1, H, W), np.float32)])
    want = pl.selective_risk_b(torch.from_numpy(out), torch.from_numpy(sel),
                               torch.from_numpy(label))
    got = pl.selective_risk_b(torch.from_numpy(out_p), torch.from_numpy(sel_p),
                              torch.from_numpy(padded), mask=torch.from_numpy(padded < 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6)
    assert float(got[0]) >= 0.0
