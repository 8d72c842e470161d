"""QAT (``--train_quant int8``) of the port against the JAX package's, on the
CPU: ``ops/int8_conv.Int8STEConv`` against ``int8_ste_conv`` and
``_qat_fwd_math`` (JAX ``models/unet.py:221-278``), ``models.QATCBR`` in
the classic trunk, one train step, and the guards; each mirrors a test of
``tests/test_qat.py``.

Tolerances:
* the STE forward within rtol/atol 1e-6 of ``_qat_fwd_math`` (the same
  dynamic scales and int8 levels; XLA may contract a product);
* its gradients within JAX's own bounds of the float conv's (rtol 2e-2;
  atol 2e-2 for dX, 1e-1 for dW: both are bf16 convs);
* one QAT train step's loss within 1e-3 of JAX's (float32, the same
  weights and batch), and within QAT_LOSS_REL of the float step's loss,
  but not equal to it (the bound chip_smoke.py holds on the card).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.config import TrainConfig as JaxTrainConfig
from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.models.unet import (
    _qat_fwd_math, int8_ste_conv)
from selectivenet_for_semantic_segmentation_binary_tpu.optim import build_optimizer as jax_optimizer
from selectivenet_for_semantic_segmentation_binary_tpu.train_lib import (
    TrainState, make_train_step as jax_train_step)
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
from selectivenet_for_semantic_segmentation_binary_torch.models import (
    QATCBR, build_model, init_weights)
from selectivenet_for_semantic_segmentation_binary_torch.ops.int8_conv import (
    Int8STEConv, qat_conv_forward)
from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_train_step

FWD_TOL = dict(rtol=1e-6, atol=1e-6)
DX_TOL, DW_TOL = dict(rtol=2e-2, atol=2e-2), dict(rtol=2e-2, atol=1e-1)
STEP_LOSS_TOL = 1e-3
QAT_LOSS_REL = 5e-2  # |QAT loss - float loss| / float loss of one step, held by chip_smoke.py
SIZE = 16


def _conv_operands(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 4, 8)) * 0.1).astype(np.float32)  # HWIO
    return x, k


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _oihw(k):
    return torch.from_numpy(k.transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_ste_forward_matches_jax_qat_math(x_dtype):
    x, k = _conv_operands()
    if x_dtype == "bfloat16":  # a bf16 activation; JAX reads it as float32
        x = torch.from_numpy(x).bfloat16().float().numpy()
    want = np.asarray(_qat_fwd_math(jnp.asarray(x), jnp.asarray(k)))
    got = qat_conv_forward(_nchw(x).to(getattr(torch, x_dtype)), _oihw(k))
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    y_f = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    err = np.abs(got - y_f).max()
    assert 0.0 < err <= 0.05 * max(np.abs(y_f).max(), 1.0)  # quantized, not silently float


def test_ste_gradients_match_jax():
    """The straight-through backward: the float conv's gradients in bf16,
    as JAX's ``_int8_ste_bwd`` computes them (sum cotangent)."""
    x, k = _conv_operands(1)
    jgx, jgk = jax.grad(lambda a, b: jnp.sum(int8_ste_conv(a, b)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(k))
    fgx, fgk = jax.grad(lambda a, b: jnp.sum(jax.lax.conv_general_dilated(
        a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(k))
    xt, kt = _nchw(x).requires_grad_(), _oihw(k).requires_grad_()
    Int8STEConv.apply(xt, kt).sum().backward()
    gx = xt.grad.permute(0, 2, 3, 1).numpy()
    gk = kt.grad.permute(2, 3, 1, 0).numpy()
    assert xt.grad.dtype == kt.grad.dtype == torch.float32
    for want in (jgx, fgx):
        np.testing.assert_allclose(gx, np.asarray(want), **DX_TOL)
    for want in (jgk, fgk):
        np.testing.assert_allclose(gk, np.asarray(want), **DW_TOL)


@pytest.fixture(scope="module")
def models():
    """The QAT and the float selective UNet_B, the same weights and BN
    statistics (float32)."""
    m_q = build_model("UNet_B", selective=True, train_quant="int8")
    m_f = build_model("UNet_B", selective=True)
    init_weights(m_f, torch.Generator().manual_seed(0))
    init_weights(m_q, torch.Generator().manual_seed(0))
    return m_q, m_f


def test_state_dict_and_init_identical(models):
    m_q, m_f = models
    assert sum(isinstance(m, QATCBR) for m in m_q.modules()) == 14
    sd_q, sd_f = m_q.state_dict(), m_f.state_dict()
    assert list(sd_q) == list(sd_f)
    for k in sd_f:
        assert torch.equal(sd_q[k], sd_f[k]), k


def test_eval_forward_is_exactly_float(models):
    m_q, m_f = models
    x = _nchw(np.random.default_rng(0).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(m_q.eval()(x), m_f.eval()(x)):
            assert torch.equal(a, b)


def _train_outputs(model, x, y=None):
    """One train-mode forward (and the BCE gradient if y is given) of a
    copy, so the fixture's running statistics stay as they are."""
    m = copy.deepcopy(model).train()
    out = m(x)
    if y is None:
        return out
    (torch.nn.functional.binary_cross_entropy_with_logits(out[0], y)
     + 0.1 * torch.sigmoid(out[1]).mean() + 0.1 * out[2].mean()).backward()
    return [p.grad.flatten() for p in m.parameters()]


def test_train_forward_quantized_but_close(models):
    m_q, m_f = models
    x = _nchw(np.random.default_rng(1).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        d = float((_train_outputs(m_q, x)[0] - _train_outputs(m_f, x)[0]).abs().max())
    assert 0.0 < d < 1.0, d  # quantization noise, not divergence


def test_gradients_aligned_with_float_model(models):
    m_q, m_f = models
    rng = np.random.default_rng(2)
    x = _nchw(rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32))
    y = torch.from_numpy((rng.random((2, SIZE, SIZE)) > 0.5).astype(np.float32))
    g_q, g_f = torch.cat(_train_outputs(m_q, x, y)), torch.cat(_train_outputs(m_f, x, y))
    cos = float(torch.dot(g_q, g_f) / (g_q.norm() * g_f.norm()))
    assert cos > 0.8, cos  # JAX's bound (test_qat.py)


def test_one_qat_step_matches_jax_and_tracks_the_float_step():
    """One ``make_train_step`` step of each package from the same weights
    and batch (float32, BCElogit selective risk): the QAT losses agree, and
    the QAT loss is near the float step's but not equal to it."""
    kw = dict(model_arch="UNet_B", selective=True, loss="BCElogit", s_lamb=2.0,
              compute_dtype="float32", batch_size=2, patch_size=SIZE, lr=1e-3)
    rng = np.random.default_rng(3)
    batch = {"input": rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8),
             "label": (rng.random((2, SIZE, SIZE)) > 0.5).astype(np.uint8),
             "flips": rng.integers(0, 2, (2, 2)).astype(np.uint8)}
    losses = {}
    for q in ("none", "int8"):
        model = init_weights(build_model("UNet_B", selective=True, train_quant=q),
                             torch.Generator().manual_seed(4))
        sd = {k: v.numpy().copy() for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
        cfg = TrainConfig(train_quant=q, **kw)
        step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
        losses[q] = float(step({k: torch.from_numpy(v) for k, v in batch.items()}, 1e-3)["loss"])
    variables = torch_state_dict_to_variables(sd)
    jcfg = JaxTrainConfig(train_quant="int8", **kw)
    tx = jax_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(params=params, opt_state=tx.init(params),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))
    jstep = jax_train_step(jax_build_model("UNet_B", selective=True, compute_dtype="float32",
                                           train_quant="int8"), jcfg, tx)
    _, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, 1e-3,
                  jax.random.PRNGKey(0))
    assert losses["int8"] == pytest.approx(float(jm["loss"]), abs=STEP_LOSS_TOL)
    rel = abs(losses["int8"] - losses["none"]) / abs(losses["none"])
    assert 0.0 < rel < QAT_LOSS_REL, rel


@pytest.mark.parametrize("kwargs,match", [
    (dict(train_quant="fp8"), "train_quant"),
    (dict(folded=True, train_quant="int8"), "exclusive"),
    (dict(fused=True, train_quant="int8"), "fused"),
    (dict(folded=True, quantize="int8", train_quant="int8"), "exclusive"),
], ids=["unknown", "folded", "fused", "serving"])
def test_build_model_guards_match_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as want:
        jax_build_model("UNet_B", **kwargs)
    with pytest.raises(ValueError, match=match) as got:
        build_model("UNet_B", **kwargs)
    assert str(got.value) == str(want.value)
