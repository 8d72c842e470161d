"""The port's dropout (``models/unet.py``: ``dropout``, the ``drop_bottom`` and
``drop3`` sites; ``train_lib.make_train_step`` with ``--dropout_rate``)
against flax and the JAX package, on the CPU.

* The functional form, given the mask JAX draws
  (``jax.random.bernoulli(key, keep, shape)``), equals flax's ``nn.Dropout``
  bit for bit in float32 and in bfloat16, where JAX divides by
  bfloat16(keep) (0.8984375 for keep 0.9).
* A ``dropout_rate=0.3`` model in eval mode is the JAX eval forward
  (``TOL``, as tests/test_torch_model.py holds the eval forward); the
  dropout layers hold no parameters, so a JAX tree at rate 0.3 carries
  across unchanged.
* Both trunks draw the same masks from the same generator state: their
  train-mode forwards agree within ``FWD_TOL`` (tests/test_torch_train.py's
  fused-against-classic tolerance) and differ under another seed.
* The train step is reproducible by seed and differs from rate 0.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
from selectivenet_for_semantic_segmentation_binary_torch.models import (
    Dropout, build_model, dropout, load_weights)
from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
    make_train_step, make_valid_step)
from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
    state_dict_from_jax_variables)

SIZE = 32
TOL = dict(atol=1e-4, rtol=1e-4)
FWD_TOL = dict(rtol=5e-4, atol=5e-4)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def state():
    return seeded_model(61, "float32", selective=True).state_dict()


def _model(state, rate, fused=False):
    model = build_model("UNet_B", selective=True, fused=fused, dropout_rate=rate)
    return load_weights(model, state)


def _x(seed=62, n=2):
    x = np.random.default_rng(seed).standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dropout_given_the_jax_mask_is_flax_dropout(dtype, rate):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(63).standard_normal((4, 8, 8, 16)).astype(np.float32)
    key = jax.random.PRNGKey(int(rate * 10))
    want = fnn.Dropout(rate).apply({}, jnp.asarray(x, jdt), deterministic=False, rng=key)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - rate, x.shape))
    got = dropout(torch.from_numpy(x).to(tdt), torch.from_numpy(mask), rate)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    if dtype == "bfloat16" and rate == 0.1:
        # the float32 divisor rounds differently on many values (why dropout()
        # divides by keep in x's dtype)
        naive = torch.where(torch.from_numpy(mask), torch.from_numpy(x).to(tdt) / 0.9, 0)
        assert (naive.float().numpy() != np.asarray(want.astype(jnp.float32))).sum() > 100


def test_the_eval_forward_at_rate_03_is_the_jax_eval_forward(state):
    x, xt = _x()
    variables = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in state.items() if not k.endswith("num_batches_tracked")})
    jmodel = jax_build_model("UNet_B", selective=True, compute_dtype="float32", dropout_rate=0.3)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = _model(state, 0.3)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        got = model(xt)
        again = model(xt, generator=g)  # eval mode: the generator is unused
    for a, b, w in zip(got, again, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
        assert torch.equal(a, b)


def test_a_jax_dropout_tree_carries_across_unchanged(state):
    sd = {k: v.numpy() for k, v in state.items() if not k.endswith("num_batches_tracked")}
    variables = torch_state_dict_to_variables(sd)
    sample = jnp.zeros((1, 8, 8, 3), jnp.float32)
    shapes = {r: jax.eval_shape(lambda: jax_build_model(
        "UNet_B", selective=True, dropout_rate=r).init(jax.random.PRNGKey(0), sample))
        for r in (0.0, 0.3)}
    assert (jax.tree_util.tree_structure(shapes[0.3])
            == jax.tree_util.tree_structure(shapes[0.0])
            == jax.tree_util.tree_structure(variables))
    back = state_dict_from_jax_variables(variables)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(np.asarray(back[k]), sd[k])
    at_rate = build_model("UNet_B", selective=True, dropout_rate=0.3)
    assert at_rate.state_dict().keys() == build_model("UNet_B", selective=True).state_dict().keys()
    load_weights(at_rate, back)


def test_a_site_draws_one_mask_in_either_layout():
    x = torch.randn(2, 8, 6, 5, generator=torch.Generator().manual_seed(1))  # NHWC
    nchw = x.permute(0, 3, 1, 2)
    site = Dropout(0.4)
    a = site(x, torch.Generator().manual_seed(7), nhwc=True)
    b = site(nchw, torch.Generator().manual_seed(7))
    assert torch.equal(a.permute(0, 3, 1, 2), b)
    kept = float((a != 0).float().mean())
    assert 0.4 < kept < 0.8
    assert torch.equal(site(x), x) and torch.equal(Dropout(0.0)(x, torch.Generator()), x)


def test_both_trunks_draw_the_same_masks(state):
    _, xt = _x(64)
    outs = {}
    for name, fused, seed in (("classic", False, 5), ("fused", True, 5),
                              ("classic_other_seed", False, 6)):
        model = _model(state, 0.3, fused=fused).train()
        with torch.no_grad():
            outs[name] = model(xt, generator=torch.Generator().manual_seed(seed))
    for a, b in zip(outs["classic"], outs["fused"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD_TOL)
    diff = max(float((a - b).abs().max()) for a, b in zip(outs["classic"],
                                                          outs["classic_other_seed"]))
    assert diff > 100 * FWD_TOL["atol"]


def test_live_dropout_needs_a_generator(state):
    _, xt = _x()
    model = _model(state, 0.3)
    with pytest.raises(ValueError, match="generator"):
        model(xt, mc_dropout=True)
    with pytest.raises(ValueError, match="generator"):
        model.train()(xt)
    plain = _model(state, 0.0)
    with torch.no_grad():  # rate 0: mc_dropout changes nothing, no generator needed
        assert all(torch.equal(a, b) for a, b in zip(plain(xt, mc_dropout=True), plain(xt)))


def _steps(state, rate, seed, n=2):
    model = _model(state, rate)
    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", batch_size=2,
                      patch_size=SIZE, compute_dtype="float32", dropout_rate=rate, seed=seed)
    step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    rng = np.random.default_rng(65)
    batch = {"input": torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)),
             "label": torch.from_numpy(rng.integers(0, 2, (2, SIZE, SIZE)).astype(np.uint8))}
    losses = [float(step(batch, 1e-3)["loss"]) for _ in range(n)]
    valid = make_valid_step(model, cfg)(batch)
    return losses, float(valid["loss"]), model


def test_the_train_step_is_reproducible_by_seed(state):
    a, va, model = _steps(state, 0.1, seed=3)
    b, vb, _ = _steps(state, 0.1, seed=3)
    c, _, _ = _steps(state, 0.1, seed=4)
    z, _, _ = _steps(state, 0.0, seed=3)
    assert a == b and va == vb
    assert a[0] != c[0] and a[0] != z[0]
    assert all(np.isfinite(a))
    assert not model.training
    # the valid step runs no dropout: eval forward, same value twice
    cfg = TrainConfig(selective=True, loss="BCElogit", compute_dtype="float32",
                      dropout_rate=0.1)
    rng = np.random.default_rng(66)
    batch = {"input": torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)),
             "label": torch.from_numpy(rng.integers(0, 2, (2, SIZE, SIZE)).astype(np.uint8))}
    step = make_valid_step(model, cfg)
    assert float(step(batch)["loss"]) == float(step(batch)["loss"])
