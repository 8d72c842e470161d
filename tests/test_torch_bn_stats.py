"""``--bn_stats bfloat16``: the port's ``LowPrecStatsBN`` against the JAX
package's, on the CPU.

Tolerances: where the batch statistics are reduced in bf16, within 2^-7 of
max |reference| (a bf16 mean or variance rounds differently where the two
float32 sums, taken in other orders, straddle a rounding boundary: one bf16
ulp, 2^-8 relative, moves the output by up to about that); where they are
reduced in float32, 1e-6 of max |reference|.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.models.unet import (
    LowPrecStatsBN as JaxLowPrecStatsBN)
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
from selectivenet_for_semantic_segmentation_binary_torch.models import (
    BatchNorm2d, LowPrecStatsBN, build_model, init_weights, load_weights)
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import check_supported, train
from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
    load_checkpoint, state_dict_from_jax_variables)

BF16_TOL = 2.0 ** -7
F32_TOL = 1e-6
C = 8

# (compute dtype, statistics dtype, input mean): |mean|/std = 30 is where the
# one-pass bf16 variance is exactly 0
CASES = {
    "bf16": ("bfloat16", "bfloat16", 0.0),
    "bf16_large_mean": ("bfloat16", "bfloat16", 30.0),
    "f32_compute_bf16_stats": ("float32", "bfloat16", 0.3),
    "f32": ("float32", "float32", 0.3),
}


def _bn_inputs(seed, mean):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 16, 16, C)) * rng.uniform(0.5, 2.0, C) + mean).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": rng.uniform(-0.2, 0.2, C).astype(np.float32)}
    stats = {"mean": rng.uniform(-0.1, 0.1, C).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    return x, params, stats


def _port_bn(params, stats, stats_dtype):
    bn = LowPrecStatsBN(C, stats_dtype=getattr(torch, stats_dtype))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    return bn


@pytest.mark.parametrize("case", list(CASES))
def test_train_mode_matches_jax(case):
    dtype, stats_dtype, mean = CASES[case]
    x, params, stats = _bn_inputs(list(CASES).index(case), mean)
    jbn = JaxLowPrecStatsBN(dtype=jnp.dtype(dtype), stats_dtype=jnp.dtype(stats_dtype))
    y, mut = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x).astype(dtype),
                       use_running_average=False, mutable=["batch_stats"])
    want = np.asarray(y.astype(jnp.float32))
    bn = _port_bn(params, stats, stats_dtype).train()
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = bn(xt)
    assert got.dtype == getattr(torch, dtype)
    tol = BF16_TOL if stats_dtype == "bfloat16" else F32_TOL
    err = np.abs(got.detach().permute(0, 2, 3, 1).float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        w = np.asarray(mut["batch_stats"][key])
        g = getattr(bn, name)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * np.abs(w).max(), err_msg=name)
    assert int(bn.num_batches_tracked) == 1


def test_normalisation_stays_in_the_compute_dtype_under_autocast(monkeypatch):
    """CUDA's autocast runs ``rsqrt`` in float32 (its float32 list), which
    would take the whole normalisation to float32; the CPU's does not. With
    ``rsqrt`` patched to follow CUDA's policy, the train-mode output is still
    bf16 and equal to the output without autocast."""
    x, params, stats = _bn_inputs(7, 0.3)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    want = _port_bn(params, stats, "bfloat16").train()(xt)
    real = torch.rsqrt

    def cuda_policy(t):
        return real(t.float()) if torch.is_autocast_enabled("cpu") else real(t)

    monkeypatch.setattr(torch, "rsqrt", cuda_policy)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = _port_bn(params, stats, "bfloat16").train()(xt)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_two_pass_variance_survives_a_large_mean():
    """|mean|/std = 30 (JAX tests/test_model.py): the batch variance stays
    ~1 where the one-pass E[x^2] - E[x]^2 gives exactly 0 in bf16."""
    x, params, stats = _bn_inputs(5, 30.0)
    x = (x - x.mean((0, 1, 2))) / x.std((0, 1, 2)) + 30.0
    bn = _port_bn(params, {"mean": np.zeros(C, np.float32), "var": np.ones(C, np.float32)},
                  "bfloat16").train()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = bn(xb.permute(0, 3, 1, 2))
    batch_var = (bn.running_var.numpy() - 0.9) / 0.1
    np.testing.assert_allclose(batch_var, 1.0, rtol=0.15)
    xf = xb.float()
    one_pass = ((xf * xf).to(torch.bfloat16).float().mean((0, 1, 2)).to(torch.bfloat16)
                - xf.mean((0, 1, 2)).to(torch.bfloat16) ** 2)
    assert float(one_pass.float().abs().max()) == 0.0  # the form it avoids
    assert float(y.detach().float().abs().max()) < 10.0


def test_eval_mode_is_the_classic_bn():
    x, params, stats = _bn_inputs(6, 0.3)
    bn = _port_bn(params, stats, "bfloat16").eval()
    ref = BatchNorm2d(C).eval()
    ref.load_state_dict(bn.state_dict())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert torch.equal(bn(xt), ref(xt))


def test_state_dict_is_batchnorm2ds():
    a = build_model("UNet_B", selective=True, bn_stats="bfloat16").state_dict()
    b = build_model("UNet_B", selective=True).state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    assert isinstance(build_model("UNet_B", bn_stats="bfloat16").encoder_layer_1_1[1],
                      LowPrecStatsBN)


def test_whole_model_train_forward_matches_jax():
    """The classic trunk with bf16 statistics, float32 compute, batch 2 at
    32x32: the three heads and every running statistic."""
    model = build_model("UNet_B", selective=True, bn_stats="bfloat16")
    init_weights(model, torch.Generator().manual_seed(0))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = jax.tree_util.tree_map(jnp.asarray, torch_state_dict_to_variables(sd))
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = jax_build_model("UNet_B", selective=True, compute_dtype="float32", bn_stats="bfloat16")
    out, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, out):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= BF16_TOL * np.abs(w).max()
    want = state_dict_from_jax_variables(
        {"params": jax.device_get(variables["params"]), "batch_stats": jax.device_get(
            mut["batch_stats"])})
    state = model.state_dict()
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=0,
                                       atol=BF16_TOL * w.abs().max().item(), err_msg=k)


def test_a_jax_bf16_stats_tree_loads():
    """Variables of a JAX model built with bn_stats='bfloat16' load into the
    port's, and the eval forward (running statistics) agrees at 1e-4."""
    jm = jax_build_model("UNet_B", selective=True, compute_dtype="float32", bn_stats="bfloat16")
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), train=False)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.05), jax.device_get(variables))
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), train=False)
    model = build_model("UNet_B", selective=True, bn_stats="bfloat16")
    load_weights(model, state_dict_from_jax_variables(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_fused_trunk_refuses_bf16_stats_alike():
    for build in (build_model, jax_build_model):
        with pytest.raises(ValueError, match="bn_stats"):
            build("UNet_B", fused=True, bn_stats="bfloat16")
    with pytest.raises(ValueError, match="bn_stats"):
        build_model("UNet_B", bn_stats="float16")


def test_train_with_bf16_stats(tmp_path):
    """check_supported takes --bn_stats bfloat16 and train() writes a
    checkpoint that the classic model loads."""
    from selectivenet_for_semantic_segmentation_binary_tpu.data import write_synthetic_patch_tree

    data = str(tmp_path / "data")
    write_synthetic_patch_tree(data, n_slides=2, patches_per_slide=10, patch_size=32)
    cfg = TrainConfig(data_dir=data, model_dir=str(tmp_path / "m"), fold=1, patch_size=32,
                      batch_size=4, n_epoch=1, model_arch="UNet_B", loss="BCElogit",
                      selective=True, compute_dtype="float32", num_workers=2,
                      bn_stats="bfloat16")
    check_supported(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        result = train(cfg, device="cpu")
    assert isinstance(result["model"].decoder_layer_1_1[1], LowPrecStatsBN)
    assert np.isfinite(result["train"].loss) and np.isfinite(result["valid"].loss)
    ckpt = load_checkpoint(os.path.join(cfg.ckpt_dir, "model_epoch1.pth"))
    load_weights(build_model("UNet_B", selective=True), ckpt["net"])
