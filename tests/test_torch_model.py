"""The port's U-Nets against the JAX package's, on the same weights.

JAX initialises the variables from a seed; ``state_dict_from_jax_variables``
carries them over; both forwards run in float32 eval mode on the CPU at
batch 2, 32x32, full widths, on the same numpy input. Tolerance: atol = rtol
= 1e-4 (float32 convolutions summed in different orders over 18 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    variables_to_torch_state_dict,
)
from selectivenet_for_semantic_segmentation_binary_torch.models import build_model, load_weights
from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
    state_dict_from_jax_variables,
)

TOL = dict(atol=1e-4, rtol=1e-4)


def jax_variables(arch, selective, seed=0, size=32):
    model = jax_build_model(arch, n_cls=2, selective=selective, compute_dtype="float32")
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False)
    variables = jax.device_get(variables)
    # non-trivial running statistics, so the BN mapping is exercised
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, np.shape(v)).astype(np.float32),
        variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("selective", [True, False], ids=["selective", "plain"])
@pytest.mark.parametrize("arch", ["UNet_B", "UNet"])
def test_forward_matches_jax(arch, selective, rng):
    jmodel, variables = jax_variables(arch, selective)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)

    model = build_model(arch, n_cls=2, selective=selective, compute_dtype="float32")
    load_weights(model, state_dict_from_jax_variables(variables))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last
    with torch.inference_mode():
        got = model(xt)
    if not selective:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_state_dict_mapping_matches_jax_export():
    """Key for key and array for array, the JAX package's own torch export."""
    _, variables = jax_variables("UNet_B", True)
    want = variables_to_torch_state_dict(variables)
    got = state_dict_from_jax_variables(variables)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_state_dict_keys_are_the_reference_names():
    model = build_model("UNet_B", selective=True)
    keys = set(model.state_dict())
    for k in ("encoder_layer_1_1.0.weight", "encoder_layer_1_1.1.running_var",
              "decoder_layer_1_1.1.num_batches_tracked", "unpool3.weight",
              "conv1x1.weight", "conv_select.bias", "conv_aux.weight"):
        assert k in keys
    assert tuple(model.unpool3.weight.shape) == (512, 256, 2, 2)  # torch (in, out, kh, kw)


def test_bfloat16_forward_tracks_float32(rng):
    """compute_dtype='bfloat16' runs under autocast with float32 params and
    returns float32 heads close to the float32 forward (bf16 has 8 mantissa
    bits: tolerance 0.1 of the logits' scale)."""
    torch.manual_seed(0)
    f32 = build_model("UNet_B", selective=True, compute_dtype="float32")
    b16 = build_model("UNet_B", selective=True, compute_dtype="bfloat16")
    b16.load_state_dict(f32.state_dict())
    x = torch.from_numpy(rng.standard_normal((1, 3, 16, 16)).astype(np.float32))
    with torch.inference_mode():
        want, got = f32(x), b16(x)
    assert all(p.dtype == torch.float32 for p in b16.parameters())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 0.1 * float(w.abs().max()) + 1e-3


def test_load_weights_rejects_a_foreign_state_dict():
    model = build_model("UNet_B", selective=True)
    sd = build_model("UNet_B", selective=False).state_dict()
    with pytest.raises(KeyError, match="conv_select"):
        load_weights(model, sd)
    # a selective checkpoint into a non-selective model: the extra heads are
    # ignored, as the JAX package ignores unused parameters
    load_weights(build_model("UNet_B", selective=False), model.state_dict())


def test_unknown_arch_and_dtype_raise():
    with pytest.raises(ValueError, match="model_arch"):
        build_model("UNet_C")
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model("UNet_B", compute_dtype="float16")


def test_conv_macs_counts_every_unetb_layer():
    """The profiler's FLOP table: 14 conv3x3, 3 k2s2 transposed convs and 3
    heads; at 32x32 the 3x3 convs cost 1/64 of their 256x256 count, which is
    35,144,073,216 MACs (70.288 GFLOP) per patch."""
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        conv_macs, seeded_model)

    rows = conv_macs(seeded_model(0, "float32"), 32, 32)
    kinds = [kind for _, kind, _ in rows]
    assert (kinds.count("conv3x3"), kinds.count("convT2x2"), kinds.count("conv1x1")) == (14, 3, 3)
    macs = {k: sum(m for _, kind, m in rows if kind == k) for k in set(kinds)}
    assert macs["conv3x3"] * 64 == 35_144_073_216
    assert macs["convT2x2"] == sum(h * h * cin * 4 * cout for h, cin, cout in
                                   ((4, 512, 256), (8, 256, 128), (16, 128, 64)))
