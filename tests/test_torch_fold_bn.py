"""BatchNorm folding (``ops/fold_bn.py``) and the folded serving trunk
(``build_model(..., folded=True)``) against the JAX package's.

The weights are He-normal with seeded, non-trivial BN statistics
(``tools/synthetic.seeded_model``), carried to the JAX layout by the JAX
package's own importer. Folding on each side must give the same weights;
the port's folded forward must match its unfolded eval forward and the JAX
folded forward within the JAX test's bound (rtol 1e-3, atol 1e-4), in
float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.models import (
    build_model as jax_build_model)
from selectivenet_for_semantic_segmentation_binary_tpu.ops.fold_bn import (
    fold_batchnorm as jax_fold_batchnorm)
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch.models import (
    FoldedCBR, build_model, load_weights)
from selectivenet_for_semantic_segmentation_binary_torch.ops.fold_bn import fold_batchnorm
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model
from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
    state_dict_from_jax_variables)

# (model_arch, n_cls, selective): the selective UNet_B and the CE UNet
ARCHS = [("UNet_B", 2, True), ("UNet", 3, False)]
IDS = ["UNet_B-selective", "UNet-ce3"]


def _state(arch, n_cls, selective, seed=3):
    sd = seeded_model(seed, "float32", selective, arch, n_cls).state_dict()
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def case(request):
    arch, n_cls, selective = request.param
    sd = _state(arch, n_cls, selective)
    x = np.random.default_rng(4).random((2, 32, 40, 3)).astype(np.float32)
    return arch, n_cls, selective, sd, x


def _port_forward(arch, n_cls, selective, sd, x, folded):
    model = build_model(arch, n_cls, selective, "float32", folded=folded)
    load_weights(model, sd)
    xt = torch.from_numpy((x - 0.5) / 0.5).permute(0, 3, 1, 2)
    with torch.inference_mode():
        out = model(xt.contiguous(memory_format=torch.channels_last))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def test_folded_weights_match_jax(case):
    """Both packages fold; the JAX-folded tree, carried over by
    state_dict_from_jax_variables (its folded path), equals the port's."""
    _, _, _, sd, _ = case
    mine = fold_batchnorm(sd)
    theirs = state_dict_from_jax_variables(
        jax_fold_batchnorm(torch_state_dict_to_variables({k: v.numpy() for k, v in sd.items()})))
    assert sorted(mine) == sorted(theirs)
    assert not any(".1." in k for k in mine)  # every BN key dropped
    for k in mine:
        np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), rtol=1e-6, atol=0,
                                   err_msg=k)
    # heads and transposed convs pass through untouched; CBR convs change
    for k in mine:
        if k.startswith(("conv1x1", "conv_select", "conv_aux", "unpool")):
            assert torch.equal(mine[k], sd[k]), k
        else:
            assert not torch.equal(mine[k], sd[k]), k


def test_folded_forward_matches_unfolded_and_jax(case):
    arch, n_cls, selective, sd, x = case
    folded = _port_forward(arch, n_cls, selective, fold_batchnorm(sd), x, folded=True)
    unfolded = _port_forward(arch, n_cls, selective, sd, x, folded=False)
    variables = torch_state_dict_to_variables({k: v.numpy() for k, v in sd.items()})
    jax_model = jax_build_model(arch, n_cls, selective, "float32", folded=True)
    jax_out = jax.jit(lambda v, xb: jax_model.apply(v, xb, train=False))(
        jax_fold_batchnorm(variables), jnp.asarray((x - 0.5) / 0.5))
    jax_out = [np.asarray(o) for o in (jax_out if isinstance(jax_out, tuple) else (jax_out,))]
    assert len(folded) == len(unfolded) == len(jax_out)
    for f, u, j in zip(folded, unfolded, jax_out):
        assert f.shape == j.shape
        np.testing.assert_allclose(f, u, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(f, j, rtol=1e-3, atol=1e-4)
    assert np.abs(folded[0]).max() > 1.0  # the logits carry signal


def test_folded_trunk_has_no_batchnorm_and_keeps_the_indices():
    model = build_model("UNet_B", selective=True, folded=True)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert isinstance(model.encoder_layer_1_1, FoldedCBR)
    assert sorted(model.encoder_layer_1_1.state_dict()) == ["0.bias", "0.weight"]
    assert sorted(model.state_dict()) == sorted(fold_batchnorm(_state("UNet_B", 2, True)))


def test_folded_and_fused_are_exclusive():
    with pytest.raises(ValueError, match="folded serving graph and fused training trunk "
                                         "are exclusive"):
        build_model("UNet_B", folded=True, fused=True)


def test_load_weights_tells_folded_from_unfolded():
    sd = _state("UNet_B", 2, True)
    with pytest.raises(KeyError, match="folded=True"):
        load_weights(build_model("UNet_B", selective=True), fold_batchnorm(sd))
    with pytest.raises(KeyError, match="fold_batchnorm"):
        load_weights(build_model("UNet_B", selective=True, folded=True), sd)
