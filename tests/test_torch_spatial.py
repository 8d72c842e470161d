"""The port's spatial forward (``parallel/spatial.py``) against the JAX
package's, on the CPU.

The JAX functions run on the conftest's 8 virtual CPU devices; the port's
on a ``Mesh`` (or ``Mesh2D``) of CPU entries. Both take the same weights:
a JAX selective UNet_B with its BN statistics moved away from the identity
(as JAX tests/test_spatial.py perturbs them), carried into the port's
model by ``utils/checkpoint.state_dict_from_jax_variables``. The cases are
JAX tests/test_spatial.py's, at 16-pixel-wide images, each within JAX's
bound (rtol/atol 1e-4) in float32:

* the 1-D forward over 2, 4 and 8 row blocks, selective; the plain head;
  the BN-folded model; the 2-D forward at (2, 2) and (2, 4); each also
  against the port's own unsharded forward;
* bf16 against JAX's bf16 spatial forward, within the port's bf16 model
  bound (0.1 of the logits' scale, tests/test_torch_model.py);
* the refusals, with JAX's messages;
* the outputs gathered on the mesh's first entry (JAX returns them sharded
  on H, which PyTorch has no counterpart for: a deliberate difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.models import UNetB as JaxUNetB
from selectivenet_for_semantic_segmentation_binary_tpu.ops.fold_bn import (
    fold_batchnorm as jax_fold_batchnorm)
from selectivenet_for_semantic_segmentation_binary_tpu.parallel import make_mesh as jax_make_mesh
from selectivenet_for_semantic_segmentation_binary_tpu.parallel.spatial import (
    make_mesh_2d as jax_make_mesh_2d, spatial_forward as jax_spatial_forward,
    spatial_forward_2d as jax_spatial_forward_2d)
from selectivenet_for_semantic_segmentation_binary_torch.models import build_model, load_weights
from selectivenet_for_semantic_segmentation_binary_torch.parallel import (
    make_mesh_2d, spatial_forward, spatial_forward_2d)
from selectivenet_for_semantic_segmentation_binary_torch.parallel.mesh import Mesh, Mesh2D
from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
    state_dict_from_jax_variables)

TOL = dict(rtol=1e-4, atol=1e-4)  # JAX tests/test_spatial.py's bound
WIDTH = 16
CPU = torch.device("cpu")


def _perturb_bn(stats, rng):
    for k, v in stats.items():
        if k == "bn":
            v["mean"] = 0.2 * rng.standard_normal(v["mean"].shape).astype(np.float32)
            v["var"] = (1.0 + 0.2 * rng.random(v["var"].shape)).astype(np.float32)
        elif isinstance(v, dict):
            _perturb_bn(v, rng)


def _jax_variables(selective: bool, seed: int):
    model = JaxUNetB(selective=selective)
    variables = jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)),
                                          train=False))
    _perturb_bn(variables["batch_stats"], np.random.default_rng(seed))
    return variables


def _port_model(variables, selective: bool, folded: bool = False,
                compute_dtype: str = "float32"):
    model = build_model("UNet_B", selective=selective, folded=folded,
                        compute_dtype=compute_dtype)
    return load_weights(model, state_dict_from_jax_variables(variables))


@pytest.fixture(scope="module")
def selective():
    variables = _jax_variables(True, 0)
    return variables, _port_model(variables, True)


def _input(shape, seed=0):
    """(N, H, W, 3) float32 for JAX and the same as (N, 3, H, W) channels_last."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, tol=TOL):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device == CPU
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _unsharded(model, x):
    with torch.no_grad():
        return model(x)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_1d_matches_jax_and_the_unsharded_forward(selective, n_dev):
    variables, model = selective
    x, xt = _input((2, 16 * n_dev, WIDTH, 3), n_dev)
    got = spatial_forward(model, xt, Mesh((CPU,) * n_dev))
    _close(got, jax_spatial_forward(variables, jnp.asarray(x), jax_make_mesh(n_dev),
                                    selective=True))
    _close(got, _unsharded(model, xt))
    assert got[0].shape == (2, 16 * n_dev, WIDTH)


def test_plain_head(rng):
    variables = _jax_variables(False, 1)
    model = _port_model(variables, False)
    x, xt = _input((1, 64, WIDTH, 3), 1)
    got = spatial_forward(model, xt, Mesh((CPU,) * 4))
    assert torch.is_tensor(got) and got.shape == (1, 64, WIDTH)
    _close(got, jax_spatial_forward(variables, jnp.asarray(x), jax_make_mesh(4)))
    _close(got, _unsharded(model, xt))


def test_folded_model(selective):
    variables, _ = selective
    folded = {"params": jax_fold_batchnorm(variables)["params"]}
    model = _port_model(folded, True, folded=True)
    x, xt = _input((1, 64, WIDTH, 3), 2)
    got = spatial_forward(model, xt, Mesh((CPU,) * 4))
    _close(got, jax_spatial_forward(folded, jnp.asarray(x), jax_make_mesh(4), selective=True))
    _close(got, _unsharded(model, xt))


@pytest.mark.parametrize("dp,sp", [(2, 2), (2, 4)])
def test_2d_matches_jax_and_the_unsharded_forward(selective, dp, sp):
    variables, model = selective
    x, xt = _input((2 * dp, 16 * sp, WIDTH, 3), 10 * dp + sp)
    mesh = make_mesh_2d(dp, sp, device="cpu")
    assert mesh.shape == {"data": dp, "spatial": sp} and mesh.size == dp * sp
    got = spatial_forward_2d(model, xt, mesh)
    _close(got, jax_spatial_forward_2d(variables, jnp.asarray(x), jax_make_mesh_2d(dp, sp),
                                       selective=True))
    _close(got, _unsharded(model, xt))
    assert got[0].shape == (2 * dp, 16 * sp, WIDTH)


def test_bfloat16_matches_jax_bfloat16(selective):
    """The port's bf16 model (autocast) against JAX's ``compute_dtype=bf16``
    spatial forward, within 0.1 of the logits' scale (the port's bf16 model
    bound); each also near its own float32 forward."""
    variables, model32 = selective
    model = _port_model(variables, True, compute_dtype="bfloat16")
    x, xt = _input((1, 32, WIDTH, 3), 3)
    got = spatial_forward(model, xt, Mesh((CPU,) * 2))
    want = jax_spatial_forward(variables, jnp.asarray(x), jax_make_mesh(2), selective=True,
                               compute_dtype=jnp.bfloat16)
    f32 = spatial_forward(model32, xt, Mesh((CPU,) * 2))
    for g, w, f in zip(got, want, f32):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32
        assert float(np.abs(g.numpy() - w).max()) <= 0.1 * float(np.abs(w).max()) + 1e-3
        assert float((g - f).abs().max()) <= 0.1 * float(f.abs().max()) + 1e-3
        assert not torch.equal(g, f)  # bf16, not silently float32


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


def test_refusals_carry_jax_messages(selective):
    variables, model = selective
    x72 = np.zeros((1, 72, 64, 3), np.float32)
    assert _message(spatial_forward, model, torch.from_numpy(x72).permute(0, 3, 1, 2),
                    Mesh((CPU,) * 8)) == _message(jax_spatial_forward, variables,
                                                  jnp.asarray(x72), jax_make_mesh(8))
    port2d, jax2d = make_mesh_2d(2, 4, device="cpu"), jax_make_mesh_2d(2, 4)
    for shape in ((3, 64, 64, 3), (2, 48, 64, 3)):
        xs = np.zeros(shape, np.float32)
        assert (_message(spatial_forward_2d, model, torch.from_numpy(xs).permute(0, 3, 1, 2),
                         port2d)
                == _message(jax_spatial_forward_2d, variables, jnp.asarray(xs), jax2d))
    x64 = np.zeros((2, 64, 64, 3), np.float32)
    want = _message(jax_spatial_forward_2d, variables, jnp.asarray(x64), jax_make_mesh(4))
    got = _message(spatial_forward_2d, model, torch.from_numpy(x64).permute(0, 3, 1, 2),
                   Mesh((CPU,) * 4))
    assert "mesh axes must be (data, spatial), got ('data',)" == got == want


def test_make_mesh_2d_needs_the_cards():
    """JAX's "need n devices" refusal, here without a card; with
    ``device="cpu"`` a grid of CPU entries, row-major."""
    with pytest.raises(ValueError, match=r"need 9 devices, have 8"):
        jax_make_mesh_2d(3, 3)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=rf"need {n + 1} devices, have {n}"):
        make_mesh_2d(1, n + 1)
    assert make_mesh_2d(2, 3, device="cpu") == Mesh2D(((CPU,) * 3,) * 2)
    assert Mesh((CPU,)).axis_names == ("data",)


def test_weights_are_read_in_place_and_modes_kept(selective):
    """The model's own parameters run the forward (a change to them shows at
    once), train mode is restored after the eval-mode forward, and the
    running statistics do not move."""
    variables, _ = selective
    model = _port_model(variables, True).train()
    x, xt = _input((1, 32, WIDTH, 3), 4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    first = spatial_forward(model, xt, Mesh((CPU,) * 2))
    assert model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        model.conv1x1.bias.add_(1.0)
    second = spatial_forward(model, xt, Mesh((CPU,) * 2))
    torch.testing.assert_close(second[0], first[0] + 1.0, rtol=0, atol=1e-5)
    torch.testing.assert_close(second[1], first[1], rtol=0, atol=0)
