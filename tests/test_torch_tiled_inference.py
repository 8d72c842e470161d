"""Tiled whole-slide inference (``tools/tiled_inference.py``) of the port:
equal to the whole-image forward, and to the JAX package's ``wsi_mask`` on
the same weights, in float32 on the CPU.

Window origins are clamped into the image and aligned to the pool grid, so
tiles are exact; the images below are sized so that windows start at
several origins (with halo 56 a window is tile + 112 pixels).
"""

import jax
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.models import (
    build_model as jax_build_model)
from selectivenet_for_semantic_segmentation_binary_tpu.tools.tiled_inference import (
    _tumor_prob as jax_tumor_prob, wsi_mask as jax_wsi_mask)
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model
from selectivenet_for_semantic_segmentation_binary_torch.tools.tiled_inference import (
    DEFAULT_HALO, _window_origin, tiled_inference, wsi_mask)

NEAR = 1e-5  # probability distance to a cut-off where masks may differ


@pytest.fixture(scope="module")
def selective_model():
    return seeded_model(5, "float32", selective=True)


def _apply(model):
    def fn(batch):
        with torch.inference_mode():
            return model(((batch - 0.5) / 0.5).permute(0, 3, 1, 2))
    return fn


def _whole(model, img):
    out = _apply(model)(img[None])
    return [o[0].numpy() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("shape,tile,batch", [
    ((192, 64), (32, 64), 4),    # six windows at five row origins, a ragged last batch
    ((184, 136), (48, 40), 8),   # remainder chunks in both dims
    ((64, 64), (512, 512), 8),   # a single window larger than the image
], ids=["origins", "remainders", "single_window"])
def test_tiled_equals_whole_image(selective_model, shape, tile, batch):
    img = torch.from_numpy(np.random.default_rng(6).random(shape + (3,)).astype(np.float32))
    full = _whole(selective_model, img)
    tiled = tiled_inference(_apply(selective_model), img, tile=tile, batch_size=batch)
    assert isinstance(tiled, tuple) and len(tiled) == 3
    for f, t in zip(full, tiled):
        assert t.shape == shape and t.dtype == np.float32
        np.testing.assert_allclose(t, f, rtol=1e-5, atol=1e-5)


def test_window_origins_are_clamped_and_on_the_grid():
    win = 32 + 2 * DEFAULT_HALO
    origins = [_window_origin(r0, DEFAULT_HALO, win, 192) for r0 in range(0, 192, 32)]
    assert origins == [0, 0, 8, 40, 48, 48]
    assert all(o % 8 == 0 and 0 <= o <= 192 - win for o in origins)


@pytest.mark.parametrize("arch,n_cls,selective", [("UNet", 3, False), ("UNet_B", 2, False)],
                         ids=["ce_channels_kept", "bare_map"])
def test_plain_models_keep_their_shape(arch, n_cls, selective):
    model = seeded_model(7, "float32", selective, arch, n_cls)
    img = torch.from_numpy(np.random.default_rng(8).random((128, 64, 3)).astype(np.float32))
    full = _whole(model, img)[0]
    tiled = tiled_inference(_apply(model), img, tile=(16, 64), batch_size=8)
    assert not isinstance(tiled, tuple)
    assert tiled.shape == full.shape == (128, 64) + ((n_cls,) if arch == "UNet" else ())
    np.testing.assert_allclose(tiled, full, rtol=1e-5, atol=1e-5)


def test_rejects_bad_halo_dims_and_mesh(selective_model):
    img = torch.zeros((64, 64, 3))
    with pytest.raises(ValueError, match="halo"):
        tiled_inference(_apply(selective_model), img, halo=16)
    with pytest.raises(ValueError, match="divisible"):
        tiled_inference(_apply(selective_model), torch.zeros((65, 64, 3)))
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tiled_inference(_apply(selective_model), img, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        wsi_mask(selective_model, np.zeros((64, 64, 3), np.uint8), mesh=object())


@pytest.mark.parametrize("arch,n_cls", [("UNet_B", 2), ("UNet", 2)], ids=["UNet_B", "UNet-ce"])
def test_wsi_mask_matches_jax(arch, n_cls):
    """A uint8 slide through both packages' wsi_mask (halo 52: windows of
    120 rows at origins 0 and 8)."""
    model = seeded_model(9, "float32", True, arch, n_cls)
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    img = np.random.default_rng(10).integers(0, 256, (128, 32, 3), dtype=np.uint8)
    kw = dict(selective=True, cut_off=0.5, s_cut_off=0.5, tile=(16, 32), halo=52,
              batch_size=8)
    got = wsi_mask(model, img, **kw)
    jax_model = jax_build_model(arch, n_cls, True, "float32")
    variables = jax.device_get(torch_state_dict_to_variables(sd))
    want = jax_wsi_mask(jax_model, variables, img, **kw)
    assert set(got) == set(want) == {"prob", "pred", "selection"}
    np.testing.assert_allclose(got["prob"], want["prob"], rtol=0, atol=NEAR)
    near = np.abs(want["prob"] - 0.5) < NEAR
    assert np.array_equal(got["pred"][~near], want["pred"][~near])
    assert got["pred"].dtype == np.uint8 and 0 < got["pred"].mean() < 1
    # the selection head's JAX probability, from the whole-image forward
    sel = np.asarray(jax_model.apply(variables, ((img / 255.0 - 0.5) / 0.5)[None],
                                     train=False)[1][0])
    sel_prob = jax_tumor_prob(sel)
    near_sel = np.abs(sel_prob - 0.5) < NEAR
    assert np.array_equal(got["selection"][~near_sel], want["selection"][~near_sel])
    assert 0 < got["selection"].mean() < 1
