"""The port's stain conversions (``data/stain.py``) against the JAX
package's: bit-equal (``np.array_equal``, dtype included) on seeded float32
RGB images in [0, 1], with the cube's corners, all-black (the 1e-6 clamp)
and all-white pixels among them."""

import numpy as np
import pytest

from selectivenet_for_semantic_segmentation_binary_tpu.data import stain as jax_stain
from selectivenet_for_semantic_segmentation_binary_torch.data import stain


def _image(seed: int, shape=(16, 24)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.random(shape + (3,)).astype(np.float32)
    corners = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], np.float32)
    img[0, :8] = corners
    img[1, :3] = np.round(img[1, :3] * 255) / 255  # decoded-byte values
    return img


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["RGB2GH", "H_RGB", "separate_stains"])
def test_conversions_are_bit_equal_to_jax(fn, seed):
    img = _image(seed)
    _same(getattr(stain, fn)(img), getattr(jax_stain, fn)(img))


@pytest.mark.parametrize("seed", [0, 1])
def test_combine_stains_is_bit_equal_to_jax(seed):
    hed = jax_stain.separate_stains(_image(seed))
    _same(stain.combine_stains(hed), jax_stain.combine_stains(hed))


def test_constants_and_matrices_equal_jax():
    assert stain.H_MIN == jax_stain.H_MIN and stain.H_MAX == jax_stain.H_MAX
    _same(stain.rgb_from_hed, jax_stain.rgb_from_hed)
    _same(stain.hed_from_rgb, jax_stain.hed_from_rgb)
    # the reference's mined constants (data_utils.py:23-24)
    assert round(stain.H_MIN, 8) == -0.66781543 and round(stain.H_MAX, 8) == 1.87798274


def test_gh_has_two_channels_in_unit_range():
    gh = stain.RGB2GH(_image(3))
    assert gh.shape == (16, 24, 2) and gh.dtype == np.float32
    assert gh.min() >= 0.0 and gh.max() <= 1.0
