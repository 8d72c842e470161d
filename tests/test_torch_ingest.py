"""The port's serving ingest (``ops/ingest.py``) against the JAX package's.

``normalize_raw`` must equal the JAX function bit for bit on every byte
value, not only within the JAX test's one-ulp bound against the host's
division; ``device_ingest`` keeps uint8 as uint8 (one byte a pixel to the
card); the eval and train steps normalise with the same function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.ops import ingest as jax_ingest
from selectivenet_for_semantic_segmentation_binary_torch.ops.ingest import (
    device_ingest, normalize_raw, to_unit_float)
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import device_preprocess

ALL_BYTES = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)


def test_normalize_raw_is_bit_equal_to_jax_on_every_byte():
    got = normalize_raw(torch.from_numpy(ALL_BYTES)).numpy()
    want = np.asarray(jax_ingest.normalize_raw(jnp.asarray(ALL_BYTES)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # within one ulp of the host's true division, as the JAX test bounds it
    host = (ALL_BYTES.astype(np.float32) / np.float32(255.0) - 0.5) / 0.5
    assert np.abs(got - host).max() <= np.spacing(np.float32(1.0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_input_passes_through_in_float32(dtype):
    x = np.random.default_rng(0).random((2, 8, 8, 3)).astype(dtype)
    got = normalize_raw(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_ingest.normalize_raw(jnp.asarray(x.astype(np.float32))))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,want", [(np.uint8, torch.uint8), (np.float64, torch.float32),
                                        (np.float32, torch.float32), (np.int32, torch.float32)])
def test_device_ingest_keeps_uint8_and_lands_the_rest_as_float32(dtype, want):
    x = (np.random.default_rng(1).random((3, 8, 8, 3)) * 255).astype(dtype)
    t = device_ingest(x, "cpu")
    assert t.dtype == want and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), x.astype(t.numpy().dtype))
    # a tensor goes through as well, and a non-contiguous array is copied
    assert device_ingest(torch.from_numpy(np.ascontiguousarray(x)), "cpu").dtype == want
    assert device_ingest(x[:, ::2], "cpu").shape == (3, 4, 8, 3)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_to_unit_float_matches_jax(dtype):
    x = ALL_BYTES if dtype == np.uint8 else ALL_BYTES.astype(np.float32) / 255.0
    got, want = to_unit_float(x), jax_ingest.to_unit_float(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_device_preprocess_normalises_with_normalize_raw():
    """The eval and train steps share the serving ingest's expression."""
    raw = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    x, _ = device_preprocess({"input": torch.from_numpy(raw),
                              "label": torch.zeros((2, 8, 8), dtype=torch.uint8)})
    want = normalize_raw(torch.from_numpy(raw)).permute(0, 3, 1, 2)
    assert torch.equal(x, want)
    assert x.is_contiguous(memory_format=torch.channels_last)
