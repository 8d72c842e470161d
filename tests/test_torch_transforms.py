"""The port's host transforms (``data/transforms.py``) against the JAX
package's: each transform, and ``Compose`` in the train and eval feeds'
orders, bit-equal (``np.array_equal``, dtype included) under generators of
the same ``default_rng`` seed; the generators are left in the same state.
Inputs: seeded float32 RGB and GH (2 channels) images with 2-D uint8
labels, as the dataset gives them."""

import numpy as np
import pytest

from selectivenet_for_semantic_segmentation_binary_tpu.data import stain as jax_stain
from selectivenet_for_semantic_segmentation_binary_tpu.data import transforms as J
from selectivenet_for_semantic_segmentation_binary_torch.data import transforms as P

SIZE = 16


def _data(seed: int, gh: bool):
    rng = np.random.default_rng(100 + seed)
    img = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    if gh:
        img = jax_stain.RGB2GH(img)
    lab = (rng.random((SIZE, SIZE)) > 0.5).astype(np.uint8)
    return {"id": f"s{seed}", "input": img, "label": lab}


def _copy(d):
    return {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in d.items()}


def _run(make, seed, gh, draw_seed):
    out = {}
    for side, mod in (("jax", J), ("port", P)):
        rng = np.random.default_rng(draw_seed)
        out[side] = (make(mod)(_copy(_data(seed, gh)), rng), rng.random())
    return out


def _same(out):
    (want, want_next), (got, got_next) = out["jax"], out["port"]
    assert got_next == want_next  # the generators drew alike
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k]


TRANSFORMS = {
    "Normalization": lambda m: m.Normalization(0.5, 0.5),
    "RandomFlip": lambda m: m.RandomFlip(),
    "PartialNonTissue": lambda m: m.PartialNonTissue(),
    "BlankfieldCorrection": lambda m: m.BlankfieldCorrection(),
    "ToArray": lambda m: m.ToArray(),
    "train_feed": lambda m: m.Compose([m.BlankfieldCorrection(), m.PartialNonTissue(),
                                       m.Normalization(0.5, 0.5), m.RandomFlip(),
                                       m.ToArray()]),
    "eval_feed": lambda m: m.Compose([m.BlankfieldCorrection(), m.Normalization(0.5, 0.5),
                                      m.ToArray()]),
}


@pytest.mark.parametrize("gh", [False, True], ids=["RGB", "GH"])
@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_is_bit_equal_to_jax(name, gh):
    for seed in range(8):  # PNT fires with p 1/4, the flips with 1/2 each
        _same(_run(TRANSFORMS[name], seed, gh, draw_seed=seed))


def test_pnt_overwrites_a_quadrant_of_a_2d_label():
    """Among the seeds, PNT fires: one quadrant of the input becomes ~0.96
    and that quadrant of the 2-D label becomes 0, in both packages."""
    fired = 0
    for seed in range(16):
        out = _run(TRANSFORMS["PartialNonTissue"], seed, False, draw_seed=seed)
        _same(out)
        got = out["port"][0]
        changed = ~np.all(got["input"] == _data(seed, False)["input"], axis=-1)
        if changed.any():
            fired += 1
            assert changed.sum() == (SIZE // 2) ** 2 and got["label"].ndim == 2
            assert np.all(got["label"][changed] == 0)
            assert np.abs(got["input"][changed] - 0.96).max() < 0.05
    assert 0 < fired < 16


def test_blankfield_works_per_channel_on_gh():
    data = _data(5, gh=True)
    got = P.BlankfieldCorrection()(_copy(data), None)["input"]
    white = np.maximum(np.percentile(data["input"].reshape(-1, 2), 95.0, axis=0), 0.5)
    assert got.shape == (SIZE, SIZE, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.clip(data["input"] / white, 0, 1).astype(np.float32))


def test_flips_come_after_pnt_in_the_train_order():
    """The train feed's RandomFlip draws after PNT's draws, so its flips
    differ from the raw feed's bits ``rng.random(2) > 0.5`` for the same
    generator: the order JAX has, kept."""
    differs = 0
    for seed in range(8):
        rng = np.random.default_rng(seed)
        bits = rng.random(2) > 0.5
        rng = np.random.default_rng(seed)
        P.PartialNonTissue()(_data(seed, False), rng)
        differs += (rng.random(2) > 0.5).tolist() != bits.tolist()
    assert differs > 0
