"""The port's serving ``Predictor`` against the JAX package's, on the same
checkpoint file, in float32 on the CPU.

Masks may differ only at pixels whose JAX probability lies within 1e-5 of a
cut-off; those pixels are counted and the count is the allowance.
``prob_u8`` may differ only where ``prob * 255`` lies within 1e-3 of a half
integer (the rounding there depends on the last bits of the probability).
"""

import threading

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.predictor import (
    Predictor as JaxPredictor)
from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model

NEAR = 1e-5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_predictor") / "model_epoch1.pth")
    torch.save({"net": seeded_model(11, "float32", selective=True).state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(12).integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_out(ckpt, images):
    p = JaxPredictor(ckpt, selective=True, compute_dtype="float32")
    return {"full": p.predict(images),
            "compact": {wp: p.predict_compact(images, want_prob=wp) for wp in (True, False)}}


@pytest.fixture(scope="module")
def port(ckpt):
    return Predictor(ckpt, selective=True, compute_dtype="float32", device="cpu")


def _masks_agree(got, want_prob, want, cut=0.5):
    """Masks equal off the cut-off's neighbourhood; returns the allowance."""
    near = np.abs(want_prob.astype(np.float64) - cut) < NEAR
    assert np.array_equal(got[~near], want[~near])
    assert 0 < got.mean() < 1
    return int(near.sum())


@pytest.mark.parametrize("fold_bn", [True, False], ids=["folded", "unfolded"])
def test_predict_matches_jax(ckpt, images, jax_out, fold_bn):
    got = Predictor(ckpt, selective=True, compute_dtype="float32", fold_bn=fold_bn,
                    device="cpu").predict(images)
    want = jax_out["full"]
    assert set(got) == set(want) == {"prob", "pred", "selection_prob", "selection"}
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == (2, 40, 48), k
    np.testing.assert_allclose(got["prob"], want["prob"], rtol=0, atol=NEAR)
    np.testing.assert_allclose(got["selection_prob"], want["selection_prob"], rtol=0, atol=NEAR)
    allowance = _masks_agree(got["pred"], want["prob"], want["pred"])
    allowance += _masks_agree(got["selection"], want["selection_prob"], want["selection"])
    assert allowance <= 4, allowance  # the comparison stays tight


@pytest.mark.parametrize("want_prob", [True, False], ids=["prob", "masks_only"])
def test_predict_compact_matches_jax_and_predict(port, images, jax_out, want_prob):
    got = port.predict_compact(images, want_prob=want_prob)
    want = jax_out["compact"][want_prob]
    full = jax_out["full"]
    keys = {"pred", "selection"} | ({"prob_u8", "selection_prob_u8"} if want_prob else set())
    assert set(got) == set(want) == keys
    assert all(v.dtype == np.uint8 for v in got.values())
    _masks_agree(got["pred"], full["prob"], want["pred"])
    _masks_agree(got["selection"], full["selection_prob"], want["selection"])
    # the masks are predict()'s, bit for bit
    mine = port.predict(images)
    assert np.array_equal(got["pred"], mine["pred"])
    assert np.array_equal(got["selection"], mine["selection"])
    if want_prob:
        for key, prob in (("prob_u8", "prob"), ("selection_prob_u8", "selection_prob")):
            scaled = full[prob].astype(np.float64) * 255.0
            tie = np.abs(scaled - np.floor(scaled) - 0.5) < 1e-3
            assert np.array_equal(got[key][~tie], want[key][~tie]), key
            assert np.abs(got[key].astype(int) - np.round(mine[prob] * 255)).max() <= 1


def test_predict_wsi_matches_jax_and_reuses_its_forward(ckpt, port):
    img = np.random.default_rng(13).integers(0, 256, (136, 48, 3), dtype=np.uint8)
    got = port.predict_wsi(img, tile=(16, 48), batch_size=4)
    apply_fn = port._tiled_apply
    want = JaxPredictor(ckpt, selective=True, compute_dtype="float32").predict_wsi(
        img, tile=(16, 48), batch_size=4)
    assert set(got) == set(want) == {"prob", "pred", "selection"}
    np.testing.assert_allclose(got["prob"], want["prob"], rtol=0, atol=NEAR)
    _masks_agree(got["pred"], want["prob"], want["pred"])
    # the selection mask against the port's own whole-image selection probability
    sel_prob = port.predict(img[None])["selection_prob"][0]
    near = np.abs(sel_prob - 0.5) < 1e-4
    assert np.array_equal(got["selection"][~near], want["selection"][~near])
    port.predict_wsi(img[:64], tile=(32, 48))
    assert port._tiled_apply is apply_fn  # one forward wrapper for the lifetime


def test_float_and_uint8_inputs_agree(port, images):
    as_u8 = port.predict(images)["prob"]
    as_float = port.predict(images.astype(np.float32) / 255.0)["prob"]
    np.testing.assert_allclose(as_float, as_u8, rtol=0, atol=1e-5)


def test_ce_head_predictor_matches_jax(tmp_path):
    path = str(tmp_path / "model_epoch1.pth")
    torch.save({"net": seeded_model(14, "float32", False, "UNet", 3).state_dict()}, path)
    x = np.random.default_rng(15).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    kw = dict(model_arch="UNet", n_cls=3, selective=False, compute_dtype="float32")
    got = Predictor(path, device="cpu", **kw).predict(x)
    want = JaxPredictor(path, **kw).predict(x)
    assert set(got) == set(want) == {"prob", "pred"}
    np.testing.assert_allclose(got["prob"], want["prob"], rtol=0, atol=NEAR)
    assert (got["pred"] != want["pred"]).mean() < 1e-3 and got["pred"].max() <= 2


def test_bf16_predict_returns_float32_probabilities_as_jax_does(ckpt, images):
    """Both packages cast the heads to float32 before the sigmoid, so the
    bf16 graphs return float32 probabilities on both sides."""
    got = Predictor(ckpt, selective=True, device="cpu").predict(images[:1])
    want = JaxPredictor(ckpt, selective=True).predict(images[:1])
    for k in ("prob", "selection_prob"):
        assert got[k].dtype == want[k].dtype == np.float32
    assert np.abs(got["prob"] - want["prob"]).max() < 0.05  # bf16 rounds elsewhere


def test_methods_run_from_another_thread(port, images):
    """inference_mode is thread-local: the server's worker thread calls
    the Predictor."""
    want = port.predict(images)
    got = {}
    t = threading.Thread(target=lambda: got.update(port.predict(images)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("option", ["int8", "calibration"])
def test_int8_options_calibrate_like_jax(ckpt, port, images, option):
    """The int8 options, refused until the int8 path was ported.
    ``quantize="int8"``: the first ``predict`` calibrates the activation
    scales, and they are JAX's within 1e-5 relative (JAX's Predictor on the
    same file and images; each package folds the BN on its own, and the
    absmax of the deepest layers comes through up to 14 float32 convs of
    He-normal weights: 1.0e-6 to 1.4e-6 measured on three seeds).
    ``calibration_images`` without it is ignored, as
    JAX ignores it. tests/test_torch_quant.py holds the int8 outputs to
    JAX's."""
    from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
        act_scales_from_jax)

    if option == "calibration":
        got = Predictor(ckpt, selective=True, compute_dtype="float32", device="cpu",
                        calibration_images=images).predict(images)
        want = port.predict(images)
        assert all(np.array_equal(got[k], want[k]) for k in want)
        return
    p = Predictor(ckpt, selective=True, compute_dtype="float32", quantize="int8", device="cpu")
    p.predict(images)
    j = JaxPredictor(ckpt, selective=True, compute_dtype="float32", quantize="int8")
    j.predict(images)
    want = act_scales_from_jax(j._act_scales)
    assert set(p._act_scales) == set(want) and len(want) == 14
    for k, v in p._act_scales.items():
        assert v == pytest.approx(want[k], rel=1e-5), k


def test_unported_methods_and_bad_options_raise(ckpt, port):
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        port.predict_wsi(np.zeros((64, 64, 3), np.uint8), mesh=object())
    with pytest.raises(ValueError, match="unknown quantize"):
        Predictor(ckpt, device="cpu", quantize="fp8")


def test_no_device_and_no_card_raises(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Predictor(ckpt, selective=True)
