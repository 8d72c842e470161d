"""The port's MC-dropout uncertainty (``tools/uncertainty.py``,
``Predictor.predict_with_uncertainty``, ``snet-predict --uncertainty``)
against the JAX package's, in float32 on the CPU.

The masks come from a ``torch.Generator``, not from JAX's keys, so at a
rate above 0 the maps agree with JAX's in distribution only: there the
outputs are held in keys, shapes and dtypes, and to their own properties
(seeded, variance > 0). The aggregation is held to ``jnp.mean`` /
``jnp.var`` on a given stack (``AGG_TOL``: float32 rounding of a T-term
mean), and at rate 0, where every forward is the eval forward, the maps
to JAX's within 1e-5 with variance exactly 0.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.predictor import (
    Predictor as JaxPredictor)
from selectivenet_for_semantic_segmentation_binary_tpu.tools import predict as jax_predict
from selectivenet_for_semantic_segmentation_binary_tpu.tools.uncertainty import (
    mc_uncertainty as jax_mc)
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    load_net_checkpoint as jax_load)
from selectivenet_for_semantic_segmentation_binary_torch import cli
from selectivenet_for_semantic_segmentation_binary_torch.models import build_model, load_weights
from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
from selectivenet_for_semantic_segmentation_binary_torch.tools import predict
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model
from selectivenet_for_semantic_segmentation_binary_torch.tools.uncertainty import (
    aggregate, mc_uncertainty)

PROB_TOL = 1e-5
AGG_TOL = dict(rtol=1e-6, atol=1e-7)
MODELS = {"UNet_B_selective": ("UNet_B", True), "UNet": ("UNet", False)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_uncertainty_ckpt")
    out = {}
    for i, (name, (arch, selective)) in enumerate(MODELS.items()):
        path = str(d / f"{name}.pth")
        torch.save({"net": seeded_model(70 + i, "float32", selective=selective,
                                        model_arch=arch).state_dict()}, path)
        out[name] = path
    return out


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_uncertainty_img") / "tile.png")
    arr = np.random.default_rng(72).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)
    return path


@pytest.mark.parametrize("shape", [(5, 2, 4, 6, 1), (8, 1, 3, 3, 2), (1, 2, 2, 2, 1)])
def test_the_aggregation_is_the_jax_math(shape):
    probs = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    mean, var, conf = aggregate(torch.from_numpy(probs))
    jp = jnp.asarray(probs)
    j_var = jnp.var(jp, axis=0)
    for got, want in ((mean, jnp.mean(jp, axis=0)), (var, j_var),
                      (conf, -jnp.mean(j_var, axis=-1))):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **AGG_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_rate_0_is_the_jax_eval_forward_with_zero_variance(ckpts, name):
    arch, selective = MODELS[name]
    x = np.random.default_rng(73).standard_normal((2, 16, 16, 3)).astype(np.float32)
    want = jax_mc(jax_build_model(arch, 2, selective, "float32"), jax_load(ckpts[name]),
                  jnp.asarray(x), n_iter=3, rng=jax.random.PRNGKey(1), selective=selective)
    model = load_weights(build_model(arch, 2, selective, "float32"),
                         torch.load(ckpts[name])["net"])
    got = mc_uncertainty(model, torch.from_numpy(x).permute(0, 3, 1, 2), n_iter=3,
                         selective=selective)
    assert set(got) == set(want) == {"mean_prob", "variance", "confidence"}
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
    np.testing.assert_allclose(got["mean_prob"].numpy(), np.asarray(want["mean_prob"]),
                               rtol=0, atol=PROB_TOL)
    assert not got["variance"].any() and not got["confidence"].any()


def test_mc_uncertainty_spreads_by_seed(ckpts):
    model = load_weights(build_model("UNet_B", 2, True, "float32", dropout_rate=0.2),
                         torch.load(ckpts["UNet_B_selective"])["net"])
    x = torch.from_numpy(np.random.default_rng(74).standard_normal((1, 3, 16, 16))
                         .astype(np.float32))
    runs = [mc_uncertainty(model, x, n_iter=4, generator=torch.Generator().manual_seed(s),
                           selective=True) for s in (0, 0, 1)]
    default = mc_uncertainty(model, x, n_iter=4, selective=True)  # seed 0
    assert float(runs[0]["variance"].max()) > 0
    assert all(torch.equal(runs[0][k], runs[1][k]) and torch.equal(runs[0][k], default[k])
               for k in runs[0])
    assert not torch.equal(runs[0]["variance"], runs[2]["variance"])
    assert not model.training
    with pytest.raises(ValueError, match="n_iter"):
        mc_uncertainty(model, x, n_iter=0)


@pytest.mark.parametrize("fold_bn", [True, False], ids=["folded", "unfolded"])
def test_predict_with_uncertainty_matches_jax_in_form(ckpts, fold_bn):
    path = ckpts["UNet_B_selective"]
    images = np.random.default_rng(75).integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    want = JaxPredictor(path, selective=True, compute_dtype="float32", fold_bn=fold_bn,
                        dropout_rate=0.1).predict_with_uncertainty(images, n_iter=3, seed=2)
    p = Predictor(path, selective=True, compute_dtype="float32", fold_bn=fold_bn,
                  dropout_rate=0.1, device="cpu")
    got = p.predict_with_uncertainty(images, n_iter=3, seed=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == want[k].shape
    assert got["mean_prob"].shape == (2, 16, 24, 1) and float(got["variance"].max()) > 0
    again = p.predict_with_uncertainty(images, n_iter=3, seed=2)
    assert all(np.array_equal(got[k], again[k]) for k in got)


def test_a_rate_0_predictor_gives_zero_variance_and_predicts_mean(ckpts):
    """The Predictor refused predict_with_uncertainty until MC-dropout was
    ported: at rate 0 the n forwards are predict()'s."""
    p = Predictor(ckpts["UNet_B_selective"], selective=True, compute_dtype="float32",
                  device="cpu")
    images = np.random.default_rng(76).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    got = p.predict_with_uncertainty(images, n_iter=2)
    assert not got["variance"].any()
    np.testing.assert_allclose(got["mean_prob"][..., 0], p.predict(images)["prob"], rtol=0,
                               atol=1e-6)


def test_predict_image_with_uncertainty_matches_jax_in_form(ckpts):
    path = ckpts["UNet"]
    image = np.random.default_rng(77).integers(0, 256, (13, 19, 3), dtype=np.uint8)
    want = jax_predict.predict_image_with_uncertainty(
        JaxPredictor(path, model_arch="UNet", compute_dtype="float32", dropout_rate=0.2),
        image, n_iter=2, seed=1)
    got = predict.predict_image_with_uncertainty(
        Predictor(path, model_arch="UNet", compute_dtype="float32", dropout_rate=0.2,
                  device="cpu"), image, n_iter=2, seed=1)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    assert got["mean_prob"].shape == (13, 19, 2)
    for unc in (got, want):  # the port's _mc_pred is the JAX one, on either side's maps
        mine, theirs = predict._mc_pred(unc, 0.5), jax_predict._mc_pred(unc, 0.5)
        assert set(mine) == set(theirs) == {"prob", "pred"}
        for k in theirs:
            assert mine[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(mine[k], theirs[k])


def _cli(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("heatmap", ["1", "0"])
def test_snet_predict_uncertainty_writes_the_jax_files(ckpts, image_file, tmp_path, capsys,
                                                       heatmap):
    args = [image_file, "--model_path", ckpts["UNet_B_selective"], "--selective", "1",
            "--compute_dtype", "float32", "--uncertainty", "3", "--dropout_rate", "0.2",
            "--mc_seed", "5", "--heatmap", heatmap]
    j = _cli(jax_predict.main, args + ["--save_dir", str(tmp_path / "j")], capsys)
    p = _cli(lambda a: cli.main(["predict", *a], device="cpu"),
             args + ["--save_dir", str(tmp_path / "p")], capsys)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    assert "tile_uncertainty.npz" in os.listdir(tmp_path / "p")
    assert "tile_variance.png" in os.listdir(tmp_path / "p")
    pat = (r".*tile\.png: 20x28 tumor_fraction=\d\.\d{4} mc_iters=3 "
           r"mean_var=\S+$")
    assert re.match(pat, p[-1]) and re.match(pat, j[-1]), (p[-1], j[-1])
    got = np.load(tmp_path / "p" / "tile_uncertainty.npz")
    want = np.load(tmp_path / "j" / "tile_uncertainty.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
    for f in ("tile_variance.png", "tile_pred.png"):
        a, b = Image.open(tmp_path / "p" / f), Image.open(tmp_path / "j" / f)
        assert (a.mode, a.size) == (b.mode, b.size)


@pytest.mark.parametrize("flags", [
    ["--uncertainty", "4"],
    ["--dropout_rate", "0.3"],
    ["--uncertainty", "4", "--dropout_rate", "0.3", "--tile", "16", "16"],
    ["--uncertainty", "-1"],
    ["--uncertainty", "4", "--dropout_rate", "0.3", "--quantize", "int8"],
], ids=["no_dropout", "dropout_alone", "tile", "negative", "int8"])
def test_bad_uncertainty_flags_get_the_jax_parser_errors(ckpts, image_file, capsys, flags):
    """--dropout_rate and --uncertainty were refused whole until MC-dropout
    was ported; now their bad combinations get the JAX CLI's messages."""
    argv = [image_file, "--model_path", ckpts["UNet_B_selective"], *flags]
    errors = []
    for main in (jax_predict.main, lambda a: predict.main(a, device="cpu")):
        with pytest.raises(SystemExit):
            main(argv)
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and "error:" in errors[0]


def test_no_device_and_no_card_raises(ckpts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Predictor(ckpts["UNet_B_selective"], selective=True, dropout_rate=0.1)
