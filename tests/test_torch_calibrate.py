"""The port's ``snet-calibrate`` (``tools/calibrate.py``) against the JAX
package's, in float32 on the CPU.

The quantile math (``threshold_for_coverage``, ``curve_from_histogram``,
``_to_eval_space``) is exact on hand-built histograms. The histograms of
one batch, and of the whole validation split end to end, may differ only
by pixels whose JAX selection confidence g lies within 1e-6 of a bin edge
(``EDGE``): such a pixel may land one bin over. Those pixels are counted,
and the count is the allowance.
"""

import io
import os
import re
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.config import EvalConfig as JaxEvalConfig
from selectivenet_for_semantic_segmentation_binary_tpu.data import native_decoder
from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.tools import calibrate as jax_cal
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    load_net_checkpoint as jax_load)
from selectivenet_for_semantic_segmentation_binary_torch import cli
from selectivenet_for_semantic_segmentation_binary_torch.config import EvalConfig
from selectivenet_for_semantic_segmentation_binary_torch.data.dataset import PatchDataset
from selectivenet_for_semantic_segmentation_binary_torch.data.folds import construct_train_valid
from selectivenet_for_semantic_segmentation_binary_torch.models import build_model, load_weights
from selectivenet_for_semantic_segmentation_binary_torch.ops.confusion import PAD_LABEL
from selectivenet_for_semantic_segmentation_binary_torch.tools import calibrate
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
    seeded_model, write_synthetic_patch_tree)

SIZE = 32
EDGE = 1e-6
N_BINS = calibrate.N_BINS


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_calibrate_data"))
    write_synthetic_patch_tree(d, n_slides=4, patches_per_slide=10, patch_size=SIZE, seed=8)
    return d


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_calibrate_models")
    for epoch, seed in ((2, 51), (10, 52)):  # the digit-latest, epoch 10, is calibrated
        torch.save({"net": seeded_model(seed, "float32", selective=True).state_dict()},
                   str(d / f"model_epoch{epoch}.pth"))
    return str(d)


def _histograms():
    rng = np.random.default_rng(9)
    spread = rng.integers(0, 50, N_BINS)
    spike = np.zeros(N_BINS, np.int64)
    spike[[0, 1000, 4095]] = [3, 100, 7]
    sparse = np.where(rng.random(N_BINS) < 0.01, rng.integers(1, 9, N_BINS), 0)
    return {"spread": spread, "spike": spike, "sparse": sparse}


@pytest.mark.parametrize("target", [1.0, 0.95, 0.8, 0.5, 1 / 3, 0.0])
@pytest.mark.parametrize("name", list(_histograms()))
def test_threshold_for_coverage_matches_jax(name, target):
    hist = _histograms()[name]
    got = calibrate.threshold_for_coverage(hist, target)
    want = jax_cal.threshold_for_coverage(hist, target)
    assert got == want
    assert got["achieved_coverage"] >= target or got["s_cut_off"] == 0.0


@pytest.mark.parametrize("name", list(_histograms()))
def test_curve_from_histogram_matches_jax(name):
    hist = _histograms()[name]
    rng = np.random.default_rng(len(name))
    correct = rng.binomial(hist, 0.8)
    hist2d = np.stack([hist - correct, correct], axis=1)
    got = calibrate.curve_from_histogram(hist2d)
    want = jax_cal.curve_from_histogram(hist2d)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("single_scale", ["sigmoid", "None", "clip", "minmax"])
def test_to_eval_space_matches_jax(single_scale):
    t = np.arange(N_BINS) / N_BINS
    np.testing.assert_array_equal(calibrate._to_eval_space(t, single_scale),
                                  jax_cal._to_eval_space(t, single_scale))
    for v in (0.0, 0.25, 4095 / 4096):
        assert calibrate._to_eval_space(v, single_scale) == jax_cal._to_eval_space(
            v, single_scale)


def test_an_empty_split_raises():
    for f in (calibrate.threshold_for_coverage, jax_cal.threshold_for_coverage):
        with pytest.raises(ValueError, match="empty calibration split"):
            f(np.zeros(N_BINS, np.int64), 0.8)


def _edge_allowance(selection_logits, labels):
    """Valid pixels whose JAX g = sigmoid(selection) lies within EDGE of an
    inner bin edge (g near 0 or 1 stays in the end bins, clamped)."""
    g = np.asarray(1.0 / (1.0 + np.exp(-np.asarray(selection_logits, np.float64))))
    edge = np.round(g * N_BINS)
    near = ((np.abs(g * N_BINS - edge) < EDGE * N_BINS) & (edge >= 1)
            & (edge <= N_BINS - 1))
    return int((near & (np.asarray(labels) < 2)).sum())


def _hold_hist(got, want, allowance):
    """Two histograms of the same pixels: each pixel off by at most one bin,
    on no more than ``allowance`` pixels."""
    assert got.sum() == want.sum()
    assert int(np.abs(got.astype(np.int64) - want).sum()) <= 2 * allowance


def test_histogram_steps_match_jax(model_dir):
    path = os.path.join(model_dir, "model_epoch10.pth")
    rng = np.random.default_rng(10)
    x = rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    label = rng.integers(0, 2, (3, SIZE, SIZE)).astype(np.uint8)
    label[2, SIZE // 2:] = PAD_LABEL  # a padded half-sample drops out
    variables = jax_load(path)
    jmodel = jax_build_model("UNet_B", 2, True, "float32")
    jbatch = {"input": jnp.asarray(x), "label": jnp.asarray(label)}
    cfg = EvalConfig(cut_off=0.4)
    want1 = np.asarray(jax_cal.make_histogram_step(jmodel, 2)(variables, jbatch))
    want2 = np.asarray(jax_cal.make_rc_histogram_step(jmodel, JaxEvalConfig(cut_off=0.4))(
        variables, jbatch))
    sel = jmodel.apply(variables, (jnp.asarray(x, jnp.float32) / 255.0 - 0.5) / 0.5)[1]
    allowance = _edge_allowance(sel, label)

    model = build_model("UNet_B", 2, True, "float32")
    load_weights(model, torch.load(path)["net"])
    batch = {"input": torch.from_numpy(x), "label": torch.from_numpy(label)}
    got1 = calibrate.make_histogram_step(model, 2)(batch)
    got2 = calibrate.make_rc_histogram_step(model, cfg)(batch)
    assert got1.dtype == got2.dtype == torch.int32
    assert tuple(got1.shape) == (N_BINS,) and tuple(got2.shape) == (N_BINS, 2)
    got1, got2 = got1.numpy(), got2.numpy()
    assert got1.sum() == 3 * SIZE * SIZE - SIZE * SIZE // 2
    _hold_hist(got1, want1, allowance)
    _hold_hist(got2, want2, allowance)
    np.testing.assert_array_equal(got2.sum(axis=1), got1)
    # about 2 * EDGE * N_BINS = 0.8% of the pixels lie that near an edge
    assert allowance <= 0.02 * got1.sum(), allowance
    assert (got1 > 0).sum() > 20  # g spreads over many bins


def test_a_ce_head_is_refused_by_the_steps():
    model = build_model("UNet", 2, True, "float32")
    batch = {"input": torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
             "label": torch.zeros((1, 8, 8), dtype=torch.uint8)}
    for step in (calibrate.make_histogram_step(model, 2),
                 calibrate.make_rc_histogram_step(model, EvalConfig())):
        with pytest.raises(ValueError, match="binary .BCE-form, UNet_B. selection heads"):
            step(batch)


def _valid_allowance(data_dir, model_dir):
    """The edge allowance over the validation split (JAX forward)."""
    _train, valid = construct_train_valid(data_dir, test_fold=1, seed=42)
    ds = PatchDataset(data_dir, valid, 200, SIZE)
    x, label = map(np.stack, zip(*(ds.get_raw(i) for i in range(len(ds)))))
    jmodel = jax_build_model("UNet_B", 2, True, "float32")
    sel = jmodel.apply(jax_load(os.path.join(model_dir, "model_epoch10.pth")),
                       (jnp.asarray(x, jnp.float32) / 255.0 - 0.5) / 0.5)[1]
    return _edge_allowance(sel, label), len(ds)


def test_snet_calibrate_matches_the_jax_cli(data_dir, model_dir, tmp_path, monkeypatch):
    """--split valid with --curve_csv. The CLIs have no dtype flag and run
    the bfloat16 default, where the two frameworks round differently: their
    lines and files are held in form, and their thresholds to each other
    within bfloat16's step, 1/256.
    In float32 the library calls give the same histogram within the edge
    allowance, and calibrate() agrees with risk_coverage_curve()."""
    monkeypatch.setattr(native_decoder, "available", lambda: False)  # both decode with PIL
    args = ["--data_dir", data_dir, "--fold", "1", "--model_dir", model_dir,
            "--patch_size", str(SIZE), "--batch_size", "4", "--split", "valid",
            "--target_coverage", "0.7"]
    lines = {}
    for side, main in (("j", jax_cal.main),
                       ("p", lambda argv: cli.main(["calibrate", *argv], device="cpu"))):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(args + ["--curve_csv", str(tmp_path / side / "rc.csv")])
        lines[side] = buf.getvalue().splitlines()
    allowance, n_valid = _valid_allowance(data_dir, model_dir)
    total = n_valid * SIZE * SIZE
    assert n_valid >= 4 and allowance <= 0.02 * total, (n_valid, allowance)
    assert lines["p"][0] == lines["j"][0] == (
        "calibrating the digit-latest of 2 checkpoints: epoch 10")
    assert len(lines["p"]) == len(lines["j"])

    _train, valid = construct_train_valid(data_dir, test_fold=1, seed=42)
    kw = dict(data_dir=data_dir, test_fold=1, model_dir=model_dir, selective=True,
              select_eval=True, patch_size=SIZE, batch_size=4, num_workers=2,
              compute_dtype="float32")
    want = jax_cal.risk_coverage_curve(JaxEvalConfig(**kw), data_list=valid, verbose=False)
    cfg = EvalConfig(**kw)
    curve = calibrate.risk_coverage_curve(cfg, data_list=valid, verbose=False, device="cpu")
    _hold_hist(curve["histogram2d"], want["histogram2d"], allowance)
    assert curve["histogram2d"].sum() == total

    csvs = {side: np.loadtxt(tmp_path / side / "rc.csv", delimiter=",", skiprows=1)
            for side in "pj"}
    assert (tmp_path / "p" / "rc.csv").read_text().splitlines()[0] == (
        "s_cut_off,coverage,selective_risk,selective_accuracy")
    assert csvs["p"].shape == csvs["j"].shape == (N_BINS, 4)
    np.testing.assert_array_equal(csvs["p"][:, 0], csvs["j"][:, 0])
    assert csvs["p"][0, 1] == 1.0 and np.all(np.diff(csvs["p"][:, 1]) <= 0)
    np.testing.assert_allclose(curve["coverage"], want["coverage"], rtol=0,
                               atol=allowance / total + 1e-15)

    res = calibrate.calibrate(cfg, 0.7, data_list=valid, verbose=False, device="cpu")
    hist = curve["histogram2d"].sum(axis=1)
    assert res == calibrate.threshold_for_coverage(hist, 0.7) | {"space": "sigmoid"}
    assert res["n_pixels"] == total and res["achieved_coverage"] >= 0.7
    got_cut = float(re.search(r"--s_cut_off (\S+)", lines["p"][-1]).group(1))
    want_cut = float(re.search(r"--s_cut_off (\S+)", lines["j"][-1]).group(1))
    assert abs(got_cut - want_cut) <= 1 / 256  # bfloat16's step, 2**-8, on both sides
    want_res = jax_cal.calibrate(JaxEvalConfig(**kw), 0.7, data_list=valid, verbose=False)
    assert abs(res["s_cut_off"] - want_res["s_cut_off"]) <= (1 / N_BINS if allowance else 0)


@pytest.mark.parametrize("arch,selective", [("UNet", True), ("UNet_B", False)],
                         ids=["ce_head", "not_selective"])
def test_unsupported_models_are_refused_with_the_jax_message(model_dir, arch, selective):
    kw = dict(model_dir=model_dir, model_arch=[arch], selective=selective)
    with pytest.raises(ValueError) as want:
        jax_cal._load_single(JaxEvalConfig(**kw), verbose=False)
    with pytest.raises(ValueError) as got:
        calibrate._load_single(EvalConfig(**kw), "cpu", verbose=False)
    assert str(got.value) == str(want.value)


def test_a_directory_without_checkpoints_raises(tmp_path):
    cfg = EvalConfig(model_dir=str(tmp_path), selective=True)
    with pytest.raises(FileNotFoundError, match="no .ckpt/.pth checkpoints"):
        calibrate._load_single(cfg, "cpu")


@pytest.mark.parametrize("flags", [["--blankfield", "1"], ["--input_type", "GH"]],
                         ids=["blankfield", "GH"])
def test_unported_flags_are_refused(data_dir, model_dir, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        cli.main(["calibrate", "--data_dir", data_dir, "--fold", "1", "--model_dir",
                  model_dir, *flags], device="cpu")


def test_the_flags_are_the_jax_flags(capsys):
    def flags(main):
        with pytest.raises(SystemExit):
            main(["--help"])
        return set(re.findall(r"(?<![\w-])--\w+", capsys.readouterr().out))

    assert flags(lambda a: calibrate.main(a, device="cpu")) == flags(jax_cal.main)


def test_no_device_and_no_card_raises(data_dir, model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["calibrate", "--data_dir", data_dir, "--fold", "1", "--model_dir",
                  model_dir])
