"""The port's int8 (W8A8) serving path against the JAX package's, on the
CPU: ``ops/quant.py``, the quantized and calibrating trunks, the
``Predictor(quantize="int8")``, and ``--quantize int8`` in ``snet-eval``,
``snet-predict``, ``snet-serve`` (its parser; the served answers are in
``tests/test_torch_serve.py``) and ``snet-wsi``; each mirrors a test of
``tests/test_quant.py``.

Tolerances:
* the int8 weights equal JAX's bit for bit, and their scales in float32;
* activation scales from the two packages' float32 calibration passes within
  1e-6 relative (two float32 forwards of one graph);
* one quantized CBR within rtol/atol 1e-6 (XLA may contract the dequant
  into an FMA), its int8 activations equal;
* the whole int8 trunk on one quantized tree (JAX's, carried across by
  ``utils/checkpoint.py``): probabilities within 1e-3, masks >= 99.9%
  equal;
* two Predictors or CLIs that calibrate on their own: probabilities within
  1e-3 on the JAX tests' model (flax's init, which both packages share).
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from selectivenet_for_semantic_segmentation_binary_tpu.config import EvalConfig as JaxEvalConfig
from selectivenet_for_semantic_segmentation_binary_tpu.data import write_synthetic_patch_tree
from selectivenet_for_semantic_segmentation_binary_tpu.eval_lib import evaluate as jax_evaluate
from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.models.unet import CBR as JaxCBR
from selectivenet_for_semantic_segmentation_binary_tpu.ops import quant as jq
from selectivenet_for_semantic_segmentation_binary_tpu.ops.fold_bn import (
    fold_batchnorm as jax_fold)
from selectivenet_for_semantic_segmentation_binary_tpu import predictor as jax_predictor_module
from selectivenet_for_semantic_segmentation_binary_tpu.predictor import Predictor as JaxPredictor
from selectivenet_for_semantic_segmentation_binary_tpu.tools import predict as jax_predict
from selectivenet_for_semantic_segmentation_binary_tpu.tools import serve as jax_serve
from selectivenet_for_semantic_segmentation_binary_tpu.tools import wsi as jax_wsi
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint, torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch import cli
from selectivenet_for_semantic_segmentation_binary_torch import predictor as predictor_module
from selectivenet_for_semantic_segmentation_binary_torch.config import EvalConfig
from selectivenet_for_semantic_segmentation_binary_torch.data.folds import construct_test
from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import evaluate
from selectivenet_for_semantic_segmentation_binary_torch.models import (
    QuantCBR, build_model, load_weights)
from selectivenet_for_semantic_segmentation_binary_torch.ops import quant
from selectivenet_for_semantic_segmentation_binary_torch.ops.fold_bn import fold_batchnorm
from selectivenet_for_semantic_segmentation_binary_torch.ops.int8_conv import quantize_input
from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
from selectivenet_for_semantic_segmentation_binary_torch.tools import predict, serve
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model
from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
    act_scales_from_jax, state_dict_from_jax_variables)

SIZE = 32
SCALE_REL = 1e-6
PROB_TOL, MASK_AGREE = 1e-3, 0.999
# the JAX tests' bounds of an int8 forward against the float one
TRACK_PROB, TRACK_AGREE = 0.01, 0.99


def _flax_variables():
    """The JAX tests' model: flax's init of the selective UNet_B."""
    model = jax_build_model("UNet_B", selective=True, compute_dtype="float32")
    return jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                     train=False))


def _seeded_variables():
    """He-normal weights, BN statistics away from the identity: logits of
    a few units."""
    sd = {k: v.numpy() for k, v in seeded_model(20, "float32").state_dict().items()
          if not k.endswith("num_batches_tracked")}
    return torch_state_dict_to_variables(sd)


VARIABLES = {"flax_init": _flax_variables, "seeded": _seeded_variables}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).random((2, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=list(VARIABLES))
def pipeline(request, images):
    """JAX's fold -> calibrate -> quantize on one set of variables, and the
    port's folded state dict of the same variables."""
    v = VARIABLES[request.param]()
    folded = jax_fold(v)["params"]
    x = (jnp.asarray(images) - 0.5) / 0.5
    calib_model = jax_build_model("UNet_B", selective=True, compute_dtype="float32",
                                  folded=True, quant_calibrate=True)
    _, calib = calib_model.apply({"params": folded}, x, train=False, mutable=["quant_calib"])
    scales = jq.extract_act_scales(calib)
    qp = jq.quantize_folded(folded, scales)
    return dict(name=request.param, variables=v, folded=folded, scales=scales, qp=qp,
                x=np.asarray(x), port_folded=fold_batchnorm(state_dict_from_jax_variables(v)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX ``.ckpt`` of the JAX tests' model, which both packages read."""
    v = _flax_variables()
    d = tmp_path_factory.mktemp("torch_quant_ckpt")
    jax_save_checkpoint(str(d), {"net": {"params": v["params"],
                                         "batch_stats": v["batch_stats"]}, "epoch": 1}, 1)
    return os.path.join(str(d), "model_epoch1.ckpt")


def _sigmoid(a):
    return 1.0 / (1.0 + np.exp(-np.asarray(a, np.float64)))


# -- ops/quant.py -------------------------------------------------------------

def _kernel_case(case):
    rng = np.random.default_rng(0)
    if case == "random":
        return (rng.standard_normal((3, 3, 8, 16)) * 10.0 ** rng.uniform(-3, 1, 16)).astype(
            np.float32)
    if case == "integer_roundtrip":  # multiples of each channel's scale
        q = rng.integers(-127, 128, (3, 3, 4, 8)).astype(np.float32)
        q[0, 0, 0, :] = 127.0
        return q * (np.float32(10.0) ** rng.uniform(-3, 1, 8).astype(np.float32))
    k = np.zeros((3, 3, 2, 2), np.float32)
    if case == "per_channel":
        k[..., 0] = 1000.0
        k[1, 1, 0, 1] = 0.001
    return k  # "zero": a dead channel must not give a zero scale


@pytest.mark.parametrize("case", ["random", "integer_roundtrip", "per_channel", "zero"])
def test_quantize_kernel_matches_jax(case):
    """OIHW here, HWIO in JAX: the same int8 weights, the same float32
    scales."""
    k = _kernel_case(case)
    want_q, want_s = jq.quantize_kernel(k)
    got_q, got_s = quant.quantize_kernel(k.transpose(3, 2, 0, 1))
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_q, want_q.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got_s, want_s)
    assert np.all(np.isfinite(got_s)) and np.all(got_s > 0)


def test_act_scales_match_jax(pipeline):
    """The port's calibration pass (the float32 folded graph recording each
    CBR's input absmax) against JAX's ``sow``."""
    model = load_weights(build_model("UNet_B", selective=True, folded=True,
                                     quant_calibrate=True), pipeline["port_folded"])
    got = quant.calibrate_scales(model, torch.from_numpy(pipeline["x"]).permute(0, 3, 1, 2))
    want = act_scales_from_jax(pipeline["scales"])
    assert set(got) == set(want) and len(got) == 14
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=SCALE_REL), k
    assert all(m.absmax is None for m in model.modules() if hasattr(m, "absmax"))


def test_quantize_folded_matches_jax(pipeline):
    """The port's ``quantize_folded`` of JAX's folded tree (carried across)
    with JAX's scales equals JAX's quantized tree carried across, key for
    key and bit for bit: the int8 weights and scales, and the heads and
    transposed convs passed through."""
    folded = state_dict_from_jax_variables({"params": pipeline["folded"]})
    got = quant.quantize_folded(folded, act_scales_from_jax(pipeline["scales"]))
    want = state_dict_from_jax_variables({"params": pipeline["qp"]})
    assert set(got) == set(want)
    assert len(quant.quantized_layer_names(got)) == 14 == len(jq.quantized_layer_names(
        pipeline["qp"]))
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_quantized_cbr_exact_integer_arithmetic():
    """JAX's test_exact_integer_arithmetic inputs through the port's
    ``QuantCBR`` and JAX's W8A8 CBR: the int8 activations equal, the outputs
    within 1e-6, and both equal to the float conv of the dequantized
    weights."""
    rng = np.random.default_rng(2)
    a = np.float32(0.25)
    x = (rng.integers(-127, 128, (2, 8, 8, 3)) * a).astype(np.float32)
    kq = rng.integers(-127, 128, (3, 3, 3, 4)).astype(np.int8)
    ks = np.float32(10.0) ** rng.uniform(-2, 0, 4).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    params = {"conv": {"kernel_q": jnp.asarray(kq), "kernel_scale": jnp.asarray(ks),
                       "act_scale": jnp.asarray(a), "bias": jnp.asarray(b)}}
    want = np.asarray(JaxCBR(features=4, dtype=jnp.float32, folded=True, quantize=True).apply(
        {"params": params}, jnp.asarray(x), train=False))
    block = QuantCBR(3, 4, torch.float32)
    block.load_state_dict({"0.kernel_q": torch.from_numpy(kq.transpose(3, 2, 0, 1).copy()),
                           "0.kernel_scale": torch.from_numpy(ks),
                           "0.act_scale": torch.tensor(a), "0.bias": torch.from_numpy(b)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = block(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_array_equal(quantize_input(torch.from_numpy(x), torch.tensor(a)).numpy(),
                                  np.asarray(jnp.clip(jnp.round(x * (1.0 / a)), -127, 127)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    deq = kq.astype(np.float32) * ks
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(deq), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    np.testing.assert_allclose(got, np.maximum(ref + b, 0.0), rtol=1e-5, atol=1e-5)


def test_int8_trunk_matches_jax_on_the_same_tree(pipeline):
    """The whole selective int8 UNet_B of both packages on JAX's quantized
    tree. On the seeded weights both packages' int8 trunks are as far from
    their float graph (> the JAX tests' 0.01, which their flax-init model
    meets): the distance belongs to the reference's W8A8, not to the port."""
    x = pipeline["x"]
    want = jax_build_model("UNet_B", selective=True, compute_dtype="float32", folded=True,
                           quantize="int8").apply({"params": pipeline["qp"]}, jnp.asarray(x),
                                                  train=False)
    want_f = jax_build_model("UNet_B", selective=True, compute_dtype="float32",
                             folded=True).apply({"params": pipeline["folded"]}, jnp.asarray(x),
                                                train=False)
    sd = state_dict_from_jax_variables({"params": jax.device_get(pipeline["qp"])})
    model = load_weights(build_model("UNet_B", selective=True, folded=True, quantize="int8"), sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g_, w_, wf in zip(got, want, want_f):
        pg, pw = _sigmoid(g_.numpy()), _sigmoid(w_)
        assert np.abs(pg - pw).max() <= PROB_TOL
        assert ((pg > 0.5) == (pw > 0.5)).mean() >= MASK_AGREE
        to_float = np.abs(pw - _sigmoid(wf)).max()
        if pipeline["name"] == "seeded":
            assert to_float > TRACK_PROB
        else:
            assert to_float < TRACK_PROB


def test_merge_act_scales_elementwise_max():
    a = {"encoder_layer_1_1": 0.1, "encoder_layer_1_2": 0.5}
    b = {"encoder_layer_1_1": 0.3, "encoder_layer_1_2": 0.2}
    assert quant.merge_act_scales(a, b) == {"encoder_layer_1_1": 0.3, "encoder_layer_1_2": 0.5}
    with pytest.raises(ValueError, match="disagree"):
        quant.merge_act_scales(a, {"encoder_layer_1_1": 0.3})


@pytest.mark.parametrize("bad", [None, 0.0, float("nan"), float("inf")],
                         ids=["missing", "zero", "nan", "inf"])
def test_quantize_folded_refuses_uncalibrated_and_degenerate_scales(bad):
    folded = fold_batchnorm(seeded_model(0, "float32", selective=False).state_dict())
    scales = {} if bad is None else {n: bad for n in quant.cbr_names(folded)}
    match = "no calibrated activation scale" if bad is None else "degenerate activation scale"
    with pytest.raises(ValueError, match=match):
        quant.quantize_folded(folded, scales)


@pytest.mark.parametrize("kwargs,match", [
    (dict(quantize="int8"), "BN-folded"),
    (dict(quant_calibrate=True), "BN-folded"),
    (dict(folded=True, quantize="int8", quant_calibrate=True), "exclusive"),
    (dict(folded=True, quantize="int8", dropout_rate=0.3), "dropout"),
    (dict(folded=True, quantize="int4"), "unknown quantize"),
], ids=["quantize_unfolded", "calibrate_unfolded", "both", "dropout", "unknown"])
def test_build_model_guards_match_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as want:
        jax_build_model("UNet_B", **kwargs)
    with pytest.raises(ValueError, match=match) as got:
        build_model("UNet_B", **kwargs)
    assert str(got.value) == str(want.value)


# -- Predictor ----------------------------------------------------------------

def _port_int8(ckpt, **kw):
    return Predictor(ckpt, selective=True, compute_dtype="float32", quantize="int8",
                     device="cpu", **kw)


def test_lazy_first_batch_equals_eager_calibration(ckpt, images):
    eager = _port_int8(ckpt, calibration_images=images).predict(images)
    lazy = _port_int8(ckpt).predict(images)
    for k in eager:
        np.testing.assert_array_equal(lazy[k], eager[k])


def test_calibration_chunking_is_exact(ckpt):
    """20 images in chunks of at most 8 against 20 single-image
    calibrations: the same scales, as JAX's test holds them (rel. 1e-6: the
    absmax of a union is the max of its parts, but the CPU's float32 conv
    of an image rounds differently in a batch of 8 than alone)."""
    big = np.random.default_rng(0).random((20, SIZE, SIZE, 3)).astype(np.float32)
    chunked = _port_int8(ckpt, calibration_images=big)
    seq = _port_int8(ckpt)
    for i in range(len(big)):
        seq.calibrate(big[i:i + 1])
    assert list(chunked._act_scales) == list(seq._act_scales)
    for k, v in chunked._act_scales.items():
        assert v == pytest.approx(seq._act_scales[k], rel=SCALE_REL), k


def test_tracks_float_predictor_and_the_jax_one(ckpt, images):
    """JAX's test_tracks_float_predictor, and the port's int8 Predictor
    against JAX's, each calibrating on the same images."""
    got = _port_int8(ckpt, calibration_images=images).predict(images)
    ref = Predictor(ckpt, selective=True, compute_dtype="float32", device="cpu").predict(images)
    assert sorted(got) == ["pred", "prob", "selection", "selection_prob"]
    assert np.abs(ref["prob"] - got["prob"]).max() < TRACK_PROB
    assert (ref["pred"] == got["pred"]).mean() > TRACK_AGREE
    want = JaxPredictor(ckpt, selective=True, compute_dtype="float32", quantize="int8",
                        calibration_images=images).predict(images)
    for k in ("prob", "selection_prob"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PROB_TOL)
    assert (got["pred"] == want["pred"]).mean() >= MASK_AGREE


def test_wsi_center_crop_calibrates_lazily(ckpt):
    """An uncalibrated int8 Predictor calibrates ``predict_wsi`` on the
    slide's centre crop (the whole of a small grid-aligned slide), which is
    JAX's: grid-aligned, at most 1024x1024."""
    img = np.random.default_rng(3).random((64, 72, 3)).astype(np.float32)
    p = _port_int8(ckpt)
    out = p.predict_wsi(img, tile=(32, 32), batch_size=2)
    assert out["pred"].shape == (64, 72)
    assert p._act_scales == _port_int8(ckpt, calibration_images=img[None])._act_scales
    big = np.zeros((2001, 45, 3), np.float32)
    np.testing.assert_array_equal(predictor_module._center_crop(big),
                                  jax_predictor_module._center_crop(big))
    assert predictor_module._center_crop(big).shape == (1024, 40, 3)


def test_recalibration_only_widens_scales(ckpt, images):
    p = _port_int8(ckpt, calibration_images=images)

    def scales():  # the act_scale buffers of the loaded trunk
        return {n: float(m._modules["0"].act_scale) for n, m in p.model.named_modules()
                if isinstance(m, QuantCBR)}

    before = scales()
    p.calibrate(images * 0.1)
    mid = scales()
    assert all(mid[k] >= before[k] for k in before)
    p.calibrate(np.concatenate([images, images * 3.0 - 1.0]))
    after = scales()
    assert all(after[k] >= mid[k] for k in mid)
    assert after["encoder_layer_1_1"] > before["encoder_layer_1_1"]


@pytest.mark.parametrize("case", ["fold_bn", "dropout", "unknown", "uncertainty", "calibrate"])
def test_predictor_guards_match_jax(ckpt, images, case):
    errors = []
    for make in (lambda **kw: JaxPredictor(ckpt, selective=True, **kw),
                 lambda **kw: Predictor(ckpt, selective=True, device="cpu", **kw)):
        with pytest.raises(ValueError) as e:
            if case == "fold_bn":
                make(quantize="int8", fold_bn=False)
            elif case == "dropout":
                make(quantize="int8", dropout_rate=0.3)
            elif case == "unknown":
                make(quantize="fp8")
            elif case == "uncertainty":
                make(compute_dtype="float32", quantize="int8",
                     calibration_images=images).predict_with_uncertainty(images, n_iter=2)
            else:
                make(compute_dtype="float32").calibrate(images)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- snet-eval ----------------------------------------------------------------

@pytest.fixture(scope="module")
def patch_tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_quant_data")
    write_synthetic_patch_tree(str(d), n_slides=2, patches_per_slide=6, patch_size=SIZE, seed=0)
    return str(d)


def _eval_kw(patch_tree, model_dir, **kw):
    return dict(data_dir=patch_tree, test_fold=1, patch_size=SIZE, batch_size=4, num_workers=0,
                model_dir=model_dir, compute_dtype="float32", info_print=False, **kw)


@pytest.fixture(scope="module")
def ckpt_dir(ckpt):
    return os.path.dirname(ckpt)


def test_eval_int8_matches_jax_and_tracks_float(patch_tree, ckpt_dir):
    kw = _eval_kw(patch_tree, ckpt_dir, selective=True)
    got = evaluate(EvalConfig(quantize="int8", **kw), verbose=False, device="cpu")
    want = jax_evaluate(JaxEvalConfig(quantize="int8", **kw), verbose=False)
    ref = evaluate(EvalConfig(**kw), verbose=False, device="cpu")
    assert got["confusion_matrix"].sum() == want["confusion_matrix"].sum() > 0
    assert abs(got["accuracy"] - want["accuracy"]) < PROB_TOL
    assert abs(got["accuracy"] - ref["accuracy"]) < 0.02  # test_eval_quantize_tracks_bf16


def test_eval_int8_ensemble(patch_tree, tmp_path):
    for seed, epoch in ((0, 1), (1, 2)):
        torch.save({"net": seeded_model(seed, "float32", selective=False).state_dict()},
                   str(tmp_path / f"model_epoch{epoch}.pth"))
    r = evaluate(EvalConfig(quantize="int8", **_eval_kw(patch_tree, str(tmp_path))),
                 verbose=False, device="cpu")
    assert r["n_models"] == 2 and np.isfinite(r["mIoU"])


def test_eval_calib_patches_flag(patch_tree, ckpt_dir, capsys):
    kw = _eval_kw(patch_tree, ckpt_dir, selective=True, select_eval=True, quantize="int8")
    evaluate(EvalConfig(calib_patches=2, **kw), verbose=True, device="cpu")
    assert "int8 serving trunk: 1 model(s) calibrated on 2 patches" in capsys.readouterr().out
    evaluate(EvalConfig(calib_patches=64, **kw), verbose=True, device="cpu")
    n_fold = len(construct_test(patch_tree, test_fold=1))  # fewer than 64: all of them
    assert f"calibrated on {n_fold} patches" in capsys.readouterr().out
    with pytest.raises(ValueError, match="calib_patches"):
        evaluate(EvalConfig(calib_patches=0, **kw), verbose=False, device="cpu")
    with pytest.raises(ValueError, match="unknown --quantize"):
        evaluate(EvalConfig(**{**kw, "quantize": "int4"}), verbose=False, device="cpu")


# -- snet-predict, snet-serve, snet-wsi ----------------------------------------

@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_quant_imgs")
    arr = (np.random.default_rng(0).random((36, 44, 3)) * 255).astype(np.uint8)
    path = os.path.join(str(d), "tile.png")
    Image.fromarray(arr).save(path)
    return path


@pytest.mark.parametrize("calib", [False, True], ids=["lazy", "calib_images"])
def test_predict_cli_int8_matches_jax(ckpt, image_file, tmp_path, calib):
    extra = ["--calib_images", image_file] if calib else []
    argv = [image_file, "--model_path", ckpt, "--selective", "1", "--compute_dtype", "float32",
            "--quantize", "int8", "--heatmap", "0", "--save_prob", "1", *extra]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        predict.main(argv + ["--save_dir", str(tmp_path / "p")], device="cpu")
    jax_predict.main(argv + ["--save_dir", str(tmp_path / "j")])
    assert ("int8 serving trunk: calibrated on 1 images" in out.getvalue()) == calib
    for f in ("tile_pred.png", "tile_selection.png"):
        assert (tmp_path / "p" / f).exists()
    got, want = (np.load(str(tmp_path / s / "tile_prob.npy")) for s in ("p", "j"))
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)


def _last_error(main, argv, capsys):
    with pytest.raises(SystemExit):
        main(argv)
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("flags", [
    ["--quantize", "int8", "--fold_bn", "0"],
    ["--quantize", "int8", "--uncertainty", "4", "--dropout_rate", "0.3"],
    ["--calib_images", "x.png"],
], ids=["fold_bn", "uncertainty", "calib_alone"])
def test_predict_cli_errors_match_jax(ckpt, image_file, capsys, flags):
    argv = [image_file, "--model_path", ckpt, *flags]
    want = _last_error(jax_predict.main, argv, capsys)
    got = _last_error(lambda a: predict.main(a, device="cpu"), argv, capsys)
    assert got == want and "error:" in got


@pytest.mark.parametrize("flags", [
    ["--quantize", "int8"], ["--quantize", "int8", "--calib_images", "x.png", "--fold_bn", "0"],
    ["--calib_images", "/nonexistent"],
], ids=["no_calib_images", "fold_bn", "calib_alone"])
def test_serve_cli_errors_match_jax(ckpt, capsys, flags):
    argv = ["--model_path", ckpt, *flags]
    want = _last_error(jax_serve.main, argv, capsys)
    got = _last_error(lambda a: serve.main(a, device="cpu"), argv, capsys)
    assert got == want and "error:" in got


def test_wsi_cli_int8_matches_jax(patch_tree, ckpt, tmp_path, capsys):
    argv = ["--data_dir", patch_tree, "--test_fold", "1", "--model_path", ckpt,
            "--patch_size", str(SIZE), "--nrow", "2", "--batch_size", "4", "--num_workers", "1",
            "--compute_dtype", "float32", "--quantize", "int8", "--calib_patches", "3"]
    got = cli.main(["wsi", *argv, "--save_dir", str(tmp_path / "p")], device="cpu")
    out = capsys.readouterr().out
    assert "int8 serving trunk: calibrated on 3 patches" in out and "nanmean" in out
    jax_wsi.main([*argv, "--save_dir", str(tmp_path / "j")])
    rows = [open(tmp_path / s / "wsi_performance.csv").read().splitlines() for s in "pj"]
    assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) == len(got) + 1
    for a, b in zip(rows[0][1:], rows[1][1:]):
        a, b = a.split(","), b.split(",")
        assert a[0] == b[0]
        np.testing.assert_allclose(np.float64(a[1:]), np.float64(b[1:]), rtol=0, atol=PROB_TOL)
    with pytest.raises(SystemExit):
        cli.main(["wsi", *argv[:-1], "0"], device="cpu")
