"""The port's ``snet-predict`` CLI (``tools/predict.py``) and the ``predict``
sub-command, in float32 on the CPU, against the JAX CLI on the same
checkpoint and image.

The image is 36x44, off the 8-pixel pool grid: both CLIs edge-pad it to
40x48 and crop the outputs back.
"""

import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from selectivenet_for_semantic_segmentation_binary_tpu.tools import predict as jax_predict
from selectivenet_for_semantic_segmentation_binary_torch import cli
from selectivenet_for_semantic_segmentation_binary_torch.tools import predict
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model
from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
    resolve_checkpoint)

NEAR = 1e-5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_predict_ckpt")
    path = str(d / "model_epoch3.pth")
    torch.save({"net": seeded_model(21, "float32", selective=True).state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_predict_imgs")
    arr = np.random.default_rng(22).integers(0, 256, (36, 44, 3), dtype=np.uint8)
    path = str(d / "tile.png")
    Image.fromarray(arr).save(path)
    return path


def _base(image, ckpt, out_dir, *extra):
    return [image, "--model_path", ckpt, "--selective", "1", "--compute_dtype", "float32",
            "--save_dir", out_dir, "--save_prob", "1", *extra]


@pytest.fixture(scope="module")
def jax_prob(ckpt, image_file, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_predict_out"))
    jax_predict.main(_base(image_file, ckpt, out, "--heatmap", "0"))
    return np.load(os.path.join(out, "tile_prob.npy"))


@pytest.mark.parametrize("tile", [None, ("16", "24")], ids=["whole", "tiled"])
def test_cli_writes_the_jax_outputs(ckpt, image_file, jax_prob, tmp_path, tile):
    out = str(tmp_path / "out")
    predict.main(_base(image_file, ckpt, out, *(("--tile", *tile) if tile else ())),
                 device="cpu")
    assert sorted(os.listdir(out)) == ["tile_heatmap.png", "tile_pred.png", "tile_prob.npy",
                                       "tile_selection.png"]
    prob = np.load(os.path.join(out, "tile_prob.npy"))
    assert prob.shape == (36, 44) and prob.dtype == np.float32
    np.testing.assert_allclose(prob, jax_prob, rtol=0, atol=NEAR)
    pred = np.asarray(Image.open(os.path.join(out, "tile_pred.png")))
    near = np.abs(jax_prob - 0.5) < NEAR
    assert pred.shape == (36, 44) and set(np.unique(pred)) == {0, 255}
    assert np.array_equal(pred[~near], np.where(jax_prob > 0.5, 255, 0)[~near])
    sel = np.asarray(Image.open(os.path.join(out, "tile_selection.png")))
    assert sel.shape == (36, 44) and set(np.unique(sel)) <= {0, 255}
    heat = np.asarray(Image.open(os.path.join(out, "tile_heatmap.png")))
    assert heat.shape == (36, 44, 3) and heat.dtype == np.uint8


def test_colliding_stems_and_directory_inputs(ckpt, image_file, tmp_path, capsys):
    """a.png from two directories into one --save_dir: a, a_2; a directory
    input skips the tool's own outputs, so a re-run is idempotent."""
    arr = np.asarray(Image.open(image_file))
    for sub in ("x", "y"):
        os.makedirs(tmp_path / sub)
        Image.fromarray(arr).save(str(tmp_path / sub / "a.png"))
    out = str(tmp_path / "out")
    predict.main([str(tmp_path / "x" / "a.png"), str(tmp_path / "y" / "a.png"),
                  "--model_path", ckpt, "--selective", "1", "--compute_dtype", "float32",
                  "--save_dir", out, "--heatmap", "0"], device="cpu")
    assert sorted(os.listdir(out)) == ["a_2_pred.png", "a_2_selection.png", "a_pred.png",
                                       "a_selection.png"]
    # default save_dir: beside the input; a second run over the directory
    # finds one image, not its outputs
    for _ in range(2):
        cli.main(["predict", str(tmp_path / "x"), "--model_path", ckpt, "--selective", "1",
                  "--compute_dtype", "float32", "--heatmap", "0"], device="cpu")
    assert sorted(os.listdir(tmp_path / "x")) == ["a.png", "a_pred.png", "a_selection.png"]
    assert "tumor_fraction=" in capsys.readouterr().out


def test_model_dir_resolves_the_newest_checkpoint(ckpt, tmp_path):
    for name in ("model_epoch2.pth", "model_epoch10.pth", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert resolve_checkpoint(None, str(tmp_path)).endswith("model_epoch10.pth")
    assert resolve_checkpoint(ckpt, None) == ckpt
    with pytest.raises(ValueError, match="exactly one"):
        resolve_checkpoint(ckpt, str(tmp_path))
    with pytest.raises(ValueError, match="exactly one"):
        resolve_checkpoint(None, None)
    with pytest.raises(ValueError, match="no checkpoints"):
        resolve_checkpoint(None, str(tmp_path / "missing"))


@pytest.mark.parametrize("flags,item", [
    (["--shard_windows", "1", "--tile", "32", "32"], "A8"),
], ids=["shard"])
def test_unported_flags_are_refused(ckpt, image_file, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        predict.main([image_file, "--model_path", ckpt, *flags], device="cpu")


@pytest.mark.parametrize("calib", [False, True], ids=["int8", "calib"])
def test_quantize_int8_serves_the_calibrated_int8_trunk(ckpt, image_file, tmp_path, calib):
    """``--quantize int8`` (calibrated lazily on the first image) and
    ``--calib_images``, refused until the int8 path was ported: the map the
    CLI writes is the int8 Predictor's, calibrated on the same padded
    image. tests/test_torch_quant.py holds the CLI to JAX's."""
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor

    extra = ["--calib_images", image_file] if calib else []
    predict.main([image_file, "--model_path", ckpt, "--selective", "1", "--compute_dtype",
                  "float32", "--quantize", "int8", "--save_dir", str(tmp_path), "--save_prob",
                  "1", "--heatmap", "0", *extra], device="cpu")
    padded, h, w = predict._pad_to_grid(predict._load_image(image_file, "RGB", False))
    want = Predictor(ckpt, selective=True, compute_dtype="float32", quantize="int8",
                     calibration_images=[padded], device="cpu").predict(padded[None])
    np.testing.assert_array_equal(np.load(str(tmp_path / "tile_prob.npy")),
                                  want["prob"][0, :h, :w])


@pytest.mark.parametrize("flags", [
    ["--input_type", "GH", "--blankfield", "1"], ["--input_type", "H_RGB"], ["--blankfield", "1"],
], ids=["GH", "H_RGB", "blankfield"])
def test_host_inputs_match_the_jax_cli(ckpt, image_file, tmp_path, flags):
    """The inputs the host converts, refused until they were ported: both
    CLIs on the same image and checkpoint (a 2-channel one for GH), whole
    image and tiled; the probabilities within NEAR, the masks equal away
    from the cut-off, and the image the port loads bit-equal to JAX's."""
    if "GH" in flags:
        ckpt = str(tmp_path / "gh.pth")
        torch.save({"net": seeded_model(23, "float32", selective=True, in_ch=2).state_dict()},
                   ckpt)
    it = flags[flags.index("--input_type") + 1] if "--input_type" in flags else "RGB"
    bf = "--blankfield" in flags
    got_img, want_img = predict._load_image(image_file, it, bf), jax_predict._load_image(
        image_file, it, bf)
    assert got_img.dtype == want_img.dtype == np.float32
    assert got_img.shape == want_img.shape == (36, 44, 2 if it == "GH" else 3)
    assert np.array_equal(got_img, want_img)
    jax_out = str(tmp_path / "j")
    jax_predict.main(_base(image_file, ckpt, jax_out, "--heatmap", "0", *flags))
    want = np.load(os.path.join(jax_out, "tile_prob.npy"))
    near = np.abs(want - 0.5) < NEAR
    for tile in ((), ("--tile", "16", "24")):
        out = str(tmp_path / f"p{len(tile)}")
        predict.main(_base(image_file, ckpt, out, "--heatmap", "0", *flags, *tile),
                     device="cpu")
        prob = np.load(os.path.join(out, "tile_prob.npy"))
        assert prob.shape == (36, 44) and prob.dtype == np.float32
        np.testing.assert_allclose(prob, want, rtol=0, atol=NEAR)
        pred = np.asarray(Image.open(os.path.join(out, "tile_pred.png")))
        assert np.array_equal(pred[~near], np.where(want > 0.5, 255, 0)[~near])


def _flags(parser_main, capsys):
    """The option strings a CLI's --help lists."""
    with pytest.raises(SystemExit):
        parser_main(["--help"])
    return set(re.findall(r"(?<![\w-])--\w+", capsys.readouterr().out))


def test_the_flags_are_the_jax_flags(capsys):
    want = _flags(jax_predict.main, capsys)
    assert _flags(predict.main, capsys) == want
    assert {"--tile", "--uncertainty", "--shard_windows", "--fold_bn"} <= want


def test_bad_arguments(ckpt, image_file, tmp_path):
    with pytest.raises(SystemExit):
        predict.main([image_file, "--model_path", ckpt, "--tile", "30", "32"], device="cpu")
    with pytest.raises(SystemExit):
        predict.main([image_file], device="cpu")  # neither --model_path nor --model_dir
    with pytest.raises(FileNotFoundError, match="does not exist"):
        predict.main([str(tmp_path / "missing.png"), "--model_path", ckpt], device="cpu")


def test_no_device_and_no_card_raises(ckpt, image_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["predict", image_file, "--model_path", ckpt])


@pytest.mark.parametrize("command", ["predict", "serve", "wsi"])
@pytest.mark.parametrize("input_type,in_ch", [("RGB", 2), ("GH", 3)], ids=["GH_ckpt", "RGB_ckpt"])
def test_an_input_type_the_checkpoint_does_not_take_is_refused(
        image_file, tmp_path, capsys, command, input_type, in_ch):
    """The serving CLIs read the input channels from the checkpoint's first
    conv and refuse an ``--input_type`` that gives other channels, before
    any image is read."""
    path = str(tmp_path / "model_epoch1.pth")
    torch.save({"net": seeded_model(23, "float32", selective=True, in_ch=in_ch).state_dict()},
               path)
    argv = {"predict": [image_file, "--save_dir", str(tmp_path / "out")],
            "serve": ["--port", "0"],
            "wsi": ["--data_dir", str(tmp_path / "no_data"), "--nrow", "3"]}[command]
    with pytest.raises(SystemExit):
        cli.main([command, *argv, "--model_path", path, "--selective", "1",
                  "--input_type", input_type], device="cpu")
    assert f"the checkpoint's first conv takes {in_ch}" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "out")
