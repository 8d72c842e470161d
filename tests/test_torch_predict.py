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
    (["--uncertainty", "4", "--dropout_rate", "0.3"], "A7c"),
    (["--dropout_rate", "0.3"], "A7c"),
    (["--quantize", "int8"], "A10"),
    (["--calib_images", "x.png"], "A10"),
    (["--shard_windows", "1", "--tile", "32", "32"], "A8"),
    (["--input_type", "GH"], "A5"),
    (["--input_type", "H_RGB"], "A5"),
    (["--blankfield", "1"], "A5"),
], ids=["uncertainty", "dropout", "int8", "calib", "shard", "GH", "H_RGB", "blankfield"])
def test_unported_flags_are_refused(ckpt, image_file, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        predict.main([image_file, "--model_path", ckpt, *flags], device="cpu")


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
