"""The port's ``snet-export`` (``tools/export.py``, ``torch.export``) against
the JAX package's ``make_serving_fn`` of the same weights, in float32 on
the CPU, within ``NEAR`` of tests/test_torch_predictor.py. The artifact is
loaded and run in a subprocess that cannot import the package (it is
neither installed nor on that process's path): ``torch`` alone."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.predictor import (
    Predictor as JaxPredictor)
from selectivenet_for_semantic_segmentation_binary_tpu.tools import export as jax_export
from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
from selectivenet_for_semantic_segmentation_binary_torch.tools import export
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model

NEAR = 1e-5  # tests/test_torch_predictor.py
SHAPE = (2, 32, 40)

_CONSUMER = """
import importlib.util, sys
import numpy as np, torch
assert importlib.util.find_spec("selectivenet_for_semantic_segmentation_binary_torch") is None
assert importlib.util.find_spec("selectivenet_for_semantic_segmentation_binary_tpu") is None
program = torch.export.load(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2]))
with torch.no_grad():
    out = program.module()(x)
np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()})
try:
    program.module()(x[:, :-8])
except Exception as e:  # the exported shape is static
    print("refused:", type(e).__name__)
"""

CASES = {"UNet_B_selective": ("UNet_B", True, "RGB"),
         "UNet": ("UNet", False, "RGB"),
         "UNet_B_GH": ("UNet_B", True, "GH")}


def _ckpt(d, arch, selective, input_type):
    in_ch = 2 if input_type == "GH" else 3
    path = os.path.join(str(d), "model_epoch3.pth")
    model = seeded_model(21, "float32", selective=selective, model_arch=arch, in_ch=in_ch)
    torch.save({"net": model.state_dict()}, path)
    return path


def _export(ckpt, out, arch, selective, input_type, *extra):
    argv = ["--out", out, "--model_path", ckpt, "--model_arch", arch, "--selective",
            str(int(selective)), "--input_type", input_type, "--compute_dtype", "float32",
            "--batch", str(SHAPE[0]), "--height", str(SHAPE[1]), "--width", str(SHAPE[2]),
            *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        meta = export.main(argv, device="cpu")
    return meta, buf.getvalue()


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_without_the_package_equals_jax(case, tmp_path):
    arch, selective, input_type = CASES[case]
    channels = 2 if input_type == "GH" else 3
    ckpt = _ckpt(tmp_path, arch, selective, input_type)
    out = str(tmp_path / "serve.pt2")
    meta, printed = _export(ckpt, out, arch, selective, input_type)
    assert "check ok" in printed
    assert meta["input_shape"] == [*SHAPE, channels]
    x = np.random.default_rng(3).random((*SHAPE, channels), np.float32)
    np.save(tmp_path / "x.npy", x)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", _CONSUMER, out, str(tmp_path / "x.npy"),
                          str(tmp_path / "y.npz")], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "refused:" in run.stdout
    got = np.load(tmp_path / "y.npz")
    jp = JaxPredictor(ckpt, model_arch=arch, selective=selective, compute_dtype="float32")
    want = jax.jit(jax_export.make_serving_fn(jp.model, jp.variables, selective))(
        jnp.asarray(x))
    assert sorted(got.files) == sorted(want) == sorted(meta["outputs"])
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == SHAPE
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=NEAR, err_msg=k)


def test_sidecar_keys_are_jaxs(tmp_path):
    ckpt = _ckpt(tmp_path, "UNet_B", True, "RGB")
    meta, _ = _export(ckpt, str(tmp_path / "a.pt2"), "UNet_B", True, "RGB", "--check", "0")
    with open(tmp_path / "a.pt2.json") as f:
        assert json.load(f) == meta
    jax_keys = {"artifact", "calling_convention", "checkpoint", "model_arch", "n_cls",
                "selective", "input_type", "compute_dtype", "fold_bn", "input_shape",
                "input_dtype", "outputs", "platforms", "jax_version", "size_bytes"}
    assert set(meta) == jax_keys - {"jax_version"} | {"torch_version"}
    assert meta["platforms"] == ["cpu"] and meta["outputs"] == {"prob": list(SHAPE),
                                                                "selection_prob": list(SHAPE)}
    assert meta["size_bytes"] == os.path.getsize(tmp_path / "a.pt2")
    assert not os.path.exists(tmp_path / "a.pt2.tmp")


def test_bf16_artifact_reproduces_the_predictor(tmp_path):
    """The bf16 artifact (bf16 weights, no autocast) against the live bf16
    Predictor (autocast) on the same images: within the check's bound."""
    ckpt = _ckpt(tmp_path, "UNet_B", True, "RGB")
    out = str(tmp_path / "b.pt2")
    argv = ["--out", out, "--model_path", ckpt, "--selective", "1", "--batch", "2",
            "--height", "32", "--width", "32"]
    with contextlib.redirect_stdout(io.StringIO()):
        meta = export.main(argv, device="cpu")
    assert meta["compute_dtype"] == "bfloat16"
    predictor = Predictor(ckpt, selective=True, device="cpu")
    err = export.check_artifact(out, predictor, "cpu", export.CHECK_TOL["bfloat16"])
    assert err <= export.CHECK_TOL["bfloat16"]


@pytest.mark.parametrize("argv, match", [
    (["--height", "36"], "multiples of 8"),
    (["--batch", "0"], "batch must be >= 1"),
    (["--platforms", "cpu,tpu"], "tpu"),
    (["--platforms", "metal"], "platforms must be among"),
    (["--input_type", "GH"], "the checkpoint's first conv takes 3"),
], ids=["off_grid", "batch0", "tpu", "unknown_platform", "gh_on_rgb"])
def test_cli_refusals(argv, match, tmp_path, capsys):
    ckpt = _ckpt(tmp_path, "UNet_B", True, "RGB")
    with pytest.raises(SystemExit):
        export.main(["--out", str(tmp_path / "x.pt2"), "--model_path", ckpt, *argv],
                    device="cpu")
    assert match in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.pt2")


def test_export_serving_refusals(tmp_path):
    predictor = Predictor(_ckpt(tmp_path, "UNet_B", True, "RGB"), selective=True,
                          compute_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="multiples of 8"):
        export.export_serving(predictor, 1, 30, 32, 3)
    with pytest.raises(ValueError, match="batch must be >= 1"):
        export.export_serving(predictor, 0, 32, 32, 3)
    with pytest.raises(ValueError, match="'tpu' artifact"):
        export.export_serving(predictor, 1, 32, 32, 3, platforms=["tpu"])


def test_serving_fn_in_process_matches_predictor(tmp_path):
    """make_serving_fn is the Predictor's predict without thresholds."""
    ckpt = _ckpt(tmp_path, "UNet_B", True, "RGB")
    predictor = Predictor(ckpt, selective=True, compute_dtype="float32", device="cpu")
    x = np.random.default_rng(4).random((2, 32, 32, 3), np.float32)
    with torch.no_grad():
        got = export.make_serving_fn(predictor.model, True)(torch.from_numpy(x))
    want = predictor.predict(x)
    for k in ("prob", "selection_prob"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=NEAR)
