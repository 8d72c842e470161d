"""The port's stitched whole-slide scoring (``tools/wsi.py``, ``snet-wsi``)
against the JAX package's, in float32 on the CPU.

Both sides read one synthetic patch tree (32x32 patches, written by the
port's writer, which the first test holds to the JAX writer byte for byte)
through PIL, with the same checkpoint file. Probabilities agree within
1e-5; a mask pixel may differ only where the JAX probability lies within
``NEAR`` = 1e-5 of the cut-off (counted: the allowance). Where the
allowance is 0, accuracy, recall, precision and F1 agree within 1e-6, and
the AUC within 1e-6 plus the share of (positive, negative) pixel pairs
whose probabilities lie within 2e-5 of each other, whose order a 1e-5 move
may flip (``_auc_slack``). The heatmap and the stitching are exact.
"""

import csv
import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image

from selectivenet_for_semantic_segmentation_binary_tpu.data import (
    PatchDataset as JaxPatchDataset, construct_test as jax_construct_test,
    write_synthetic_patch_tree as jax_write_tree)
from selectivenet_for_semantic_segmentation_binary_tpu.data import native_decoder
from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.tools import wsi as jax_wsi
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    load_net_checkpoint as jax_load)
from selectivenet_for_semantic_segmentation_binary_torch import cli
from selectivenet_for_semantic_segmentation_binary_torch.data.dataset import PatchDataset
from selectivenet_for_semantic_segmentation_binary_torch.data.folds import construct_test
from selectivenet_for_semantic_segmentation_binary_torch.models import build_model, load_weights
from selectivenet_for_semantic_segmentation_binary_torch.tools import wsi
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
    seeded_model, write_synthetic_patch_tree)

SIZE = 32
NEAR = 1e-5
PROB_TOL = 1e-5
SCORE_TOL = 1e-6
MODELS = {"UNet_B_selective": ("UNet_B", True), "UNet_B": ("UNet_B", False),
          "UNet": ("UNet", False)}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_wsi_data"))
    write_synthetic_patch_tree(d, n_slides=3, patches_per_slide=10, patch_size=SIZE, seed=4)
    return d


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_wsi_ckpt")
    out = {}
    for i, (name, (arch, selective)) in enumerate(MODELS.items()):
        path = str(d / f"{name}.pth")
        torch.save({"net": seeded_model(40 + i, "float32", selective=selective,
                                        model_arch=arch).state_dict()}, path)
        out[name] = path
    return out


def test_the_writer_writes_the_jax_files(data_dir, tmp_path):
    jax_write_tree(str(tmp_path), n_slides=3, patches_per_slide=10, patch_size=SIZE, seed=4)
    names = []
    for root, _, files in os.walk(str(tmp_path)):
        for f in files:
            a = os.path.join(root, f)
            b = os.path.join(data_dir, os.path.relpath(a, str(tmp_path)))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f
            names.append(f)
    assert len(names) == 3 * 10 * 2 + 10  # inputs, labels, 5 folds x 2 classes


@pytest.mark.parametrize("nrow", [1, 3, 4])
@pytest.mark.parametrize("channels", [None, 3])
def test_stitch_patches_matches_jax(nrow, channels):
    shape = (10, 4, 5) + ((channels,) if channels else ())
    patches = np.random.default_rng(nrow).random(shape).astype(np.float32)
    got = wsi.stitch_patches(patches, nrow)
    np.testing.assert_array_equal(got, jax_wsi.stitch_patches(patches, nrow))
    assert got.dtype == patches.dtype
    r, c = 4 % nrow, 4 // nrow  # patch j at row j % nrow, column j // nrow
    np.testing.assert_array_equal(got[r * 4:(r + 1) * 4, c * 5:(c + 1) * 5], patches[4])
    assert got.shape[:2] == (nrow * 4, -(-10 // nrow) * 5)


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint8"])
def test_make_heatmap_is_matplotlib_jet(dtype):
    from matplotlib import cm

    rng = np.random.default_rng(3)
    if dtype == "uint8":
        v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    else:
        v = rng.random((64, 64)).astype(dtype)
        edge = np.array([0.0, 1.0, np.nextafter(1.0, 0.0), -0.2, 1.5, np.nan, 0.5,
                         1 / 256, np.nextafter(1 / 256, 0.0), 255 / 256], dtype)
        v[0, :len(edge)] = edge
        v[1] = (np.arange(64) / 63).astype(dtype)
    got = wsi.make_heatmap(v)
    want = cm.jet(v)[..., :3].astype(np.float32)
    assert got.dtype == np.float32 and got.shape == v.shape + (3,)
    assert float(np.abs(got - want).max()) == 0.0


def test_save_performance_as_csv_writes_the_jax_bytes(tmp_path):
    rows = [["slide00", 0.5, np.nan, 1 / 3, np.float64(0.25), 1.0], ["s1", 1, 2, 3, 4, 5]]
    header = ["slide", "accuracy", "recall", "precision", "f1 score", "AUC score"]
    for h in (header, None):
        got = wsi.save_performance_as_csv(str(tmp_path / "p"), rows, "perf", header=h)
        want = jax_wsi.save_performance_as_csv(str(tmp_path / "j"), rows, "perf", header=h)
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()


def _allowance(got_pred, want_prob, want_pred, cut):
    near = np.abs(want_prob.astype(np.float64) - cut) < NEAR
    assert np.array_equal(got_pred[~near], want_pred[~near])
    return int(near.sum())


def _auc_slack(label, prob):
    """How far the AUC may move when each probability moves by up to
    PROB_TOL: the share of (positive, negative) pixel pairs whose
    probabilities lie within 2 * PROB_TOL, whose order may flip."""
    label, prob = np.ravel(label), np.ravel(prob).astype(np.float64)
    pos, neg = np.sort(prob[label == 1]), np.sort(prob[label == 0])
    if not (len(pos) and len(neg)):
        return 0.0
    close = (np.searchsorted(neg, pos + 2 * PROB_TOL, "right")
             - np.searchsorted(neg, pos - 2 * PROB_TOL, "left"))
    return float(close.sum()) / (len(pos) * len(neg))


def _close_scores(got, want, auc_slack):
    """Accuracy, recall, precision and F1 within SCORE_TOL; the AUC within
    SCORE_TOL plus its slack."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=SCORE_TOL,
                               equal_nan=True)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0,
                               atol=SCORE_TOL + auc_slack, equal_nan=True)


def _hold(got, want, cut, nrow):
    """Port results against JAX results, slide by slide; returns the allowance."""
    assert list(got) == list(want)
    allowance = 0
    for slide in want:
        g, w = got[slide], want[slide]
        assert set(g) == set(w)
        np.testing.assert_allclose(g["prob"], w["prob"], rtol=0, atol=PROB_TOL)
        assert g["prob"].dtype == np.float32 and g["pred"].dtype == w["pred"].dtype
        for k in ("label", "sample"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(g["heatmap"], wsi.make_heatmap(g["prob"]))
        allowance += _allowance(g["pred"], w["prob"], w["pred"], cut)
    if allowance == 0:
        for slide in want:
            g, w = got[slide], want[slide]
            h, wd = SIZE, SIZE
            slacks = []
            for j in range(len(w["patch_scores"])):
                r, c = j % nrow, j // nrow
                cell = (slice(r * h, (r + 1) * h), slice(c * wd, (c + 1) * wd))
                slacks.append(_auc_slack(w["label"][cell], w["prob"][cell]))
                _close_scores(g["patch_scores"][j], w["patch_scores"][j], slacks[-1])
            _close_scores(g["patch_scores_mean"], w["patch_scores_mean"], max(slacks))
            _close_scores(g["wsi_score"], w["wsi_score"], _auc_slack(w["label"], w["prob"]))
    return allowance


@pytest.mark.parametrize("name", list(MODELS))
def test_wsi_inference_matches_jax(data_dir, ckpts, name, tmp_path):
    arch, selective = MODELS[name]
    data_list = construct_test(data_dir, test_fold=1)
    np.testing.assert_array_equal(data_list, jax_construct_test(data_dir, test_fold=1))
    jds = JaxPatchDataset(data_dir, data_list, 200, SIZE, "RGB", decoder="pil")
    want = jax_wsi.wsi_inference(
        jax_build_model(arch, 2, selective, "float32"), jax_load(ckpts[name]), jds, nrow=2,
        selective=selective, cut_off=0.45, batch_size=3, save_dir=str(tmp_path / "j"),
        num_workers=2)
    model = build_model(arch, 2, selective, "float32")
    load_weights(model, torch.load(ckpts[name])["net"])
    got = wsi.wsi_inference(model, PatchDataset(data_dir, data_list, 200, SIZE), nrow=2,
                            selective=selective, cut_off=0.45, batch_size=3,
                            save_dir=str(tmp_path / "p"), num_workers=2, device="cpu")
    assert len(got) >= 2
    assert _hold(got, want, 0.45, nrow=2) <= 4
    for f in sorted(os.listdir(tmp_path / "j")):
        assert os.path.exists(tmp_path / "p" / f), f
    with open(tmp_path / "p" / "wsi_performance.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0][0] == "slide" and [r[0] for r in rows[1:]] == list(want)


def _rows(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [[r[0]] + [float(v) for v in r[1:]] for r in rows[1:]]


def test_snet_wsi_matches_the_jax_cli(data_dir, ckpts, tmp_path, monkeypatch):
    """The printed lines and the files of both CLIs on a model directory."""
    monkeypatch.setattr(native_decoder, "available", lambda: False)  # both decode with PIL
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    os.link(ckpts["UNet_B_selective"], model_dir / "model_epoch7.pth")
    args = ["--data_dir", data_dir, "--model_dir", str(model_dir), "--selective", "1",
            "--nrow", "3", "--patch_size", str(SIZE), "--compute_dtype", "float32",
            "--num_workers", "2", "--batch_size", "4"]
    outs = {}
    for side, main in (("j", lambda argv: jax_wsi.main(argv)),
                       ("p", lambda argv: cli.main(["wsi", *argv], device="cpu"))):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(args + ["--save_dir", str(tmp_path / side)])
        outs[side] = buf.getvalue().splitlines()
    assert len(outs["p"]) == len(outs["j"]) and len(outs["j"]) >= 5
    assert outs["p"][1:] == outs["j"][1:]  # line 0 names the checkpoint
    assert re.match(r"checkpoint: .*model_epoch7\.pth \(UNet_B, selective=True\)",
                    outs["p"][0])
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    header, want = _rows(tmp_path / "j" / "wsi_performance.csv")
    got_header, got = _rows(tmp_path / "p" / "wsi_performance.csv")
    assert got_header == header and [r[0] for r in got] == [r[0] for r in want]
    got_scores = np.array([r[1:] for r in got])
    want_scores = np.array([r[1:] for r in want])
    _close_scores(got_scores, want_scores, 1e-4)  # AUC: see _auc_slack; the lines above agree
    for f in os.listdir(tmp_path / "j"):
        if f.endswith("_pred.png"):
            a = np.asarray(Image.open(tmp_path / "p" / f))
            b = np.asarray(Image.open(tmp_path / "j" / f))
            assert a.shape == b.shape and (a != b).sum() <= 4
        elif f.endswith("_heatmap.png"):
            a = np.asarray(Image.open(tmp_path / "p" / f)).astype(int)
            b = np.asarray(Image.open(tmp_path / "j" / f)).astype(int)
            # a pixel's jet entry moves only where the probability lies within
            # PROB_TOL of an entry's edge: a few pixels, each by one entry
            assert a.shape == b.shape and (a != b).any(-1).mean() < 0.01
            assert np.abs(a - b).max() <= 8


@pytest.mark.parametrize("flags,item", [
    (["--input_type", "GH"], "A5"),
    (["--input_type", "H_RGB"], "A5"),
    (["--blankfield", "1"], "A5"),
    (["--quantize", "int8"], "A10"),
], ids=["GH", "H_RGB", "blankfield", "int8"])
def test_unported_flags_are_refused(data_dir, ckpts, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cli.main(["wsi", "--data_dir", data_dir, "--model_path", ckpts["UNet_B"], "--nrow",
                  "3", *flags], device="cpu")


def test_a_host_transform_is_refused(data_dir):
    ds = PatchDataset(data_dir, construct_test(data_dir, 1), 200, SIZE)
    ds.transform = object()
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        wsi.wsi_inference(build_model("UNet_B"), ds, nrow=3, device="cpu")


def test_the_flags_are_the_jax_flags(capsys):
    def flags(main):
        with pytest.raises(SystemExit):
            main(["--help"])
        return set(re.findall(r"(?<![\w-])--\w+", capsys.readouterr().out))

    assert flags(lambda a: wsi.main(a, device="cpu")) == flags(jax_wsi.main)


def test_the_port_needs_neither_matplotlib_nor_sklearn():
    """An installation without either still draws heatmaps and scores AUCs
    (a module set to None in sys.modules fails to import)."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "from selectivenet_for_semantic_segmentation_binary_torch.tools import (\n"
        "    calibrate, predict, uncertainty, wsi)\n"
        "from selectivenet_for_semantic_segmentation_binary_torch.utils.metrics import (\n"
        "    get_performance)\n"
        "h = wsi.make_heatmap(np.linspace(0, 1, 50, dtype=np.float32))\n"
        "s = get_performance(np.array([0, 1, 1, 0]), np.array([.1, .8, .4, .3]),\n"
        "                    np.array([0, 1, 0, 0]))\n"
        "assert h.shape == (50, 3) and s[4] == 1.0, s\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert res.returncode == 0, res.stderr


def test_no_device_and_no_card_raises(data_dir, ckpts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["wsi", "--data_dir", data_dir, "--model_path", ckpts["UNet_B"],
                  "--nrow", "3"])
    ds = PatchDataset(data_dir, construct_test(data_dir, 1), 200, SIZE)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        wsi.wsi_inference(build_model("UNet_B"), ds, nrow=3)
