"""The port's ``snet-inspect-ckpt`` (``tools/inspect_ckpt.py``) against the
JAX package's, exactly: the ``summarize`` and ``compare`` dicts and the
printed lines, on the committed JAX fixture ``tests/data/jax_fixture.ckpt``,
on a port ``.pth``, on a DataParallel-prefixed ``.pth`` and on a JAX
``.ckpt`` of the same UNet_B; the port's also with ``msgpack`` blocked."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.tools import inspect_ckpt as jax_inspect
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint, torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch.tools import inspect_ckpt
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "jax_fixture.ckpt")


def _same(got, want):
    """Dict equality that takes numpy scalars and 0-d arrays by value."""
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert np.array_equal(got[k], want[k]) and np.asarray(got[k]).dtype == want[k].dtype, k
        else:
            assert got[k] == want[k], k


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A port .pth of a selective UNet_B, the same with DataParallel's
    prefix, and the same weights as a JAX .ckpt (the JAX package's writer)."""
    d = tmp_path_factory.mktemp("inspect")
    model = seeded_model(3, "float32")
    sd = model.state_dict()
    pth = str(d / "model_epoch7.pth")
    torch.save({"net": sd, "epoch": 7}, pth)
    dp = str(d / "model_epoch8.pth")
    torch.save({"net": {f"module.{k}": v for k, v in sd.items()}}, dp)
    variables = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")})
    ckpt = jax_save_checkpoint(str(d / "jax"), {"net": variables, "epoch": 9}, 9)
    return {"pth": pth, "dp": dp, "ckpt": ckpt}


@pytest.mark.parametrize("which", ["fixture", "pth", "dp", "ckpt"])
def test_summarize_equals_jax(which, ckpts):
    path = FIXTURE if which == "fixture" else ckpts[which]
    got, want = inspect_ckpt.summarize(path), jax_inspect.summarize(path)
    _same(got, want)
    assert got["dataparallel_prefix"] == (which == "dp")


@pytest.mark.parametrize("pair", [("pth", "ckpt"), ("dp", "pth"), ("ckpt", "ckpt")],
                         ids=lambda p: "-".join(p))
def test_compare_equals_jax(pair, ckpts):
    a, b = (ckpts[k] for k in pair)
    got, want = inspect_ckpt.compare(a, b), jax_inspect.compare(a, b)
    assert got == want
    assert not got["shape_mismatch"] and got["n_shared"] == (110 if pair == ("dp", "pth") else 96)
    if pair == ("pth", "ckpt"):  # torch's BN counters have no JAX counterpart
        assert got["only_in_a"] == sorted(k for k in torch.load(a)["net"]
                                          if k.endswith("num_batches_tracked"))
        assert len(got["only_in_a"]) == 14 and not got["only_in_b"]


def test_canonical_state_dicts_equal_jax(ckpts):
    for path in (ckpts["pth"], ckpts["ckpt"]):
        got, want = (inspect_ckpt.canonical_state_dict(path),
                     jax_inspect.canonical_state_dict(path))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_the_fixture_has_no_unet_to_compare(ckpts):
    """The fixture's net is one layer, not a UNet: both tools refuse it alike."""
    for tool in (inspect_ckpt, jax_inspect):
        with pytest.raises(KeyError, match="trunk"):
            tool.compare(ckpts["pth"], FIXTURE)


def test_cli_prints_the_same_lines(ckpts):
    argv = [ckpts["dp"], "--keys", "--compare", ckpts["ckpt"]]
    outs = []
    for tool in (inspect_ckpt, jax_inspect):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tool.main(argv)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "DataParallel 'module.' prefix: True" in outs[0] and "only_in_a" in outs[0]
    outs = []
    for tool in (inspect_ckpt, jax_inspect):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tool.main([ckpts["ckpt"], "--compare", ckpts["ckpt"]])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "MATCH: identical key sets and shapes" in outs[0]


def test_without_msgpack(ckpts, monkeypatch):
    """The port reads a JAX .ckpt with its own decoder: msgpack blocked."""
    want = {p: jax_inspect.summarize(p) for p in (FIXTURE, ckpts["ckpt"])}
    want_cmp = jax_inspect.compare(ckpts["pth"], ckpts["ckpt"])
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack  # noqa: F401
    for path, w in want.items():
        _same(inspect_ckpt.summarize(path), w)
    assert inspect_ckpt.compare(ckpts["pth"], ckpts["ckpt"]) == want_cmp
