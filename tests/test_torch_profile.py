"""``--profile_dir``: ``train()`` traces epoch ``start_epoch + 2`` with
``torch.profiler`` (JAX train_lib.py:638-651) into
``{profile_dir}/epoch{N}.pt.trace.json``, also when that epoch raises."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from selectivenet_for_semantic_segmentation_binary_tpu.data import write_synthetic_patch_tree
from selectivenet_for_semantic_segmentation_binary_torch import train_lib
from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig

SIZE = 32


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("profile_data"))
    write_synthetic_patch_tree(d, n_slides=2, patches_per_slide=8, patch_size=SIZE)
    return d


def _cfg(data_dir, tmp_path, **kw):
    return TrainConfig(data_dir=data_dir, model_dir=str(tmp_path / "m"), fold=1,
                       patch_size=SIZE, batch_size=4, n_epoch=3, model_arch="UNet_B",
                       loss="BCElogit", selective=True, compute_dtype="float32",
                       num_workers=2, profile_dir=str(tmp_path / "prof"), **kw)


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_profile_dir_traces_the_second_epoch(data_dir, tmp_path):
    cfg = _cfg(data_dir, tmp_path)
    train_lib.check_supported(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        result = train_lib.train(cfg, device="cpu")
    assert result["epoch"] == 3 and np.isfinite(result["train"].loss)
    assert os.listdir(cfg.profile_dir) == ["epoch2.pt.trace.json"]
    events = _events(os.path.join(cfg.profile_dir, "epoch2.pt.trace.json"))
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names)  # the step's ops were recorded
    # the program's spans, on the trace's time base: each step's forward
    # lies within the profiler's own events, and holds the step's convs
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") != "program"]
    lo, hi = min(e["ts"] for e in ops), max(e["ts"] + e["dur"] for e in ops)
    prog = [e for e in events if e.get("cat") == "program"]
    fwd = [e for e in prog if e["name"] == "step.forward"]
    assert len(fwd) == len([e for e in prog if e["name"] == "step"]) >= 1  # one a step
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in fwd)
    convs = [e for e in ops if e["name"] == "aten::conv2d"]
    assert all(any(f["ts"] <= c["ts"] <= f["ts"] + f["dur"] for f in fwd) for c in convs
               if any(f["tid"] == c["tid"] for f in fwd)) and convs


def test_a_failing_profiled_epoch_still_leaves_its_trace(data_dir, tmp_path, monkeypatch):
    real = train_lib._run_epoch
    calls = []

    def dying(cfg, loader, step_fn, lr, train):
        if train:
            calls.append(1)
            if len(calls) == 2:  # the profiled epoch dies after some work
                real(cfg, loader, step_fn, lr, train)
                raise RuntimeError("epoch died")
        return real(cfg, loader, step_fn, lr, train)

    monkeypatch.setattr(train_lib, "_run_epoch", dying)
    cfg = _cfg(data_dir, tmp_path)
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(RuntimeError, match="died"):
        train_lib.train(cfg, device="cpu")
    path = os.path.join(cfg.profile_dir, "epoch2.pt.trace.json")
    assert os.path.exists(path) and _events(path)
    # the dying epoch wrote no checkpoint; the one before it did
    assert sorted(os.listdir(cfg.ckpt_dir)) == ["model_epoch1.pth"]


def test_resume_profiles_the_second_epoch_of_the_run(data_dir, tmp_path):
    """Epoch start_epoch + 2: after a resume at epoch 1, epoch 3."""
    cfg = _cfg(data_dir, tmp_path, keep_ckpt=1)
    import dataclasses

    with contextlib.redirect_stdout(io.StringIO()):
        train_lib.train(dataclasses.replace(cfg, n_epoch=1, profile_dir=None), device="cpu")
        train_lib.train(dataclasses.replace(cfg, n_epoch=2), device="cpu")
    assert os.listdir(cfg.profile_dir) == ["epoch3.pt.trace.json"]
