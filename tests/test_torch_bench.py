"""The port's benchmark (``..._torch/bench.py``) at a tiny size on the CPU:
the JSON line's keys (the JAX ``bench.py``'s less ``ceiling_x`` and
``emitter_gap_x``, plus ``batch_size`` and ``card``); the batch shrinks only
on ``torch.cuda.OutOfMemoryError``; any other error, in either half,
propagates; without a card the process exits non-zero."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch import bench

@pytest.fixture
def tiny(monkeypatch):
    """The bench at 32x32, batch 2, one warm-up and one timed step."""
    for name, value in (("PATCH", 32), ("WARMUP_STEPS", 1), ("TIMED_STEPS", 1),
                        ("BATCHES", (2,))):
        monkeypatch.setattr(bench, name, value)


@pytest.mark.parametrize("bn_stats", ["float32", "bfloat16"])
def test_line_has_the_jax_keys_and_no_tpu_derivations(bn_stats, tiny, capsys):
    line = bench.main([bn_stats], device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "eval_value", "batch_size",
                         "bn_stats", "card"}
    assert "ceiling_x" not in line and "emitter_gap_x" not in line
    assert line["value"] > 0 and line["eval_value"] > 0 and line["batch_size"] == 2
    assert line["vs_baseline"] == round(line["value"] / 200.0, 3)
    assert line["metric"] == "train_patches_per_sec_per_chip_32px"
    assert line["card"] == "none (cpu)" and line["bn_stats"] == bn_stats


def test_run_and_run_eval_are_finite(tiny):
    assert np.isfinite(bench.run(2, device="cpu"))
    assert np.isfinite(bench.run_eval(2, device="cpu"))


def _oom(*a, **k):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


def test_oom_shrinks_the_batch(monkeypatch):
    tried = []

    def run(batch_size, *a):
        tried.append(batch_size)
        if batch_size > 32:
            _oom()
        return 123.0

    monkeypatch.setattr(bench, "run", run)
    monkeypatch.setattr(bench, "run_eval", lambda batch_size, *a: 456.0)
    line = bench.main([], device="cpu")
    assert tried == [128, 64, 32] and line["batch_size"] == 32
    assert line["value"] == 123.0 and line["eval_value"] == 456.0


def test_oom_at_every_batch_raises(monkeypatch):
    monkeypatch.setattr(bench, "run", _oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench.main([], device="cpu")


@pytest.mark.parametrize("half", ["run", "run_eval"])
def test_other_errors_propagate(half, monkeypatch):
    """No shrinking and no swallowing: the JAX bench.py:152-165 caught every
    exception, the eval half's included."""
    tried = []

    def broken(batch_size, *a):
        tried.append(batch_size)
        raise ValueError("broken " + half)

    monkeypatch.setattr(bench, half, broken)
    if half == "run_eval":
        monkeypatch.setattr(bench, "run", lambda *a: 1.0)
    with pytest.raises(ValueError, match="broken"):
        bench.main([], device="cpu")
    assert tried == [128]


def test_without_a_card_the_process_exits_nonzero():
    run = subprocess.run([sys.executable, "-c",
                          "import torch; torch.cuda.is_available = lambda: False; "
                          "from selectivenet_for_semantic_segmentation_binary_torch import "
                          "bench; bench.main([])"], capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and "no CUDA device" in run.stderr
    assert run.stdout.strip() == ""
