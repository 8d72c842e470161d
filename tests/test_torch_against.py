"""The ``--against`` plumbing of the port's entry points, on the CPU: which
source of another commit's ``kernels/`` directory each comparison builds
(``other_k3``, ``other_k6``, ``other_k1``), that a missing source raises,
and that ``kernel_path`` of CPU tensors names the plain version for K1 and
K6 without building anything. The comparisons themselves run on the card
(``chip_smoke.py --against``)."""

import ctypes
import os
from unittest import mock

import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch import kernels
from selectivenet_for_semantic_segmentation_binary_torch.ops import eval_metrics as em
from selectivenet_for_semantic_segmentation_binary_torch.ops import transposed_cbr as tc
from selectivenet_for_semantic_segmentation_binary_torch.scripts import (
    eval_metrics_against,
    proto_fused_cbr,
    proto_transposed_cbr,
)

# (comparison, the files of the other kernels/ directory, the source and the
# build name it must hand to kernels.build_other)
CASES = {
    "k3_staged_tile": (proto_fused_cbr.other_k3, ("fused_cbr_rows.cu", "fused_conv_stats.cu"),
                       "fused_cbr_rows.cu", "fused_cbr_rows"),
    "k3_band_kernel": (proto_fused_cbr.other_k3, ("fused_conv_stats.cu",),
                       "fused_conv_stats.cu", "fused_conv_stats"),
    "k6": (proto_transposed_cbr.other_k6, ("transposed_cbr.cu",), "transposed_cbr.cu",
           "transposed_cbr"),
    "k1_one_launch": (eval_metrics_against.other_k1, ("eval_metrics.cu",), "eval_metrics.cu",
                      "eval_metrics"),
    "k1_per_block_rows": (eval_metrics_against.other_k1, ("eval_metrics.cu",),
                          "eval_metrics.cu", "eval_metrics"),
}


def _fake_library(case: str) -> mock.MagicMock:
    lib = mock.MagicMock()
    lib.eval_metrics_counters.return_value = 6
    if case == "k1_per_block_rows":  # the interface before the one-launch kernel
        del lib.eval_metrics_grid
    return lib


@pytest.mark.parametrize("case", sorted(CASES))
def test_other_builds_take_the_right_source(monkeypatch, tmp_path, case):
    fn, files, src, name = CASES[case]
    for f in files:
        (tmp_path / f).write_text("// another commit's source\n")
    built = []
    lib = _fake_library(case)
    monkeypatch.setattr(kernels, "build_other",
                        lambda path, n: built.append((path, n)) or lib)
    run = fn(str(tmp_path))
    assert callable(run)
    assert built == [(os.path.join(str(tmp_path), src), name)]
    if case.startswith("k1"):
        # the one-launch interface is declared through ops/eval_metrics.bind;
        # the earlier one takes its own argument list
        grid = getattr(lib, "eval_metrics_grid", None)
        assert (grid is not None and grid.argtypes == [ctypes.c_int64]) == (
            case == "k1_one_launch")
        assert len(lib.eval_metrics_launch.argtypes) == 13


@pytest.mark.parametrize("fn", [proto_fused_cbr.other_k3, proto_transposed_cbr.other_k6,
                                eval_metrics_against.other_k1],
                         ids=["k3", "k6", "k1"])
def test_other_builds_raise_on_a_missing_source(tmp_path, fn):
    """No comparison is skipped quietly: an empty directory raises before
    any compiler runs."""
    with pytest.raises(FileNotFoundError, match="is missing"):
        fn(str(tmp_path))


def test_kernel_path_of_cpu_tensors_is_the_plain_version():
    x = torch.zeros((4, 32, 6, 3), dtype=torch.bfloat16)
    assert tc.kernel_path(x) == "plain"
    out = torch.zeros((2, 5, 7))
    lab = torch.zeros((2, 5, 7), dtype=torch.uint8)
    assert em.kernel_path(out, lab) == "plain" and em.kernel_path(out, lab, out) == "plain"
    assert tc._lib is None and em._lib is None


@pytest.mark.parametrize("kernel_path", [tc.kernel_path, lambda t: em.kernel_path(t, t)],
                         ids=["k6", "k1"])
def test_kernel_path_refuses_other_devices(kernel_path):
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernel_path(torch.empty((2, 8, 4, 8), device="meta"))


@pytest.mark.parametrize("generation, n_args", [("stats_whole", 17), ("sums_only", 16)])
def test_other_k9_takes_either_interface(monkeypatch, generation, n_args):
    """bisect_against declares K9's launcher as the other build has it: the
    wgmma builds (which export bisect_vector_path) take the stats output's
    size after its pointer, the builds before them a (c,) sums pointer."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts import bisect_against

    lib = mock.MagicMock()
    if generation == "sums_only":
        del lib.bisect_vector_path
    monkeypatch.setattr(kernels, "build_other", lambda path, n: lib)
    assert bisect_against.build_other("OTHER.cu") is lib
    assert lib.k9_stats_whole == (generation == "stats_whole")
    assert len(lib.bisect_k9_launch.argtypes) == n_args
