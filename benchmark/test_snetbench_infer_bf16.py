"""CPU tests of the bf16 inference cell ``infer.unet_b.b128`` at a small
size, by its committed limits: a sound run comes out correct, a broken
answer does not, and the control (the reference's folded forward with
float8 e4m3 operands in every conv, in the program's place) does not."""

import argparse
import tempfile
import time

import pytest
import torch

from reference import unet_b as ref
from snetbench import compare, core, data
from snetbench.drivers import infer

CELL = "infer.unet_b.b128"
SMALL = {"batch": 4, "pool": 8, "side": 32, "calib": 4, "compute_dtype": "float32"}
SEED = 3_000_000_023  # above 2**31, as a run's seed may be


def small_run():
    wl = core.workload(core.benchmark_file(), CELL)
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.5, trace=0)
    r = core.Run(args, wl, core.config(wl["config"]), core.traffic(wl["traffic"]),
                 time.perf_counter(), device=torch.device("cpu"), small=SMALL)
    with tempfile.TemporaryDirectory() as tmp:
        r.tmpdir = tmp
        out = infer.run(r)
    ok, rows = core.judge(out.numbers, core.limits(CELL))
    return ok and out.failed == 0, rows, out


def test_a_sound_run_is_correct():
    ok, rows, out = small_run()
    assert ok, rows
    assert out.attempted > 0 and out.e2e["setup_s"] > 0


def test_an_answer_upside_down_is_not_correct(monkeypatch):
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor

    real = Predictor._compact_graph

    def altered(self, *a, **k):
        res = real(self, *a, **k)
        res["prob_u8"][0] = res["prob_u8"][0].flip(0)
        return res

    monkeypatch.setattr(Predictor, "_compact_graph", altered)
    ok, rows, _ = small_run()
    assert not ok, rows


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_float8_control_is_not_correct(seed):
    """bf16 -> float8 e4m3 operands in every conv of the reference's folded
    forward, against the float32 one."""
    cfg = core.config(core.workload(core.benchmark_file(), CELL)["config"])
    r = argparse.Namespace(device=torch.device("cpu"), config=cfg)
    w = data.make_weights(ref.leaves(), "he_normal", seed, "cpu")
    pool, _ = data.patch_pool(SMALL["pool"], SMALL["side"], seed, "cpu")
    _, base = infer.reference_answers(r, w, None, [pool])
    _, low = infer.reference_answers(r, w, None, [pool], lowp=ref.fp8_operands)
    ok, rows = core.judge(compare.answer_numbers(low, base), core.limits(CELL))
    assert not ok, rows
