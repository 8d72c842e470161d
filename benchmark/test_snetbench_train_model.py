"""CPU dry runs of ``drivers/train_model.py`` (the TransUNet cell) at a small
size: a sound run comes out correct by the cell's committed limits; the
float8 control (over the first three steps and over the window's step), half
of each batch left out (both ways), steps that leave the state unchanged and
the program's loss altered from the window on each come out not correct; and
the reference's leaves are the port model's state dict."""

import argparse
import json
import tempfile
import time

import torch

from snetbench import core
from snetbench.drivers import train_model

CELL = "train.transunet_r50b16.b128"
SMALL = {"batch": 8, "side": 32, "pool": 24, "threads": 2, "compute_dtype": "float32",
         "dims": {"width": 32, "units": [1, 1, 1], "hidden": 64, "layers": 2, "heads": 2,
                  "mlp_dim": 256, "head_channels": 64, "decoder": [64, 32, 16, 16]}}
SEED = 3_000_000_019  # above 2**31, as a run's seed may be


def test_a_sound_run_is_correct():
    wl = core.workload(core.benchmark_file(), CELL)
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.5, trace=0)
    r = core.Run(args, wl, core.config(wl["config"]), core.traffic(wl["traffic"]),
                 time.perf_counter(), device=torch.device("cpu"), small=SMALL)
    with tempfile.TemporaryDirectory() as tmp:
        r.tmpdir = tmp
        out = train_model.run(r)
    ok, rows = core.judge(out.numbers, core.limits(CELL))
    assert ok and out.failed == 0, rows
    assert out.attempted > 0 and out.e2e["setup_s"] > 0
    assert out.readings.counters["transunet.attention_calls"] == 2 * out.attempted


def test_the_controls_and_faults_are_not_correct(tmp_path):
    import controls

    path = tmp_path / "readings.jsonl"
    controls.main(["--workload", CELL, "--program-seeds", str(SEED), "--fault-seeds",
                   str(SEED + 1), "--device", "cpu", "--small", json.dumps(SMALL),
                   "--seconds", "0.5", "--out", str(path)])
    lim = core.limits(CELL)
    sides = {}
    for line in path.read_text().splitlines():
        r = json.loads(line)
        judged = {k: v for k, v in lim.items() if k in r["numbers"]}
        sides[r["side"]] = core.judge(r["numbers"], judged)[0]
    assert sides.pop("program") is True
    assert sorted(sides) == ["loss_altered_in_window", "window_control_fp8",
                             "window_first3_control_fp8", "window_first3_half_batch",
                             "window_first3_state_unchanged", "window_half_batch"]
    assert not any(sides.values()), sides


def test_the_reference_leaves_are_the_port_state_dict():
    from reference import transunet as ref
    from selectivenet_for_semantic_segmentation_binary_torch.models import build_model

    with torch.device("meta"):
        model = build_model("TransUNet", selective=True, compute_dtype="bfloat16")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert {n: s for n, s, _, _ in ref.leaves()} == want
