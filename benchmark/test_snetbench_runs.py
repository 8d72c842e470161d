"""CPU tests that drive whole runs of the cells at a small size, past the
harness's look for a card: a sound run comes out correct; each fault the
cell can have, planted underneath the timed path, comes out not correct;
the control (the reference in the nearest lower precision put in the
program's place) comes out not correct; and the reference agrees with the
port's own pieces. The runs use float32 compute on the CPU, where the
program's only distance from the reference is rounding, and the cells'
committed limits."""

import argparse
import contextlib
import tempfile
import time

import numpy as np
import pytest
import torch

from reference import unet_b as ref
from snetbench import compare, core, data

SMALL = {
    "train.unet_b.b128": {"batch": 8, "side": 64, "pool": 24, "threads": 2,
                          "compute_dtype": "float32"},
    "infer.unet_b_int8.b128": {"batch": 4, "pool": 8, "side": 32, "calib": 4,
                               "compute_dtype": "float32"},
    "train.unet_b.fleet4": {"batch": 8, "side": 32, "pool": 32, "threads": 1,
                            "compute_dtype": "float32"},
}
SEED = 3_000_000_017  # above 2**31, as the driver's are
WINDOW_FROM = 4  # the first step of the window: set-up takes three


def cell(name: str) -> dict:
    return core.workload(core.benchmark_file(), name)


def small_run(workload: str, seconds: float = 0.5, seed: int = SEED):
    """One run of ``workload`` on the CPU at its small size: (correct,
    numbers, outcome), judged by the cell's committed limits."""
    wl = cell(workload)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
    tr = core.traffic(wl["traffic"])
    r = core.Run(args, wl, core.config(wl["config"]), tr, time.perf_counter(),
                 device=torch.device("cpu"), small=SMALL[workload])
    import importlib

    with tempfile.TemporaryDirectory() as tmp:
        r.tmpdir = tmp
        out = importlib.import_module(f"snetbench.drivers.{tr['kind']}").run(r)
    ok, _ = core.judge(out.numbers, core.limits(workload))
    return ok and out.failed == 0, out.numbers, out


@pytest.fixture
def one_thread(monkeypatch):
    """The fleet's four gloo ranks share the CPU: one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload, one_thread):
    ok, numbers, out = small_run(workload)
    assert ok, numbers
    assert out.attempted > 0 and out.e2e["setup_s"] > 0


# -- faults planted underneath the timed path ------------------------------------

@contextlib.contextmanager
def state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    yield


@contextlib.contextmanager
def half_batch(monkeypatch):
    from selectivenet_for_semantic_segmentation_binary_torch import train_lib

    real = train_lib.device_preprocess

    def half(batch):
        x, label = real(batch)
        n = x.shape[0] // 2
        return x[:n], label[:n]

    monkeypatch.setattr(train_lib, "device_preprocess", half)
    yield


@contextlib.contextmanager
def loss_altered(monkeypatch):
    from selectivenet_for_semantic_segmentation_binary_torch import train_lib

    real = train_lib._losses

    def altered(*a, **k):
        loss, extras, output, selection = real(*a, **k)
        return loss * 1.05, extras, output, selection

    monkeypatch.setattr(train_lib, "_losses", altered)
    yield


@contextlib.contextmanager
def compact_answer_altered(monkeypatch):
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor

    real = Predictor._compact_graph

    def altered(self, *a, **k):
        res = real(self, *a, **k)
        res["prob_u8"][0] = res["prob_u8"][0].flip(0)  # one answer upside down
        return res

    monkeypatch.setattr(Predictor, "_compact_graph", altered)
    yield


@contextlib.contextmanager
def compact_half_answered(monkeypatch):
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor

    real = Predictor._compact_graph

    def half(self, *a, **k):
        res = real(self, *a, **k)
        n = res["pred"].shape[0]
        for v in res.values():
            v[n // 2:] = 0
        return res

    monkeypatch.setattr(Predictor, "_compact_graph", half)
    yield


def _from_call(n: int, fault):
    """``fault`` in the program's ``n``-th train step and those after it:
    set-up's three steps stay sound, the window's are broken."""

    @contextlib.contextmanager
    def later(monkeypatch):
        from selectivenet_for_semantic_segmentation_binary_torch import train_lib

        real = train_lib.make_train_step

        def make(*a, **k):
            sound, calls = real(*a, **k), [0]

            def step(batch, lr):
                calls[0] += 1
                if calls[0] < n:
                    return sound(batch, lr)
                with pytest.MonkeyPatch.context() as mp, fault(mp):
                    return sound(batch, lr)

            return step

        monkeypatch.setattr(train_lib, "make_train_step", make)
        yield

    return later


@pytest.mark.parametrize("workload,fault", [
    ("train.unet_b.b128", state_unchanged),
    ("train.unet_b.b128", half_batch),
    ("train.unet_b.b128", loss_altered),
    ("train.unet_b.b128", _from_call(WINDOW_FROM, loss_altered)),
    ("train.unet_b.b128", _from_call(WINDOW_FROM, half_batch)),
    ("train.unet_b.b128", _from_call(WINDOW_FROM, state_unchanged)),
    ("infer.unet_b_int8.b128", compact_answer_altered),
    ("infer.unet_b_int8.b128", compact_half_answered),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    with fault(monkeypatch):
        ok, numbers, _ = small_run(workload)
    assert not ok, numbers


def _rank_with_fault(r, path, name):
    """A fleet rank with the fault ``name`` of ``snetbench/faults.py``
    planted: its gradients never averaged over the ranks, or its loss
    altered from the window's first step on."""
    from snetbench import faults
    from snetbench.drivers import fleet

    with faults.planted(name):
        fleet._rank(r, path)


def _rank_loading_jax(r, path):
    """A fleet whose rank 1 loads a module named jax during its run."""
    import sys
    import types

    import torch.distributed as dist
    from snetbench.drivers import fleet

    if dist.get_rank() == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    fleet._rank(r, path)


def fleet_small_run(target, *extra):
    """A run of the fleet cell on the CPU at its small size, its ranks
    ``target(run, path, *extra)``: (its arguments, its outcome)."""
    import os
    import pickle

    from selectivenet_for_semantic_segmentation_binary_torch.parallel import multihost
    from snetbench.drivers import fleet

    wl = core.workload(core.benchmark_file(), "train.unet_b.fleet4")
    args = argparse.Namespace(workload=wl["name"], seed=SEED, seconds=0.5, trace=0)
    r = core.Run(args, wl, core.config(wl["config"]), core.traffic(wl["traffic"]),
                 time.perf_counter(), device=torch.device("cpu"), small=SMALL[wl["name"]])
    with tempfile.TemporaryDirectory() as tmp:
        r.tmpdir = tmp
        path = os.path.join(tmp, "rank0.pkl")
        multihost.spawn(target, (r, path, *extra), nprocs=int(wl["chips"]))
        with open(path, "rb") as f:
            out = pickle.load(f)
        out.loaded = fleet.loaded_by_ranks(path, int(wl["chips"]))
    return args, out


@pytest.mark.parametrize("fault,number", [("no_exchange", "grad1_dir_gap"),
                                          ("loss_altered_in_window", "win_loss_gap")])
def test_a_fleet_without_the_exchange_is_not_correct(fault, number, one_thread):
    _, out = fleet_small_run(_rank_with_fault, fault)
    ok, rows = core.judge(out.numbers, core.limits("train.unet_b.fleet4"))
    assert not ok, rows
    assert out.numbers[number] > core.limits("train.unet_b.fleet4")[number]


def test_a_fleet_rank_that_loads_jax_refuses_the_result(one_thread, capsys):
    """The check of loaded modules covers every rank's interpreter, not only
    the process that prints."""
    args, out = fleet_small_run(_rank_loading_jax)
    assert out.loaded == ["rank 1: jax"]
    bench = core.benchmark_file()
    e2e, layer = core.cell_metrics(bench, args.workload)
    rc = core.report(args, out, core.limits(args.workload), e2e, layer)
    captured = capsys.readouterr()
    assert rc != 0 and '"correct"' not in captured.out
    assert "rank 1: jax" in captured.err


# -- the control ----------------------------------------------------------------

def test_training_control_is_not_correct(tmp_path):
    """``controls.py`` for the train cell at a small size on the CPU: the
    program's run comes out correct; the reference with float8 e4m3 operands
    in every conv in the program's place, half of each batch left out, steps
    that leave the state unchanged, the window's step taken on half its
    batch, and the program's loss altered from the window on, each not
    correct by the cell's limits (the window's step in float8 is a reading
    only: the set-up steps' numbers hold the control)."""
    import json

    import controls

    wl = "train.unet_b.b128"
    out = tmp_path / "readings.jsonl"
    controls.main(["--workload", wl, "--program-seeds", str(SEED), "--fault-seeds",
                   str(SEED + 1), "--control-seeds", str(SEED + 2), "--device", "cpu",
                   "--small", json.dumps({**SMALL[wl], "side": 32}), "--out", str(out)])
    lim = core.limits(wl)
    sides = {}
    for line in out.read_text().splitlines():
        r = json.loads(line)
        sides.setdefault(r["side"], []).append(
            core.judge(r["numbers"], {k: v for k, v in lim.items() if k in r["numbers"]})[0])
    assert sides.pop("program") == [True]
    assert sides.pop("window_control_fp8")
    assert sorted(sides) == ["control_fp8", "half_batch", "loss_altered_in_window",
                             "state_unchanged", "window_half_batch"]
    assert not any(any(v) for v in sides.values()), sides


@pytest.mark.parametrize("workload", ["infer.unet_b_int8.b128"])
def test_serving_control_is_not_correct(workload):
    """int8 -> int4 levels (qmax 7) in the program's place."""
    from snetbench.drivers import infer

    cfg, s = core.config(cell(workload)["config"]), SMALL[workload]
    r = argparse.Namespace(device=torch.device("cpu"), config=cfg)
    w = data.make_weights(ref.leaves(), "he_normal", SEED, "cpu")
    pool, _ = data.patch_pool(8, s["side"], SEED, "cpu")
    calib, _ = data.patch_pool(4, s["side"], SEED, "cpu", stream="calib")
    if cfg["quantize"] == "int8":
        _, base = infer.reference_answers(r, w, calib, [pool])
        _, low = infer.reference_answers(r, w, calib, [pool], qmax=7.0)
        low = [compare.from_compact(x) for x in low]
    else:
        _, base = infer.reference_answers(r, w, None, [pool])
        _, low = infer.reference_answers(r, w, None, [pool], lowp=ref.fp8_operands)
    ok, rows = core.judge(compare.answer_numbers(low, base),
                          {k: v for k, v in core.limits(workload).items()
                           if k in compare.answer_numbers(low, base)})
    assert not ok, rows


# -- the reference against the port's own pieces ------------------------------------

def test_reference_train_step_matches_the_port_in_float32():
    from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
    from selectivenet_for_semantic_segmentation_binary_torch.models import (
        build_model, load_weights)
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_train_step

    w = data.make_weights(ref.leaves(), "torch_default", 7, "cpu")
    x8, y8 = data.patch_pool(4, 32, 7, "cpu")
    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", s_lamb=2.0,
                      batch_size=4, patch_size=32, compute_dtype="float32")
    model = build_model("UNet_B", 2, True, "float32")
    load_weights(model, w)
    opt = build_optimizer(cfg, model.parameters())
    m = make_train_step(model, cfg, opt)({"input": torch.from_numpy(x8),
                                          "label": torch.from_numpy(y8)}, 1e-3)
    trainer = ref.Trainer(w, 1e-3, 2.0, 0.8)
    res = trainer.step(ref.normalize(torch.from_numpy(x8)), torch.from_numpy(y8))
    for k in compare.STEP_KEYS:
        assert float(m[k]) == pytest.approx(res[k], rel=1e-5)
    assert [int(v) for v in m["cm"].reshape(-1)] == res["cm"]
    assert int(m["n_reject"]) == res["n_reject"]
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(b, trainer.p[name], rtol=1e-5, atol=1e-6)


def test_reference_gradient_matches_the_port_in_float64():
    """The port's float32 BatchNorm backward on the CPU (channels_last) is
    accurate to ~6e-3 of a leaf's gradient norm at this size, so the
    gradients are held in float64, where both sides are exact to 1e-6."""
    from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
    from selectivenet_for_semantic_segmentation_binary_torch.models import (
        build_model, load_weights)
    from selectivenet_for_semantic_segmentation_binary_torch import train_lib

    w = data.make_weights(ref.leaves(), "torch_default", 7, "cpu")
    x8, y8 = data.patch_pool(4, 32, 7, "cpu")
    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", s_lamb=2.0,
                      batch_size=4, patch_size=32, compute_dtype="float32")
    model = build_model("UNet_B", 2, True, "float32")
    load_weights(model, w)
    model = model.double().train()
    x, label = train_lib.device_preprocess({"input": torch.from_numpy(x8),
                                            "label": torch.from_numpy(y8)})
    train_lib._losses(cfg, model(x.double()), label.float(), None, None)[0].backward()
    p = {k: v.double().requires_grad_(ref.trainable(k)) for k, v in w.items()}
    out, sel, aux = ref.forward(p, ref.normalize(torch.from_numpy(x8)).double(), True)
    total = ref.selective_loss(out, sel, aux, torch.from_numpy(y8), 2.0, 0.8)[0]
    names = [k for k in p if ref.trainable(k)]
    grads = dict(zip(names, torch.autograd.grad(total, [p[k] for k in names])))
    median = float(np.median([float(g.norm()) for g in grads.values()]))
    for name, param in model.named_parameters():
        scale = max(float(grads[name].norm()), median)
        assert float((param.grad - grads[name]).norm()) / scale < 1e-6, name


def test_reference_serving_pieces_match_the_port():
    from selectivenet_for_semantic_segmentation_binary_torch.ops.fold_bn import fold_batchnorm
    from selectivenet_for_semantic_segmentation_binary_torch.ops.quant import quantize_kernel
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor

    w = data.make_weights(ref.leaves(), "he_normal", 9, "cpu")
    folded = fold_batchnorm(w)
    f = ref.fold(w)
    for k, v in f.items():
        torch.testing.assert_close(v, folded[k], rtol=1e-6, atol=1e-7)
    for name, _, _ in ref.CBRS:
        q, s = ref.quantize_weights(f)[name]
        pq, ps = quantize_kernel(folded[f"{name}.0.weight"].numpy())
        assert np.array_equal(q.numpy(), pq.astype(np.float32))
        np.testing.assert_allclose(s.numpy(), ps, rtol=1e-6)
    x8, _ = data.patch_pool(4, 32, 9, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        from snetbench.drivers.infer import write_checkpoint

        path = write_checkpoint(w, tmp)
        p = Predictor(path, "UNet_B", selective=True, compute_dtype="float32", device="cpu")
        got = p.predict(x8)
        out, sel, _ = ref.folded_forward(f, ref.normalize(torch.from_numpy(x8)))
        np.testing.assert_allclose(got["prob"], torch.sigmoid(out).numpy(), atol=1e-5)
        np.testing.assert_allclose(got["selection_prob"], torch.sigmoid(sel).numpy(), atol=1e-5)
        compact = p.predict_compact(x8)
        mine = ref.compact(out, sel)
        for k in ("prob_u8", "selection_prob_u8"):
            assert np.abs(compact[k].astype(int) - mine[k].numpy().astype(int)).max() <= 1
        q8 = Predictor(path, "UNet_B", selective=True, compute_dtype="float32", quantize="int8",
                       calibration_images=x8, device="cpu")
        scales = ref.calibrate(f, torch.from_numpy(x8))
        for k, v in scales.items():
            assert q8._act_scales[k] == pytest.approx(v, rel=1e-5)
        got8 = q8.predict(x8)
        out8, _, _ = ref.w8a8_forward(f, ref.normalize(torch.from_numpy(x8)), scales)
        assert np.abs(got8["prob"] - torch.sigmoid(out8).numpy()).mean() < 2e-3


def test_loader_plan_is_the_loaders_order_and_flips():
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader

    x8, y8 = data.patch_pool(12, 16, 5, "cpu")
    loader = PatchLoader(data.PoolDataset(x8, y8), 4, num_workers=2, shuffle=True,
                         drop_last=True, seed=SEED, random_flip=True)
    loader.set_epoch(1)
    for k, batch in enumerate(loader):
        rows, flips = data.loader_plan(SEED, 1, k, 4, 12)
        assert np.array_equal(batch["input"].numpy(), x8[rows])
        assert np.array_equal(batch["flips"].numpy().astype(bool), flips)


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(cuda_card):
    """The whole command on the card, at a short window: the result line is
    correct (python -m pytest benchmark -m card, on a machine with a card)."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, os.path.join(here, "run.py"), "--workload",
                          "train.unet_b.b128", "--seed", str(SEED), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=os.path.dirname(here), timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"], out.stderr[-2000:]
