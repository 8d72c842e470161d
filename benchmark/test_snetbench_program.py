"""The readers of the port's own spans and counters, on the CPU: a run of
each cell with ``--trace 0`` leaves the port's recorder empty; with a
profiled window the host-span readers read numbers; each new reader on
hand-made spans, and the idle split, the gap naming and the copy check of
``snetbench/program.py`` on hand-made intervals; the readers that were there
read what they read before; a fleet's counters over its window are the hand
count of the collectives a step (the CPU's plain global BatchNorm)."""

import os
import pickle
import time

import pytest
import torch

import program_spans
from selectivenet_for_semantic_segmentation_binary_torch.utils import tracing
from selectivenet_for_semantic_segmentation_binary_torch.utils.tracing import Span
from snetbench import core, program, trace
from snetbench.drivers import infer, train
from test_snetbench_runs import fleet_small_run, small_run

ONE_CELL = ("infer.unet_b_int8.b128", "train.unet_b.b128")
NEW = {"ingest_ms.infer": "predict.ingest", "feed_fill_ms.train": "loader.fill",
       "feed_assemble_ms.train": "loader.assemble"}
DEVICE = {"step_forward_ms.train": "step.forward", "step_backward_ms.train": "step.backward"}


@pytest.fixture
def fresh():
    """The recorder empty and off, and the readers' copy of it forgotten."""
    tracing.disable()
    tracing.take()
    program._taken = None
    yield
    tracing.take()
    program._taken = None


class CpuWindow(trace.Window):
    """The harness's window with the profiler on the CPU's activity, the
    only one a CPU build of torch has."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU])
        self._prof.__enter__()
        self.t0_ns = time.time_ns()
        self._t0 = time.perf_counter()
        return self


def _span(i, name, a, b, thread=1, parent=None, key=None, device_ms=None):
    return Span(i, parent, name, thread, a, b, key, device_ms)


@pytest.mark.parametrize("workload", ONE_CELL)
def test_trace_off_leaves_the_recorder_empty(workload, fresh):
    ok, numbers, _ = small_run(workload)
    assert ok, numbers
    assert tracing.take() == []


def _rank_reading(r, path, out):
    os.environ[program_spans.OUT_ENV] = out
    program_spans._rank(r, path)


def test_a_fleet_with_trace_off_records_nothing_and_counts_its_collectives(tmp_path,
                                                                           monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _, out = fleet_small_run(_rank_reading, str(tmp_path / "read.pkl"))
    with open(tmp_path / "read.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["spans"] == []
    steps = out.readings.steps
    c = got["window"]["counters"]
    assert steps % 8 == 0 and steps > 0
    # a step: 14 global BatchNorms (one all-reduce forward, one backward),
    # the two loss terms' sums (likewise), one gradient mean; the stop flag
    # every 8 steps. Bytes: (2c + 1) float32 each way a BatchNorm (c over
    # its layers 2,816), 2 + 3 float32 each way for the losses, the
    # 7,703,107 float32 gradients, an int32 flag.
    assert c["collective_calls"] == 33 * steps + steps // 8
    bn = 2 * (2 * 2816 + 14) * 4
    assert c["collective_bytes"] == (bn + 2 * 5 * 4 + 7_703_107 * 4) * steps + 4 * (steps // 8)


def test_host_span_readers_read_a_profiled_window(fresh, monkeypatch):
    monkeypatch.setattr(infer, "Window", CpuWindow)
    monkeypatch.setattr(train, "Window", CpuWindow)
    for workload in ONE_CELL:
        program._taken = None
        ok, numbers, out = small_run(workload)
        assert ok, numbers
        names = [m for m in NEW if m.endswith(".infer") == workload.startswith("infer")]
        for m in names:
            v = core.metric_reader(m)(out.readings)
            assert isinstance(v, float) and v > 0, m
        for m in DEVICE:  # device time exists only on the card
            assert core.metric_reader(m)(out.readings) is None
        spans = program.spans()
        if workload.startswith("train"):
            (fill,) = program.named(spans, "loader.fill")
            assert fill.key == 2  # the epoch the window's checked step starts
            assert {s.name for s in spans} >= {"step", "step.forward", "step.backward",
                                                "step.update", "loader.wait", "loader.copy"}
        else:
            calls = program.named(spans, "predict")
            assert len(calls) == out.readings.batches


def test_new_readers_on_hand_made_spans(fresh):
    r = core.Readings(window_s=1.0, chips=1)
    for m in list(NEW) + list(DEVICE):
        assert core.metric_reader(m)(r) is None  # nothing recorded
    program._taken = [
        _span(1, "predict.ingest", 0, 4_000_000), _span(2, "predict.ingest", 10, 6_000_010),
        _span(3, "loader.fill", 0, 12_000_000), _span(4, "loader.fill", 5, 8_000_005),
        _span(5, "loader.assemble", 0, 5_000_000, thread=2),
        _span(6, "step.forward", 0, 9, device_ms=60.0),
        _span(7, "step.forward", 0, 9, device_ms=62.0),
        _span(8, "step.backward", 0, 9, device_ms=100.0),
        _span(9, "step.backward", 0, 9),  # its events not read: no device time
    ]
    want = {"ingest_ms.infer": 5.0, "feed_fill_ms.train": 10.0, "feed_assemble_ms.train": 5.0,
            "step_forward_ms.train": 61.0, "step_backward_ms.train": 100.0}
    for m, v in want.items():
        assert core.metric_reader(m)(r) == pytest.approx(v), m


def test_a_program_without_the_recorder_reads_nothing(fresh, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules,
                        "selectivenet_for_semantic_segmentation_binary_torch.utils.tracing", None)
    r = core.Readings(window_s=1.0, chips=1)
    for m in list(NEW) + list(DEVICE):
        assert core.metric_reader(m)(r) is None


def test_idle_split_gaps_and_copies_on_hand_made_intervals():
    busy = [(10, 20), (30, 60), (70, 100)]
    spans = [_span(1, "predict", 0, 50), _span(2, "predict.ingest", 0, 12, parent=1),
             _span(3, "predict.fetch", 25, 50, parent=1),
             _span(4, "predict.ingest", 60, 75, thread=9)]  # another thread
    # idle in [0, 100): [0, 10), [20, 30), [60, 70)
    assert program.idle_in_pct(spans, "predict.ingest", 1, busy, 0, 100) == 10.0
    assert program.idle_in_pct(spans, "predict.fetch", 1, busy, 0, 100) == 5.0
    assert program.idle_in_pct(spans, "predict", 1, busy, 0, 100) == 20.0
    assert program.idle_in_pct(spans, "predict.forward", 1, busy, 0, 100) is None
    gaps = program.idle_gaps(spans, 1, busy, 0, 100, harness=[("feed_wait", 55, 80)])
    assert gaps == [["predict.ingest", 1e-8], ["predict.fetch", 1e-8], ["feed_wait", 1e-8]]
    assert program.idle_gaps(spans, 1, busy, 0, 110)[-1] == ["host", 1e-8]
    # copies: one inside a fetch, one starting 2 us before one, one in none
    fetch = [_span(1, "predict.fetch", 10_000, 20_000), _span(2, "predict.fetch", 30_000, 40_000)]
    got = program.copies_inside(fetch, "predict.fetch",
                                [(12_000, 18_000), (28_000, 32_000), (50_000, 51_000)])
    assert got["copies"] == 3 and got["outside"] == 1
    assert got["inside_pct"] == pytest.approx(100.0 * 8_000 / 11_000)
    assert got["worst_early_us"] == pytest.approx(2.0)


def test_the_readers_that_were_there_read_as_before():
    spans = trace.Spans()
    spans.items = [("feed_wait", 0, 2_000_000), ("feed_wait", 0, 4_000_000),
                   ("step", 0, 170_000_000)]
    r = core.Readings(window_s=20.0, chips=1, steps=100, batches=500, batch=128,
                      kernels=[("ncclDevKernel_AllReduce", 3000.0), ("int8_conv_wgmma", 2e6),
                               ("wgrad2d", 1e6)], busy_s=18.0, spans=spans)
    got = {m: core.metric_reader(m)(r) for m in
           ("step_mfu.train", "device_idle.train", "feed_wait_ms.train", "collective_ms.fleet",
            "forward_mfu.infer", "int8_conv_roofline.infer")}
    # the values these readers gave on these readings when they were written
    assert got == {"step_mfu.train": 14.275663542746209, "device_idle.train": 9.999999999999998,
                   "feed_wait_ms.train": 3.0, "collective_ms.fleet": 0.03,
                   "forward_mfu.infer": 12.415840165381725,
                   "int8_conv_roofline.infer": 149.39867644720007}
