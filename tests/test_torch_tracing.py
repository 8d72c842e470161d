"""The port's span recorder (``utils/tracing.py``) and the spans and counters
of its four traced layers, on the CPU: off it is a shared no-op that records
nothing and makes no CUDA event; on, parents, keys and times hold across
nesting and threads; a profiler session turns it on and holds only its own
spans; a ``Predictor`` call, a ``PatchLoader`` epoch and a
train step give their spans; the counted collective helper counts calls and
bytes (a one-process gloo group, torn down at the end)."""

import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
from selectivenet_for_semantic_segmentation_binary_torch.models import build_model
from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
from selectivenet_for_semantic_segmentation_binary_torch.parallel import mesh, multihost
from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_train_step
from selectivenet_for_semantic_segmentation_binary_torch.utils import tracing

CPU = torch.device("cpu")


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty after."""
    tracing.take()
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.take()


@pytest.fixture
def no_cuda_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_tracing") / "model_epoch1.pth")
    torch.save({"net": seeded_model(5, "float32", selective=True).state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """One process as a gloo group of one."""
    store = tmp_path_factory.mktemp("tracing_store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


class _Patches:
    """Raw 8x8 patches whose pixels are the sample's index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_raw(self, i):
        return np.full((8, 8, 3), i, np.uint8), (np.arange(64).reshape(8, 8) % 2).astype(
            np.uint8)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _train_step(pg=None):
    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", batch_size=2,
                      patch_size=16, compute_dtype="float32")
    torch.manual_seed(0)
    model = build_model("UNet_B", 2, True, "float32")
    step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()), pg)
    rng = np.random.default_rng(0)
    batch = {"input": torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)),
             "label": torch.from_numpy(rng.integers(0, 2, (2, 16, 16), dtype=np.uint8))}
    return step, batch


def test_off_is_a_shared_noop_that_records_nothing(ckpt, no_cuda_event):
    tracing.disable()
    tracing.take()
    spans = [tracing.span("a"), tracing.span("b", key=(1, 2), device=True),
             tracing.span("c", device=torch.device("cuda", 0))]
    assert all(s is tracing._NOOP for s in spans)
    with spans[1] as inner:
        assert inner is tracing._NOOP
    images = np.random.default_rng(1).integers(0, 256, (1, 16, 16, 3), dtype=np.uint8)
    Predictor(ckpt, selective=True, compute_dtype="float32", device="cpu").predict_compact(
        images)
    step, batch = _train_step()
    step(batch, 1e-3)
    assert tracing.take() == []


def test_parents_keys_and_threads(recorder):
    def work(tag):
        with tracing.span("outer", key=tag):
            with tracing.span("inner", key=tag):
                time.sleep(0.01)
            with tracing.span("inner2", key=tag):
                pass

    threads = [threading.Thread(target=work, args=(t,)) for t in ("x", "y")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    work("main")
    spans = tracing.take()
    assert tracing.take() == []
    assert len(spans) == 9 and len({s.id for s in spans}) == 9
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "outer":
            assert s.parent is None
        else:  # the outer span of its own thread and key
            p = by_id[s.parent]
            assert (p.name, p.key, p.thread) == ("outer", s.key, s.thread)
    assert len({s.thread for s in spans}) == 3
    assert all(s.device_ms is None for s in spans)
    assert [s.start_ns for s in spans] == sorted(s.start_ns for s in spans)


def test_spans_lie_on_the_time_ns_clock(recorder):
    t0 = time.time_ns()
    with tracing.span("a"):
        t1 = time.time_ns()
        time.sleep(0.002)
        t2 = time.time_ns()
    t3 = time.time_ns()
    (s,) = tracing.take()
    assert t0 <= s.start_ns <= t1 and t2 <= s.end_ns <= t3
    assert s.end_ns - s.start_ns >= 2_000_000


def test_a_predict_compact_call_gives_its_three_phases(recorder, ckpt):
    pred = Predictor(ckpt, selective=True, compute_dtype="float32", device="cpu")
    tracing.take()
    images = np.random.default_rng(2).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    out = pred.predict_compact(images)
    assert out["pred"].shape == (2, 16, 16)
    spans = _by_name(tracing.take())
    assert sorted(spans) == ["predict", "predict.fetch", "predict.forward", "predict.ingest"]
    (top,) = spans["predict"]
    phases = [spans[n][0] for n in ("predict.ingest", "predict.forward", "predict.fetch")]
    assert all(p.parent == top.id and p.key == top.key for p in phases)
    assert top.start_ns <= phases[0].start_ns and phases[-1].end_ns <= top.end_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))


def test_a_profiler_session_records_only_its_own_spans():
    tracing.disable()
    tracing.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("first", key=1):
            pass
    with tracing.span("between"):  # no session, recorder off
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("second", key=2):
            pass
    with tracing.span("after"):
        pass
    # the untaken span of the first session went when the second began
    assert [(s.name, s.key) for s in tracing.take()] == [("second", 2)]
    assert tracing.take() == []


def test_a_loader_epoch_gives_fill_assemblies_waits_and_copies(recorder):
    loader = PatchLoader(_Patches(13), 4, num_workers=2, shuffle=True, drop_last=True, seed=3)
    loader.set_epoch(7)
    batches = list(loader)
    assert len(batches) == 3
    spans = _by_name(tracing.take())
    (fill,) = spans["loader.fill"]
    assert fill.key == 7 and fill.parent is None
    keys = [(7, i) for i in range(3)]
    assert sorted(s.key for s in spans["loader.assemble"]) == keys
    # a wait for each batch and one for the end of the epoch, in order
    assert [s.key for s in spans["loader.wait"]] == keys + [(7, 3)]
    assert [s.key for s in spans["loader.copy"]] == keys
    first_wait = spans["loader.wait"][0]
    assert first_wait.parent == fill.id and first_wait.thread == fill.thread
    assert all(s.thread != fill.thread for s in spans["loader.assemble"])
    for s in spans.get("loader.put_blocked", []):
        assert s.key in keys + [(7, 3)]


def test_a_train_step_gives_its_phases_and_the_exchange_only_on_a_group(recorder, group):
    for pg, names in ((None, ["step.forward", "step.backward", "step.update"]),
                      (group, ["step.forward", "step.backward", "step.exchange",
                               "step.update"])):
        step, batch = _train_step(pg)
        tracing.take()
        m = step(batch, 1e-3)
        assert np.isfinite(float(m["loss"]))
        spans = tracing.take()
        (top,) = [s for s in spans if s.name == "step"]
        children = [s for s in spans if s.parent == top.id]
        assert [s.name for s in children] == names
        assert all(top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns for s in children)
        assert all(s.device_ms is None for s in spans)  # a CPU step: host time only


def test_counted_collectives(group):
    calls, nbytes = mesh.collective_calls, mesh.collective_bytes
    x = torch.arange(10, dtype=torch.float32)
    assert torch.equal(mesh.all_reduce_(x, group), torch.arange(10, dtype=torch.float32))
    flag = torch.ones(3, dtype=torch.int32)
    assert torch.equal(mesh.broadcast_(flag, 0, group), torch.ones(3, dtype=torch.int32))
    assert (mesh.collective_calls - calls, mesh.collective_bytes - nbytes) == (2, 52)
    mesh.all_reduce_(x, None)  # no group: no collective, no count
    mesh.broadcast_(flag, 0, None)
    assert multihost.broadcast_flag(True, group) and multihost.agree(True, group)
    assert (mesh.collective_calls - calls, mesh.collective_bytes - nbytes) == (4, 60)
    y = torch.ones(4, requires_grad=True)
    mesh.all_reduce_sum(y, group).sum().backward()  # one forward, one backward
    assert torch.equal(y.grad, torch.ones(4))
    assert (mesh.collective_calls - calls, mesh.collective_bytes - nbytes) == (6, 92)
