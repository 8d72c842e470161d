"""Training traffic: a closed loop of the port's train steps
(``train_lib.make_train_step``) fed by its ``PatchLoader`` from a seeded pool
of uint8 patches in host memory, with shuffle, random flips, the raw uint8
feed and device preprocessing; epochs restart inside the window as they do in
a fold.

Set-up builds the step once (model, Adam state, loader), drives it through
its first three steps on the window's own feed and call, keeping what those
steps produced (their losses and counts, the first step's gradient as Adam
got it, the parameters and running statistics after the third), and hands
the same objects to the window. After the window the program is freed and
the plain reference follows the same three steps from the same weights on
the same rows, which it works out again from the seed
(``data.loader_plan``).

Inside the window the step that starts the first new epoch is the window's
checked step: just before it the program's state (parameters, running
statistics, Adam's moments and step count) is copied once, and after it its
loss terms, counts and parameters are kept. After the window the reference
takes that step again from that state on the same rows
(``compare.window_numbers``), so the feed's epoch restart and a step deep
into Adam's run are compared too. The window runs on past ``--seconds``
until that step has been taken (the first epoch's end: 29 steps in after the
three of set-up at the cells' sizes, well inside their windows).

On a fleet (``drivers/fleet.py``) every rank runs this with its process
group: its loader yields the rank's rows of each global batch, and rank 0
reports the fleet's totals and compares the fleet's global step with the
reference's one-process step on the global batch.

Traffic keys: ``batch`` (global), ``pool`` (patches), ``threads`` (decode
threads), ``init`` (``data.make_weights``' scheme), ``throughput_metric``
(the name of the cell's patches a second), ``stop_every`` (steps between the
fleet's stop checks).
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import compare, core, data
from ..trace import Spans, Window

WARM_STEPS = 3


class Feed:
    """The loader across epochs: ``next()`` the next batch, a new epoch
    (``set_epoch``, a new iterator) when one ends; the wait in each call is
    the ``feed_wait`` span."""

    def __init__(self, loader, spans: Spans):
        self.loader, self.spans = loader, spans
        self.epoch, self.index, self._it = 0, -1, None  # of the last batch given

    def next(self):
        with self.spans.mark("feed_wait"):
            while True:
                if self._it is None:
                    self.epoch += 1
                    self.index = -1
                    self.loader.set_epoch(self.epoch)
                    self._it = iter(self.loader)
                b = next(self._it, None)
                if b is not None:
                    self.index += 1
                    return b
                self._it = None

    def close(self) -> None:
        if self._it is not None:
            self._it.close()
            self._it = None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sizes(r) -> dict:
    small = r.small or {}
    return {"batch": small.get("batch", r.traffic["batch"]),
            "side": small.get("side", r.config["patch_size"]),
            "pool": small.get("pool", r.traffic["pool"]),
            "threads": small.get("threads", r.traffic["threads"]),
            "compute_dtype": small.get("compute_dtype", r.config["compute_dtype"])}


def build(r, s: dict, weights, pool, rank: int, world: int, pg):
    """The program's train step, its model and optimizer, and its loader."""
    from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
    from selectivenet_for_semantic_segmentation_binary_torch.models import (
        build_model, load_weights, set_process_group)
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_train_step

    c = r.config
    tcfg = TrainConfig(model_arch=c["model_arch"], selective=c["selective"], loss=c["loss"],
                       s_lamb=c["s_lamb"], target_coverage=c["target_coverage"],
                       optim=c["optimizer"], lr=c["lr"], patch_size=s["side"],
                       batch_size=s["batch"], compute_dtype=s["compute_dtype"],
                       bn_stats=c["bn_stats"], fused_cbr=c["fused_cbr"],
                       num_workers=s["threads"], drop_last=True)
    model = build_model(tcfg.model_arch, tcfg.n_cls, tcfg.selective, tcfg.compute_dtype,
                        bn_stats=tcfg.bn_stats).to(r.device)
    load_weights(model, weights)
    if pg is not None:
        set_process_group(model, pg)
    optimizer = build_optimizer(tcfg, model.parameters())
    step = make_train_step(model, tcfg, optimizer, pg)
    loader = PatchLoader(data.PoolDataset(*pool), s["batch"], num_workers=s["threads"],
                         device=r.device, shuffle=True, drop_last=True, seed=r.args.seed,
                         random_flip=True, device_preproc=True, process_index=rank,
                         process_count=world)
    return step, model, optimizer, loader


def _step_record(m: dict) -> dict:
    return {k: m[k].detach().clone() for k in
            ("loss", "aux_loss", "sel_loss", "coverage", "cm", "n_pix", "n_reject")}


def _host_step(rec: dict) -> dict:
    out = {k: float(rec[k]) for k in compare.STEP_KEYS}
    out["cm"] = [int(v) for v in rec["cm"].reshape(-1).tolist()]
    out["n_pix"], out["n_reject"] = int(rec["n_pix"]), int(rec["n_reject"])
    return out


def _rows(r, s: dict, pool, epoch: int, k: int, rows_kept: Optional[int]):
    """The images (normalised) and labels of step ``k`` of ``epoch`` on the
    device, as the reference takes them."""
    from reference import unet_b as ref

    rows, flips = data.loader_plan(r.args.seed, epoch, k, s["batch"], len(pool[0]))
    x, y = data.flipped(pool[0][rows], pool[1][rows], flips)
    if rows_kept is not None:
        x, y = x[:rows_kept], y[:rows_kept]
    return (ref.normalize(torch.from_numpy(x).to(r.device)),
            torch.from_numpy(np.ascontiguousarray(y)).to(r.device))


def reference(r, s: dict, weights, pool, lowp=None, rows_kept: Optional[int] = None,
              update: bool = True) -> dict:
    """The reference's first three steps on the rows the feed gave the
    program (``rows_kept``: a fault that trains on only the first rows;
    ``update=False``: one whose steps leave the state unchanged)."""
    from reference import unet_b as ref

    c = r.config
    trainer = ref.Trainer(weights, c["lr"], c["s_lamb"], c["target_coverage"], lowp, update)
    steps, grads1 = [], None
    for k in range(WARM_STEPS):
        res = trainer.step(*_rows(r, s, pool, 1, k, rows_kept))
        if k == 0:
            grads1 = res.pop("grads")
        else:
            res.pop("grads")
        steps.append(res)
    params = {k: v for k, v in trainer.p.items() if ref.trainable(k)}
    bn = {k: v for k, v in trainer.p.items() if not ref.trainable(k)}
    return {"steps": steps, "grads1": grads1, "params3": params, "bn3": bn}


def window_reference(r, s: dict, pool, snap: dict, lowp=None,
                     rows_kept: Optional[int] = None) -> dict:
    """The reference's step from the program's state ``snap`` (taken just
    before the window's checked step) on that step's rows."""
    from reference import unet_b as ref

    c = r.config
    trainer = ref.Trainer(snap["state"], c["lr"], c["s_lamb"], c["target_coverage"], lowp,
                          moments=(snap["exp_avg"], snap["exp_avg_sq"], snap["t"]))
    res = trainer.step(*_rows(r, s, pool, snap["epoch"], snap["index"], rows_kept))
    grads = res.pop("grads")
    return {"step": res, "grads": grads,
            "params": {k: v for k, v in trainer.p.items() if ref.trainable(k)}}


def _snapshot(model, optimizer, feed) -> dict:
    """The program's state before a step: parameters and running statistics
    under the reference's names, Adam's moments and its step count."""
    state = {n: p.detach().clone() for n, p in model.named_parameters()}
    state.update({n: b.detach().clone() for n, b in model.named_buffers()
                  if n.endswith(("running_mean", "running_var"))})
    # an optimizer that never stepped holds no moments: they read 0
    moment = lambda p, k: optimizer.state[p].get(k, torch.zeros_like(p)).clone()  # noqa: E731
    params = list(model.named_parameters())
    return {"state": state, "epoch": feed.epoch, "index": feed.index,
            "exp_avg": {n: moment(p, "exp_avg") for n, p in params},
            "exp_avg_sq": {n: moment(p, "exp_avg_sq") for n, p in params},
            "t": int(optimizer.state[params[0][1]].get("step", 0))}


def _fleet_counts(records, pg) -> None:
    """The counts are each rank's: the fleet's are their sum."""
    if pg is None:
        return
    for rec in records:
        for key in ("cm", "n_pix", "n_reject"):
            dist.all_reduce(rec[key], group=pg)


def run(r) -> core.Outcome:
    return train_cell(r)


def train_cell(r, rank: int = 0, world: int = 1, pg=None) -> Optional[core.Outcome]:
    """Set-up, window and check of one rank; rank 0 returns the outcome."""
    from reference import unet_b as ref
    from selectivenet_for_semantic_segmentation_binary_torch.parallel.multihost import (
        broadcast_flag)

    device = r.device
    s = sizes(r)
    spans = Spans()
    weights = data.make_weights(ref.leaves(), r.traffic["init"], r.args.seed, device)
    pool = data.patch_pool(s["pool"], s["side"], r.args.seed, device)
    step, model, optimizer, loader = build(r, s, weights, pool, rank, world, pg)
    feed = Feed(loader, spans)
    lr = r.config["lr"]
    beta1 = optimizer.param_groups[0]["betas"][0]

    records, grads1 = [], None
    for k in range(WARM_STEPS):
        m = step(feed.next(), lr)
        records.append(_step_record(m))
        if k == 0:
            # a step that moved nothing left no moments: its gradient reads 0
            grads1 = {n: optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - beta1)
                      for n, p in model.named_parameters()}
    params3 = {n: p.detach().clone() for n, p in model.named_parameters()}
    bn3 = {n: b.detach().clone() for n, b in model.named_buffers()
           if n.endswith(("running_mean", "running_var"))}
    _fleet_counts(records, pg)
    _sync(device)
    setup_s = time.perf_counter() - r.t0

    spans.clear()
    window = Window(bool(r.args.trace), device.index or 0, r.tmpdir)
    stop_every = int(r.traffic.get("stop_every", 8))
    steps, snap, checked = 0, None, None
    with window:
        deadline = time.perf_counter() + r.args.seconds
        while True:
            batch = feed.next()
            if snap is None and feed.index == 0:  # the window's checked step
                snap = _snapshot(model, optimizer, feed)
            with spans.mark("step"):
                m = step(batch, lr)
            if checked is None and snap is not None:
                checked = {"step": _step_record(m),
                           "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
            steps += 1
            done = checked is not None and time.perf_counter() >= deadline
            if pg is None:
                if done:
                    break
            elif steps % stop_every == 0:  # rank 0's clock decides for every rank
                if broadcast_flag(done, pg):
                    break
        window.close(lambda: _sync(device))
    failed = 0 if bool(torch.isfinite(m["loss"])) else steps
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    busy = window.busy_s
    if pg is not None:  # the fleet's busy time is its cards' mean, its peak the fullest's
        t = torch.tensor([busy or 0.0], dtype=torch.float64, device=device)
        dist.all_reduce(t, group=pg)
        busy = float(t) / world if busy is not None else None
        t = torch.tensor([float(peak)], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=pg)
        peak = int(t)

    _fleet_counts([checked["step"]], pg)
    prog = {"steps": [_host_step(rec) for rec in records], "grads1": grads1,
            "params3": params3, "bn3": bn3}
    prog_win = {"step": _host_step(checked["step"]), "params": checked["params"]}
    feed.close()
    del step, model, optimizer, loader, feed, batch, m, checked
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    numbers = compare.train_numbers(prog, reference(r, s, weights, pool), weights)
    ref_win = window_reference(r, s, pool, snap)
    numbers.update(compare.window_numbers(prog_win, ref_win, snap["state"]))
    controls = {}
    if r.controls:  # the window step's control and fault, from the same state
        for name, kw in (("control_fp8", {"lowp": ref.fp8_operands}),
                         ("half_batch", {"rows_kept": s["batch"] // 2})):
            controls[name] = compare.window_numbers(window_reference(r, s, pool, snap, **kw),
                                                    ref_win, snap["state"])
    del snap, ref_win

    patches = steps * s["batch"]
    readings = core.Readings(window_s=window.seconds, chips=world, steps=steps,
                             batch=s["batch"], kernels=window.kernels,
                             busy_s=window.busy_s, spans=spans)
    outcome = core.Outcome(
        e2e={"setup_s": setup_s, r.traffic["throughput_metric"]: patches / window.seconds},
        readings=readings, numbers=numbers, attempted=steps, failed=failed,
        memory_peak_bytes=peak,
        kind=torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        count=world, busy_s=busy)
    outcome.controls = controls
    outcome.notes.append(f"train: {steps} steps of {s['batch']} in {window.seconds:.4f} s, "
                         f"set-up {setup_s:.3f} s, checked step {prog_win['step']['loss']!r} "
                         f"(loss)")
    if r.args.trace:
        outcome.breakdown = {"device_ops": window.top_kernels(),
                             "idle_gaps": window.idle_gaps(spans)}
        outcome.notes.append(f"device time by kind (s): {window.by_kind()}")
    return outcome
