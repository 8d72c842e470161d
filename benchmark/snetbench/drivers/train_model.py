"""Training traffic for the model a configuration names: the closed loop of
``drivers/train.py`` (the port's ``make_train_step`` fed by its
``PatchLoader`` from a seeded host pool, three steps of set-up, the window,
the window's checked step), with the model built from the configuration's
``model_arch`` and sizes at the cell's patch side, and the plain reference
taken from the configuration's ``reference`` key (``reference/<name>.py``:
``leaves``, ``trainable``, ``fp8_operands``, ``normalize``, ``Trainer``).

The reference recomputes block by block (``recompute=True``) so that a
float32 batch of 128 fits on the card; dropout is refused, since seeded
masks would not be the program's.

Besides ``compare``'s numbers it reads ``bn1_gap`` (the running
statistics' change in the first step, by the worst leaf) and
``win_update_median`` (the window step's change, by the median leaf): the
first step's gradient of the deep ResNet units is chaotic at this
initialisation (bf16 rounding turns its direction, and Adam's first steps
follow it), so the worst-leaf numbers after it read rounding as large gaps.
(``bn1_gap`` is a reading: the float8 control moves it by only ~2x.) The
forward's planes hold the precision: ``prob1_gap_max``/``prob1_gap_mean``
(the first step's; float8 from 2.3x the sound runs' largest) and
``win_prob_gap_max``/``win_prob_gap_mean`` (the window's checked step's)
are the largest and the mean absolute difference of the probability planes
(sigmoid of the prediction and the selection logits; float8 from 5.9x),
the program's taken by a forward hook on the model in those two steps alone.

Under ``r.controls`` (``controls.py``) the outcome also holds the readings
the limits are set from, each against the float32 reference: the window
step's float8 control and half batch (``control_fp8``, ``half_batch``, as
``drivers/train.py``), and the first three steps' (``first3_control_fp8``,
``first3_half_batch``, ``first3_state_unchanged``).

Set-up ends with the program's ``train_lib.freeze_heap()``, as
``train_lib.train`` does before its epochs; the heap is handed back after
the window.

Traffic keys: those of ``drivers/train.py`` (one card only).
"""

from __future__ import annotations

import gc
import importlib
import os
import statistics
import time
from typing import Optional

import numpy as np
import torch

from .. import compare, core, data
from ..trace import Spans, Window
from .train import WARM_STEPS, Feed, _host_step, _step_record, _sync, sizes

# the model's sizes in a configuration file (build_model's ``dims``)
DIMS = ("width", "units", "hidden", "layers", "heads", "mlp_dim", "head_channels", "decoder")


def reference_module(r):
    """The configuration's plain reference (``reference/<name>.py``)."""
    name = os.path.splitext(r.config["reference"])[0].replace("/", ".")
    return importlib.import_module(name)


def model_sizes(r) -> dict:
    s = sizes(r)
    small = r.small or {}
    s["dims"] = small.get("dims") or {k: r.config[k] for k in DIMS if k in r.config}
    return s


def _tap(model, into: list):
    """A forward hook that appends the probability planes of each forward
    of ``model`` (sigmoid of the prediction and the selection logits) to
    ``into``; ``.remove()`` ends it."""

    def hook(module, args, outputs):
        into.append(tuple(torch.sigmoid(o.detach().float()) for o in outputs[:2]))

    return model.register_forward_hook(hook)


def plane_gaps(prog, ref) -> tuple:
    """(largest, mean) absolute difference of two sides' probability planes,
    plane by plane, over the rows both sides have (a half batch has half)."""
    worst, total, count = 0.0, 0.0, 0
    for p, q in zip(prog, ref):
        n = min(len(p), len(q))
        d = (p[:n].to(q.device).double() - q[:n].double()).abs()
        worst, total, count = max(worst, float(d.max())), total + float(d.sum()), count + d.numel()
    return worst, total / max(count, 1)


def _leaves(r, s: dict):
    return reference_module(r).leaves(s["dims"], s["side"], r.config["in_channels"],
                                      r.config["selective"])


def build(r, s: dict, weights, pool, rank: int = 0, world: int = 1, pg=None):
    """The program's train step, its model and optimizer, and its loader."""
    from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
    from selectivenet_for_semantic_segmentation_binary_torch.models import (
        build_model, load_weights)
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_train_step

    c = r.config
    tcfg = TrainConfig(model_arch=c["model_arch"], selective=c["selective"], loss=c["loss"],
                       s_lamb=c["s_lamb"], target_coverage=c["target_coverage"],
                       optim=c["optimizer"], lr=c["lr"], patch_size=s["side"],
                       batch_size=s["batch"], compute_dtype=s["compute_dtype"],
                       bn_stats=c["bn_stats"], dropout_rate=c["dropout_rate"],
                       num_workers=s["threads"], drop_last=True)
    model = build_model(tcfg.model_arch, tcfg.n_cls, tcfg.selective, tcfg.compute_dtype,
                        dropout_rate=tcfg.dropout_rate, in_ch=c["in_channels"],
                        bn_stats=tcfg.bn_stats, img_size=s["side"], dims=s["dims"]).to(r.device)
    load_weights(model, weights)
    optimizer = build_optimizer(tcfg, model.parameters())
    step = make_train_step(model, tcfg, optimizer, pg)
    loader = PatchLoader(data.PoolDataset(*pool), s["batch"], num_workers=s["threads"],
                         device=r.device, shuffle=True, drop_last=True, seed=r.args.seed,
                         random_flip=True, device_preproc=True, process_index=rank,
                         process_count=world)
    return step, model, optimizer, loader


def _rows(r, s: dict, pool, epoch: int, k: int, rows_kept: Optional[int]):
    """The images (normalised) and labels of step ``k`` of ``epoch`` on the
    device, as the reference takes them."""
    rows, flips = data.loader_plan(r.args.seed, epoch, k, s["batch"], len(pool[0]))
    x, y = data.flipped(pool[0][rows], pool[1][rows], flips)
    if rows_kept is not None:
        x, y = x[:rows_kept], y[:rows_kept]
    return (reference_module(r).normalize(torch.from_numpy(x).to(r.device)),
            torch.from_numpy(np.ascontiguousarray(y)).to(r.device))


def _trainer(r, s: dict, weights, lowp=None, update: bool = True, moments=None):
    c = r.config
    return reference_module(r).Trainer(weights, c["lr"], c["s_lamb"], c["target_coverage"],
                                       lowp, update, moments, dims=s["dims"], recompute=True)


def reference(r, s: dict, weights, pool, lowp=None, rows_kept: Optional[int] = None,
              update: bool = True) -> dict:
    """The reference's first three steps on the rows the feed gave the
    program (``rows_kept``: a fault that trains on only the first rows;
    ``update=False``: one whose steps leave the state unchanged)."""
    ref = reference_module(r)
    trainer = _trainer(r, s, weights, lowp, update)
    steps, grads1, bn1, planes1 = [], None, None, None
    for k in range(WARM_STEPS):
        res = trainer.step(*_rows(r, s, pool, 1, k, rows_kept))
        grads, planes = res.pop("grads"), res.pop("planes")
        if k == 0:
            grads1, planes1 = grads, planes
            bn1 = {n: v for n, v in trainer.p.items() if not ref.trainable(n)}
        del grads, planes
        steps.append(res)
    params = {k: v for k, v in trainer.p.items() if ref.trainable(k)}
    bn = {k: v for k, v in trainer.p.items() if not ref.trainable(k)}
    return {"steps": steps, "grads1": grads1, "bn1": bn1, "params3": params, "bn3": bn,
            "planes1": planes1}


def step_numbers(prog: dict, ref: dict, p0) -> dict:
    """``compare.train_numbers``, ``bn1_gap`` (the running statistics'
    change in the first step, before any optimizer step has moved the
    weights the statistics are taken through, each leaf's norm, by the worst
    leaf as ``bn_gap``) and the first step's ``prob1_gap_max`` and
    ``prob1_gap_mean``."""
    numbers = compare.train_numbers(prog, ref, p0)
    change = lambda side: {k: float((v.to(p0[k].device) - p0[k]).double().norm())  # noqa: E731
                           for k, v in side["bn1"].items()}
    numbers["bn1_gap"] = compare._worst(change(prog), change(ref))
    numbers["prob1_gap_max"], numbers["prob1_gap_mean"] = plane_gaps(prog["planes1"],
                                                                     ref["planes1"])
    return numbers


def window_reference(r, s: dict, pool, snap: dict, lowp=None,
                     rows_kept: Optional[int] = None) -> dict:
    """The reference's step from the program's state ``snap`` (taken just
    before the window's checked step) on that step's rows."""
    ref = reference_module(r)
    trainer = _trainer(r, s, snap["state"], lowp,
                       moments=(snap["exp_avg"], snap["exp_avg_sq"], snap["t"]))
    res = trainer.step(*_rows(r, s, pool, snap["epoch"], snap["index"], rows_kept))
    grads, planes = res.pop("grads"), res.pop("planes")
    return {"step": res, "grads": grads, "planes": planes,
            "params": {k: v for k, v in trainer.p.items() if ref.trainable(k)}}


def window_step_numbers(prog: dict, ref: dict, before) -> dict:
    """``compare.window_numbers``, ``win_update_median`` (the window step's
    change, each leaf's norm of the difference as in ``win_update_gap``, the
    median leaf) and the step's ``win_prob_gap_max`` and
    ``win_prob_gap_mean``."""
    numbers = compare.window_numbers(prog, ref, before)
    _, _, moved = compare._moved(ref["grads"])
    delta = lambda side: {k: side["params"][k].to(before[k].device) - before[k]  # noqa: E731
                          for k in moved}
    numbers["win_update_median"] = statistics.median(
        compare._diff_gaps(delta(prog), delta(ref), moved))
    numbers["win_prob_gap_max"], numbers["win_prob_gap_mean"] = plane_gaps(prog["planes"],
                                                                           ref["planes"])
    return numbers


def _buffers(named) -> dict:
    return {n: torch.empty_like(t) for n, t in named}


def _fill(into: dict, named) -> dict:
    with torch.no_grad():
        for n, t in named:
            into[n].copy_(t)
    return into


def _moments(optimizer, params: dict, key: str, into: dict, scale: float = 1.0) -> dict:
    """Adam's moment ``key`` of each leaf into ``into`` (times ``scale``); a
    leaf no step has moved holds none: it reads 0."""
    with torch.no_grad():
        for n, p in params.items():
            moment = optimizer.state[p].get(key)
            if moment is None:
                into[n].zero_()
            else:
                into[n].copy_(moment).mul_(scale)
    return into


def _retake(snap: dict, params: dict, stats: dict, optimizer, feed) -> None:
    """``drivers/train.py``'s ``_snapshot`` of the program's state, copied
    into buffers made before the first step."""
    _fill(snap["state"], [*params.items(), *stats.items()])
    for k in ("exp_avg", "exp_avg_sq"):
        _moments(optimizer, params, k, snap[k])
    first = next(iter(params.values()))
    snap.update(epoch=feed.epoch, index=feed.index,
                t=int(optimizer.state[first].get("step", 0)))


def _counters() -> dict:
    """The port's counters of the model's work: attention calls and tokens,
    K11's launches and bypasses."""
    from selectivenet_for_semantic_segmentation_binary_torch.models import transunet
    from selectivenet_for_semantic_segmentation_binary_torch.ops import sel_heads

    return {"transunet.attention_calls": transunet.attention_calls,
            "transunet.attention_tokens": transunet.attention_tokens,
            "sel_heads.launches_fwd": sel_heads.launches_fwd,
            "sel_heads.launches_bwd": sel_heads.launches_bwd,
            "sel_heads.bypasses": sel_heads.bypasses}


def run(r) -> core.Outcome:
    return train_cell(r)


def train_cell(r) -> core.Outcome:
    """Set-up, window and check of the cell on one card."""
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import freeze_heap

    if r.config["dropout_rate"]:
        raise ValueError("the step comparison needs dropout_rate 0: the reference cannot draw "
                         "the program's masks")
    device = r.device
    s = model_sizes(r)
    spans = Spans()
    weights = data.make_weights(_leaves(r, s), r.traffic["init"], r.args.seed, device)
    pool = data.patch_pool(s["pool"], s["side"], r.args.seed, device)
    step, model, optimizer, loader = build(r, s, weights, pool)
    feed = Feed(loader, spans)
    lr = r.config["lr"]
    beta1 = optimizer.param_groups[0]["betas"][0]
    params = dict(model.named_parameters())  # Adam's state is keyed by these
    stats = {n: b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    # every tensor kept from the program is made here and filled by copies:
    # the steps of set-up then settle the caching allocator around them, and
    # the window allocates nothing its steps do not (a 1.7 GB copy of the
    # state made at the checked step idled the card 85-445 ms there)
    grads1, params3, after = (_buffers(params.items()) for _ in range(3))
    bn1, bn3 = _buffers(stats.items()), _buffers(stats.items())
    snap = {"state": _buffers([*params.items(), *stats.items()]),
            "exp_avg": _buffers(params.items()), "exp_avg_sq": _buffers(params.items())}

    records, planes1 = [], []
    tap = _tap(model, planes1)
    for k in range(WARM_STEPS):
        m = step(feed.next(), lr)
        records.append(_step_record(m))
        if k == 0:
            tap.remove()
            # the first step's gradient as Adam got it
            _moments(optimizer, params, "exp_avg", grads1, 1.0 / (1.0 - beta1))
            _fill(bn1, stats.items())
    _fill(params3, params.items())
    _fill(bn3, stats.items())
    freeze_heap()
    _sync(device)
    setup_s = time.perf_counter() - r.t0

    spans.clear()
    counters0 = _counters()
    window = Window(bool(r.args.trace), device.index or 0, r.tmpdir)
    steps, taken, checked, win_planes = 0, False, None, []
    with window:
        deadline = time.perf_counter() + r.args.seconds
        while True:
            batch = feed.next()
            if not taken and feed.index == 0:  # the window's checked step
                _retake(snap, params, stats, optimizer, feed)
                taken, tap = True, _tap(model, win_planes)
            with spans.mark("step"):
                m = step(batch, lr)
            if checked is None and taken:
                tap.remove()
                checked = {"step": _step_record(m), "planes": win_planes[0],
                           "params": _fill(after, params.items())}
            steps += 1
            if checked is not None and time.perf_counter() >= deadline:
                break
        window.close(lambda: _sync(device))
    gc.unfreeze()
    counters = {k: v - counters0[k] for k, v in _counters().items()}
    failed = 0 if bool(torch.isfinite(m["loss"])) else steps
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    prog = {"steps": [_host_step(rec) for rec in records], "grads1": grads1, "bn1": bn1,
            "params3": params3, "bn3": bn3, "planes1": planes1[0]}
    prog_win = {"step": _host_step(checked["step"]), "params": checked["params"],
                "planes": checked["planes"]}
    feed.close()
    del step, model, optimizer, loader, feed, batch, m, checked, planes1, win_planes, after
    del params, stats
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    base = reference(r, s, weights, pool)
    numbers = step_numbers(prog, base, weights)
    del prog, params3, grads1
    ref_win = window_reference(r, s, pool, snap)
    numbers.update(window_step_numbers(prog_win, ref_win, snap["state"]))
    t_ref = time.perf_counter() - t_ref
    controls = {}
    if r.controls:
        ref = reference_module(r)
        for name, kw in (("control_fp8", {"lowp": ref.fp8_operands}),
                         ("half_batch", {"rows_kept": s["batch"] // 2})):
            controls[name] = window_step_numbers(window_reference(r, s, pool, snap, **kw),
                                                 ref_win, snap["state"])
        for name, kw in (("first3_control_fp8", {"lowp": ref.fp8_operands}),
                         ("first3_half_batch", {"rows_kept": s["batch"] // 2}),
                         ("first3_state_unchanged", {"update": False})):
            controls[name] = step_numbers(reference(r, s, weights, pool, **kw), base, weights)
    del snap, ref_win, base

    patches = steps * s["batch"]
    readings = core.Readings(window_s=window.seconds, chips=1, steps=steps, batch=s["batch"],
                             kernels=window.kernels, busy_s=window.busy_s, spans=spans,
                             counters=counters)
    outcome = core.Outcome(
        e2e={"setup_s": setup_s, r.traffic["throughput_metric"]: patches / window.seconds},
        readings=readings, numbers=numbers, attempted=steps, failed=failed,
        memory_peak_bytes=peak,
        kind=torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        count=1, busy_s=window.busy_s)
    outcome.controls = controls
    outcome.notes.append(f"train_model: {r.config['model_arch']}, {steps} steps of {s['batch']} "
                         f"in {window.seconds:.4f} s, set-up {setup_s:.3f} s, checked step "
                         f"{prog_win['step']['loss']!r} (loss), the reference's 4 steps "
                         f"{t_ref:.1f} s, counters {counters}")
    outcome.notes.append(f"numbers {numbers}")
    if r.args.trace:
        outcome.breakdown = {"device_ops": window.top_kernels(),
                             "idle_gaps": window.idle_gaps(spans)}
        outcome.notes.append(f"device time by kind (s): {window.by_kind()}")
    return outcome
