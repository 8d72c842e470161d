"""The numbers that decide ``correct``: what the program's timed path produced
against the plain reference. Each is a gap that is 0 where the two agree.

Training (``train_numbers``), by the worst leaf where a number is over
leaves, each gap measured against the reference's norm of that leaf or of the
median leaf, whichever is larger:

* ``loss_gap``: each of the first three steps' loss, auxiliary BCE,
  selective term and coverage, the largest relative gap; ``loss1_gap`` the
  same of the first step alone, which no optimizer step has touched yet;
* ``grad_median_gap``: the first step's gradient as Adam got it (its first
  moment after one step over 1 - beta1), the gap of each leaf's norm, the
  median over the leaves (the worst leaf's gap swings from seed to seed and
  separates no lower precision);
* ``grad1_dir_gap`` and ``grad1_dir_median``: the same gradient, each leaf's
  norm of the difference (which sees a gradient of the right size that
  points the wrong way, as one taken from a part of the batch does), the
  worst leaf and the median leaf;
* ``update_gap``: the parameters' change over the three steps, the gap of
  each leaf's norm; leaves whose reference gradient is under a thousandth of
  the median leaf's (the conv biases under BatchNorm, moved by round-off
  alone) are left out;
* ``bn_gap``: the running statistics' change over the three steps, the same
  way;
* ``count_gap``: each step's confusion counts and rejected pixels, the summed
  absolute difference over the pixels counted, the largest over the steps;
  ``count1_gap`` the first step's.

One step of the timed window (``window_numbers``), taken by the reference
from the program's own state just before it (parameters, running statistics,
Adam's moments and step count):

* ``win_loss_gap`` and ``win_count_gap``: that step's loss terms and counts,
  as ``loss_gap`` and ``count_gap``;
* ``win_update_gap``: the parameters' change in that step, each leaf's norm
  of the difference, the worst leaf (leaves under ``SMALL_GRADIENT`` as in
  ``update_gap``).

Serving (``answer_numbers``): ``prob_gap_max`` and ``prob_gap_mean``, the
largest and the mean absolute difference of the probability planes (output
and selection heads) over every compared answer, and ``mask_gap``, the share
of mask pixels (prediction and selection) that differ.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

STEP_KEYS = ("loss", "aux_loss", "sel_loss", "coverage")
SMALL_GRADIENT = 1e-3  # leaves under this share of the median gradient are round-off


def _norm(t: torch.Tensor) -> float:
    return float(t.detach().double().norm())


def _worst(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    if not ref:
        return 0.0
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref)


def _loss_gap(p: dict, r: dict) -> float:
    return max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for k in STEP_KEYS)


def _count_gap(p: dict, r: dict) -> float:
    return ((sum(abs(a - b) for a, b in zip(p["cm"], r["cm"]))
             + abs(p["n_reject"] - r["n_reject"])) / max(r["n_pix"], 1))


def _moved(grads: Dict[str, torch.Tensor]) -> tuple:
    """(each leaf's gradient norm, their median, the leaves not under
    ``SMALL_GRADIENT`` of it)."""
    g = {k: _norm(v) for k, v in grads.items()}
    med = statistics.median(g.values())
    return g, med, [k for k in g if g[k] >= SMALL_GRADIENT * med]


def _diff_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys) -> list:
    """Each leaf's norm of the difference over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    d = {k: _norm(prog[k].to(ref[k].device).float() - ref[k].float()) for k in keys}
    n = {k: _norm(ref[k]) for k in keys}
    med = statistics.median(n.values())
    return [d[k] / max(n[k], med, 1e-30) for k in keys]


def train_numbers(prog: dict, ref: dict, p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``steps`` (three dicts of the step's
    floats, ``cm``, ``n_pix``, ``n_reject``), ``grads1``, ``params3`` and
    ``bn3``; ``p0`` is the starting state, running statistics included."""
    losses = [_loss_gap(p, r) for p, r in zip(prog["steps"], ref["steps"])]
    counts = [_count_gap(p, r) for p, r in zip(prog["steps"], ref["steps"])]
    g_ref, med, moved = _moved(ref["grads1"])
    g_prog = {k: _norm(prog["grads1"][k]) for k in g_ref}
    grad_median_gap = statistics.median(abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med, 1e-30)
                                        for k in g_ref)
    dirs = _diff_gaps(prog["grads1"], ref["grads1"], list(g_ref))
    d_ref = {k: _norm(ref["params3"][k].to(p0[k].device) - p0[k]) for k in moved}
    d_prog = {k: _norm(prog["params3"][k].to(p0[k].device) - p0[k]) for k in moved}
    b_ref = {k: _norm(v.to(p0[k].device) - p0[k]) for k, v in ref["bn3"].items()}
    b_prog = {k: _norm(prog["bn3"][k].to(p0[k].device) - p0[k]) for k in b_ref}
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_median_gap": grad_median_gap, "grad1_dir_gap": max(dirs),
            "grad1_dir_median": statistics.median(dirs), "update_gap": _worst(d_prog, d_ref),
            "bn_gap": _worst(b_prog, b_ref), "count_gap": max(counts), "count1_gap": counts[0]}


def window_numbers(prog: dict, ref: dict, before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One step of the window: ``prog`` and ``ref`` each hold ``step`` (the
    step's floats and counts) and ``params`` (the parameters after it);
    ``ref`` also ``grads``; ``before`` is the program's state before it."""
    _, _, moved = _moved(ref["grads"])
    delta = lambda side: {k: side["params"][k].to(before[k].device) - before[k]  # noqa: E731
                          for k in moved}
    return {"win_loss_gap": _loss_gap(prog["step"], ref["step"]),
            "win_count_gap": _count_gap(prog["step"], ref["step"]),
            "win_update_gap": max(_diff_gaps(delta(prog), delta(ref), moved))}


PROBS = ("prob", "selection_prob")
MASKS = ("pred", "selection")


def _cpu(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu()


def answer_numbers(prog: List[dict], ref: List[dict]) -> Dict[str, float]:
    """Answers against the reference's, item by item: each item a dict of
    probability planes in [0, 1] (``PROBS``) and {0, 1} masks (``MASKS``),
    arrays or tensors of one shape on each side."""
    worst, total, count, flips, pixels = 0.0, 0.0, 0, 0, 0
    for p, r in zip(prog, ref):
        for k in PROBS:
            d = (_cpu(p[k]).double() - _cpu(r[k]).double()).abs()
            worst = max(worst, float(d.max()))
            total += float(d.sum())
            count += d.numel()
        for k in MASKS:
            d = _cpu(p[k]).long() != _cpu(r[k]).long()
            flips += int(d.sum())
            pixels += d.numel()
    return {"prob_gap_max": worst, "prob_gap_mean": total / max(count, 1),
            "mask_gap": flips / max(pixels, 1)}


def from_compact(answer: dict) -> dict:
    """A compact answer (uint8 planes, probabilities in 1/255) as ``PROBS``
    and ``MASKS``."""
    return {"prob": _cpu(answer["prob_u8"]).float() / 255.0,
            "selection_prob": _cpu(answer["selection_prob_u8"]).float() / 255.0,
            "pred": _cpu(answer["pred"]), "selection": _cpu(answer["selection"])}
