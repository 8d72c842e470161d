"""Benchmark: selective UNet_B training throughput, 256x256 patches a second
on one card.

Counterpart of the repository's ``bench.py:47-183`` (the JAX benchmark) on
the port:

* ``run`` times the train step of the reference ``train.sh`` recipe:
  UNet_B with the SelectiveNet heads, BCElogit selective risk with
  ``s_lamb`` 2, Adam, 256x256, bfloat16, the default (classic) trunk; 3
  warm-up steps, then 20 timed steps between two ``synchronize()`` calls;
* ``run_eval`` times the BN-folded bf16 selective forward (the graph behind
  ``eval.py``, ``snet-predict`` and ``snet-serve``) the same way, at the
  same batch;
* ``main`` prints ONE JSON line with the JAX benchmark's keys ``metric``,
  ``value``, ``unit``, ``vs_baseline`` (value / 200, the reference's
  per-A100 estimate, bench.py:8-18) and ``eval_value``, plus ``batch_size``
  and ``card`` (the name and power limit ``nvidia-smi`` gives). The JAX
  line's ``ceiling_x`` and ``emitter_gap_x`` are TPU derivations and are
  not printed.

The batch starts at 128 and shrinks (64, 32, 8) only on
``torch.cuda.OutOfMemoryError``; any other error, in either half,
propagates and the process exits non-zero. ``python -m
selectivenet_for_semantic_segmentation_binary_torch.bench bfloat16``
measures ``--bn_stats bfloat16`` (``LowPrecStatsBN``). It runs on the first
card and raises without one; ``main(argv, device="cpu")`` runs it on the
CPU (the tests, with the module's sizes made small).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

import numpy as np
import torch

REFERENCE_A100_PATCHES_PER_SEC = 200.0
PATCH = 256
WARMUP_STEPS = 3
TIMED_STEPS = 20
BATCHES = (128, 64, 32, 8)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_step(batch_size: int, bn_stats: str = "float32", device=None):
    """The train step of the ``train.sh`` recipe and one batch of PATCH x
    PATCH on the device: float32 standard-normal inputs (the device feed's
    normalised range) and 0/1 labels, from seed 0."""
    from .config import TrainConfig
    from .models import build_model, init_weights
    from .optim import build_optimizer
    from .train_lib import make_train_step, resolve_device

    device = resolve_device(device)
    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", s_lamb=2.0,
                      patch_size=PATCH, batch_size=batch_size, compute_dtype="bfloat16",
                      bn_stats=bn_stats)
    model = build_model(cfg.model_arch, cfg.n_cls, cfg.selective, cfg.compute_dtype,
                        bn_stats=cfg.bn_stats)
    init_weights(model, torch.Generator().manual_seed(0)).to(device)
    step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch_size, PATCH, PATCH, 3)).astype(np.float32)
    y = (rng.random((batch_size, PATCH, PATCH)) > 0.7).astype(np.uint8)
    batch = {"input": torch.from_numpy(x).to(device), "label": torch.from_numpy(y).to(device)}
    return step, batch, device


def run(batch_size: int, bn_stats: str = "float32", device=None) -> float:
    """Train-step throughput in patches a second."""
    step, batch, device = build_step(batch_size, bn_stats, device)
    for _ in range(WARMUP_STEPS):
        metrics = step(batch, 1e-3)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        metrics = step(batch, 1e-3)
    _sync(device)
    dt = time.perf_counter() - t0
    if not np.isfinite(float(metrics["loss"])):
        raise FloatingPointError(f"the timed steps' last loss is {float(metrics['loss'])}")
    return batch_size * TIMED_STEPS / dt


def run_eval(batch_size: int, device=None) -> float:
    """Serving/eval throughput in patches a second: the BN-folded bf16
    selective forward at the same batch and patch size."""
    from .models import build_model, init_weights, load_weights
    from .ops.fold_bn import fold_batchnorm
    from .train_lib import resolve_device

    device = resolve_device(device)
    base = init_weights(build_model("UNet_B", selective=True, compute_dtype="float32"),
                        torch.Generator().manual_seed(0))
    model = build_model("UNet_B", selective=True, compute_dtype="bfloat16", folded=True)
    load_weights(model, fold_batchnorm(base.state_dict()))
    model.to(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch_size, PATCH, PATCH, 3))
                         .astype(np.float32)).to(device).permute(0, 3, 1, 2)
    with torch.inference_mode():
        for _ in range(WARMUP_STEPS):
            out = model(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            out = model(x)
        _sync(device)
        dt = time.perf_counter() - t0
    if not torch.isfinite(out[0]).all():
        raise FloatingPointError("the folded forward gave non-finite logits")
    return batch_size * TIMED_STEPS / dt


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return f"none ({device.type})"
    from .scripts.timing import card

    return card()


def main(argv=None, device=None) -> dict:
    """Prints the JSON line and returns it as a dict."""
    from .train_lib import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    # `python -m ...bench bfloat16` measures the LowPrecStatsBN variant
    bn_stats = argv[0] if argv else "float32"
    device = resolve_device(device)
    value: Optional[float] = None
    for batch_size in BATCHES:
        try:
            value = run(batch_size, bn_stats, device)
            break
        except torch.cuda.OutOfMemoryError as e:  # shrink the batch; nothing else
            print(f"batch {batch_size}: out of memory ({str(e).splitlines()[0]}); "
                  f"shrinking", file=sys.stderr)
            last_err = e
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if value is None:
        raise last_err
    eval_value = run_eval(batch_size, device)
    line = {
        "metric": f"train_patches_per_sec_per_chip_{PATCH}px",
        "value": round(value, 2),
        "unit": "patches/s/chip",
        "vs_baseline": round(value / REFERENCE_A100_PATCHES_PER_SEC, 3),
        # the serving/eval half: the BN-folded bf16 selective forward, same
        # batch and patch (run_eval)
        "eval_value": round(eval_value, 2),
        "batch_size": batch_size,
        "bn_stats": bn_stats,
        "card": _card(device),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
