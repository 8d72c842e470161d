"""Offline batch scoring: back-to-back ``Predictor.predict_compact(batch,
want_prob=True)`` calls on batches of uint8 patches drawn in turn from a
seeded host pool, as ``snet-predict`` and ``snet-eval --quantize int8`` feed
the ``Predictor``.

Set-up makes the weights from the seed, writes the ``Predictor``'s checkpoint
to the run's temporary directory, builds the ``Predictor`` as the
configuration says (``quantize="int8"``: calibrated at set-up on its own
seeded images) and warms it on the first batches. The window keeps a seeded
sample of the answers; after it the reference works out the folded weights,
the calibration scales, the forward and the uint8 answers again and the
sampled answers are compared, every plane of them. The K10 launch count
confirms that the int8 path ran: 14 a call on the card.

Traffic keys: ``batch``, ``pool``, ``calib_images``, ``warm_batches``,
``init``, ``sample_calls``.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from .. import compare, core, data
from ..trace import Spans, Window
from .train import _sync

def sizes(r) -> dict:
    small = r.small or {}
    t = r.traffic
    return {"batch": small.get("batch", t["batch"]), "pool": small.get("pool", t["pool"]),
            "side": small.get("side", r.config["patch_size"]),
            "calib": small.get("calib", t["calib_images"]),
            "compute_dtype": small.get("compute_dtype", r.config["compute_dtype"])}


def write_checkpoint(weights, tmpdir: str) -> str:
    path = os.path.join(tmpdir, "model_epoch1.pth")
    torch.save({"net": {k: v.detach().cpu() for k, v in weights.items()}}, path)
    return path


def reference_answers(r, weights, calib_u8: np.ndarray, images: list, qmax: float = 127.0,
                      lowp=None, chunk: int = 32):
    """The reference's scales (int8 only) and its answers to each batch of
    ``images``: per batch {'prob', 'selection_prob'} float32 and the compact
    planes (``pred``, ``prob_u8``, ``selection``, ``selection_prob_u8``), on
    the device. ``qmax`` 7 or ``lowp`` make the control."""
    from reference import unet_b as ref

    device = r.device
    f = ref.fold(weights)
    scales = None
    if r.config["quantize"] == "int8":
        scales = ref.calibrate(f, torch.from_numpy(calib_u8).to(device), qmax=qmax)
    answers = []
    with torch.no_grad():
        for batch in images:
            parts = []
            for i in range(0, len(batch), chunk):
                x = ref.normalize(torch.from_numpy(batch[i:i + chunk]).to(device))
                if scales is not None:
                    out, sel, _ = ref.w8a8_forward(f, x, scales, qmax)
                else:
                    out, sel, _ = ref.folded_forward(f, x, lowp=lowp)
                parts.append({"prob": torch.sigmoid(out), "selection_prob": torch.sigmoid(sel),
                              **ref.compact(out, sel, r.config["cut_off"])})
            answers.append({k: torch.cat([p[k] for p in parts]) for k in parts[0]})
    return scales, answers


def run(r) -> core.Outcome:
    from reference import unet_b as ref
    from selectivenet_for_semantic_segmentation_binary_torch.ops import int8_conv
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor

    device = r.device
    s = sizes(r)
    c, t = r.config, r.traffic
    weights = data.make_weights(ref.leaves(), t["init"], r.args.seed, device)
    pool, _ = data.patch_pool(s["pool"], s["side"], r.args.seed, device)
    calib, _ = data.patch_pool(s["calib"], s["side"], r.args.seed, device, stream="calib")
    batches = [pool[i:i + s["batch"]] for i in range(0, s["pool"], s["batch"])]
    quantize = c["quantize"]
    pred = Predictor(write_checkpoint(weights, r.tmpdir), c["model_arch"], selective=c["selective"],
                     compute_dtype=s["compute_dtype"], cut_off=c["cut_off"],
                     s_cut_off=c["s_cut_off"], fold_bn=c["fold_bn"], quantize=quantize,
                     calibration_images=calib if quantize == "int8" else None, device=device)
    for i in range(t["warm_batches"]):
        pred.predict_compact(batches[i % len(batches)], want_prob=True)
    _sync(device)
    setup_s = time.perf_counter() - r.t0

    spans = Spans()
    rng = np.random.default_rng([r.args.seed, 17])
    kept = []  # (call, batch index, answer): a seeded reservoir sample
    launches0 = int8_conv.launches
    calls = failed = 0
    window = Window(bool(r.args.trace), device.index or 0, r.tmpdir)
    with window:
        deadline = time.perf_counter() + r.args.seconds
        while True:
            b = calls % len(batches)
            with spans.mark("predict"):
                out = pred.predict_compact(batches[b], want_prob=True)
            if out["pred"].shape != batches[b].shape[:3]:
                failed += 1
            if len(kept) < t["sample_calls"]:
                kept.append((calls, b, out))
            else:
                j = int(rng.integers(0, calls + 1))
                if j < t["sample_calls"]:
                    kept[j] = (calls, b, out)
            calls += 1
            if time.perf_counter() >= deadline:
                break
        window.close(lambda: _sync(device))
    launches = int8_conv.launches - launches0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog_scales = dict(pred._act_scales) if quantize == "int8" else None
    del pred, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    scales, ref_answers = reference_answers(r, weights, calib, [batches[b] for _, b, _ in kept])
    numbers = compare.answer_numbers([compare.from_compact(a) for _, _, a in kept],
                                     ref_answers)
    if quantize == "int8":
        numbers["scale_gap"] = max(abs(prog_scales[k] - v) / v for k, v in scales.items())
        per_call = c["int8_layers"] if device.type == "cuda" else 0
        numbers["k10_launch_gap"] = float(abs(launches - per_call * calls))
    patches = calls * s["batch"]
    readings = core.Readings(window_s=window.seconds, chips=1, batches=calls,
                             batch=s["batch"], kernels=window.kernels, busy_s=window.busy_s,
                             spans=spans)
    outcome = core.Outcome(
        e2e={"setup_s": setup_s, "infer_patches_per_s": patches / window.seconds},
        readings=readings, numbers=numbers, attempted=calls, failed=failed,
        memory_peak_bytes=peak,
        kind=torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        count=1, busy_s=window.busy_s)
    outcome.notes.append(f"infer: {calls} calls of {s['batch']} in {window.seconds:.4f} s, "
                         f"K10 launches {launches}, sampled calls "
                         f"{[k for k, _, _ in kept]}, set-up {setup_s:.3f} s")
    if r.args.trace:
        outcome.breakdown = {"device_ops": window.top_kernels(),
                             "idle_gaps": window.idle_gaps(spans)}
        outcome.notes.append(f"device time by kind (s): {window.by_kind()}")
    return outcome
