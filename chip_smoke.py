#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's in-coverage evaluation of the full-width selective
UNet_B (``eval_lib.evaluate``, the path of ``eval.py --model_arch UNet_B
--selective 1 --select_eval 1``) and exits non-zero at the first failure.
Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles ``kernels/eval_metrics.cu`` from the checkout with nvcc;
3. the kernel against its plain version, integer for integer, over shapes,
   modes, cut-offs, label types, padding, logits on the cut-off and a count
   above 2^24;
4. the slice: a seeded random UNet_B saved as ``.pth``, 2x128+37 in-memory
   uint8 patches of 256x256 through the port's PatchLoader and evaluate()
   in bfloat16 at batch 128; the kernel's launch counter must count one
   launch a batch, the metrics must be finite, and evaluate()'s counts must
   equal the plain version's on the logits of evaluate()'s own forwards;
   the float32 forward on the card must match the CPU's on a small input;
5. timings (median of >= 20 runs after warm-up): the eval step, the forward
   alone, the kernel against its plain version.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it raises at once.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
BATCH = 128
SIZE = 256
N_PATCHES = 2 * BATCH + 37
WARMUP = 3
RUNS = 20
KERNEL_SOURCE = "selectivenet_for_semantic_segmentation_binary_torch/kernels/eval_metrics.cu"
TPU_KERNEL = "selectivenet_for_semantic_segmentation_binary_tpu/ops/pallas_metrics.py:44"


def max_count_err(a, b) -> int:
    return max(int((a[k].long() - b[k].long()).abs().max())
               for k in ("cm", "n_reject", "n_pix"))


def same_counts(a, b) -> bool:
    return max_count_err(a, b) == 0


def phase_kernel_exact(torch, em, device) -> int:
    """Phase 3. Returns the largest count difference seen (must be 0)."""
    from selectivenet_for_semantic_segmentation_binary_torch.ops.confusion import PAD_LABEL

    g = torch.Generator(device=device).manual_seed(SEED)
    worst = 0
    n_cases = 0
    for shape in ((128, 256, 256), (3, 33, 47)):
        for apply_sigmoid in (True, False):
            for selective in (True, False):
                for cut, s_cut in ((0.5, 0.5), (0.3, 0.7)):
                    for label_dtype in (torch.uint8, torch.int32):
                        if apply_sigmoid:
                            out = torch.randn(shape, generator=g, device=device)
                            sel = torch.randn(shape, generator=g, device=device)
                            on_cut = math.log(cut / (1.0 - cut))
                            on_s_cut = math.log(s_cut / (1.0 - s_cut))
                        else:
                            out = torch.rand(shape, generator=g, device=device)
                            sel = torch.rand(shape, generator=g, device=device)
                            on_cut, on_s_cut = cut, s_cut
                        # every 7th logit exactly on the cut-off (in float32)
                        out.view(-1)[::7] = on_cut
                        sel.view(-1)[::5] = on_s_cut
                        lab = torch.randint(0, 2, shape, generator=g, device=device,
                                            dtype=torch.int32)
                        lab.view(-1)[::97] = PAD_LABEL
                        if label_dtype == torch.int32:
                            lab.view(-1)[::89] = -1
                        lab[-1] = PAD_LABEL  # one fully padded sample
                        lab = lab.to(label_dtype)
                        kw = dict(apply_sigmoid=apply_sigmoid, selective=selective,
                                  cut_off=cut, s_cut_off=s_cut)
                        got = em.fused_eval_metrics(out, lab, sel if selective else None, **kw)
                        want = em.eval_metrics_reference(out, lab, sel if selective else None, **kw)
                        torch.cuda.synchronize()
                        err = max_count_err(got, want)
                        worst = max(worst, err)
                        n_cases += 1
                        if err:
                            raise AssertionError(
                                f"kernel != plain for shape={shape} sigmoid={apply_sigmoid} "
                                f"selective={selective} cut={cut}/{s_cut} "
                                f"label={label_dtype}: {got} vs {want}")
    # a count above 2^24: exact only with integer accumulation
    shape = (260, 256, 256)
    out = torch.rand(shape, generator=g, device=device) + 0.01
    sel = torch.rand(shape, generator=g, device=device) + 0.01
    lab = torch.ones(shape, dtype=torch.uint8, device=device)
    kw = dict(apply_sigmoid=True, selective=True, cut_off=0.5, s_cut_off=0.5)
    got = em.fused_eval_metrics(out, lab, sel, **kw)
    want = em.eval_metrics_reference(out, lab, sel, **kw)
    torch.cuda.synchronize()
    big = 260 * 256 * 256
    if int(got["cm"][1, 1]) != big or big != 17_039_360 or not same_counts(got, want):
        raise AssertionError(f"count above 2^24 wrong: cm={got['cm'].tolist()} "
                             f"want cm[1,1]={big}; plain {want['cm'].tolist()}")
    worst = max(worst, max_count_err(got, want))
    n_cases += 1
    print(f"[phase 3] kernel == plain version, integer for integer, in {n_cases} cases "
          f"(incl. cm[1,1] = {int(got['cm'][1, 1])} > 2^24); max count difference {worst}")
    return worst


def phase_slice(torch, em, device):
    """Phase 4: the port's evaluate() on the full-width selective UNet_B.

    A global forward hook records the input and the two heads of every
    forward the model makes inside evaluate(). evaluate()'s own totals must
    then equal the plain version applied to those very logits, with labels
    taken straight from the dataset (not from the loader), and the inputs it
    saw must equal the dataset's patches, normalised, in order, with the
    padding of the last batch at zero pixels."""
    from selectivenet_for_semantic_segmentation_binary_torch.config import EvalConfig
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
    from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import (
        device_preprocess, evaluate, load_models, make_eval_step)
    from selectivenet_for_semantic_segmentation_binary_torch.models import UNetB
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        InMemoryPatches, seeded_model)

    # the float32 forward on the card against the CPU's, on a small input
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = seeded_model(SEED, "float32")
    x = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(SEED))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        cpu_out = small(x)
        gpu_out = small.to(device)(x.to(device))
    fwd_err = max(float((c - gg.cpu()).abs().max()) for c, gg in zip(cpu_out, gpu_out))
    fwd_scale = max(float(c.abs().max()) for c in cpu_out)
    print(f"[phase 4] float32 forward, card vs CPU at 2x3x64x64: max |diff| {fwd_err:.3e} "
          f"(max |logit| {fwd_scale:.3e}; tolerance 1e-3 x max |logit|)")
    if not fwd_err <= 1e-3 * fwd_scale:
        raise AssertionError("the forward on the card disagrees with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    del small

    data = InMemoryPatches(N_PATCHES, SIZE, SEED)
    loader = PatchLoader(data, BATCH, num_workers=8, device=device)
    seen = []

    def record(module, args, out):
        if isinstance(module, UNetB):
            seen.append((args[0], out[0], out[1]))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_model_") as model_dir:
        torch.save({"net": seeded_model(SEED, "bfloat16").state_dict()},
                   os.path.join(model_dir, "model_epoch1.pth"))
        cfg = EvalConfig(model_dir=model_dir, model_arch=["UNet_B"], selective=True,
                         select_eval=True, batch_size=BATCH, patch_size=SIZE,
                         compute_dtype="bfloat16", use_pallas=True, num_workers=8)
        hook = torch.nn.modules.module.register_module_forward_hook(record)
        em.launches = 0
        t0 = time.perf_counter()
        try:
            results = evaluate(cfg, loader=loader, verbose=True, device=device)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        wall = time.perf_counter() - t0
        launches = em.launches
        models = load_models(cfg, device)
    print(f"[phase 4] evaluate(): {N_PATCHES} patches of {SIZE}x{SIZE} at batch {BATCH}, "
          f"bfloat16, {wall:.3f} s wall (incl. checkpoint load and first-call set-up); "
          f"eval_metrics kernel launches: {launches}")
    if launches != len(loader):
        raise AssertionError(f"the main path launched the eval_metrics kernel {launches} "
                             f"times for {len(loader)} batches")
    for key in ("accuracy", "accuracy_class", "mIoU", "rejection_ratio"):
        if not np.isfinite(results[key]):
            raise AssertionError(f"{key} is not finite: {results[key]}")
    if not 0.0 <= results["rejection_ratio"] <= 1.0:
        raise AssertionError(f"rejection_ratio {results['rejection_ratio']} outside [0, 1]")
    if len(seen) != len(loader):
        raise AssertionError(f"evaluate() ran {len(seen)} forwards for {len(loader)} batches")

    kw = dict(apply_sigmoid=True, selective=True, cut_off=cfg.cut_off,
              s_cut_off=cfg.s_cut_off)
    cm = torch.zeros((2, 2), dtype=torch.int64, device=device)
    n_pix = n_reject = 0
    for b, (x, out, sel) in enumerate(seen):
        lo = b * BATCH
        n = min(BATCH, N_PATCHES - lo)
        want_x, _ = device_preprocess(
            {"input": torch.from_numpy(data.inputs[lo:lo + n]).to(device), "label": None})
        if not (torch.equal(x[:n], want_x) and bool((x[n:] == -1.0).all())):
            raise AssertionError(f"batch {b}: the inputs evaluate() saw are not the "
                                 f"dataset's patches {lo}..{lo + n - 1} plus zero padding")
        label = torch.from_numpy(data.labels[lo:lo + n]).to(device)
        want = em.eval_metrics_reference(out[:n], label, sel[:n], **kw)
        got = em.fused_eval_metrics(out[:n], label, sel[:n], **kw)
        if not same_counts(got, want):
            raise AssertionError(f"batch {b}: kernel {got} != plain version {want} "
                                 f"on evaluate()'s logits")
        cm += want["cm"]
        n_pix += int(want["n_pix"])
        n_reject += int(want["n_reject"])
    cm = cm.cpu().numpy()
    if not np.array_equal(cm, results["confusion_matrix"].astype(np.int64)):
        raise AssertionError(f"evaluate()'s confusion matrix {results['confusion_matrix']} "
                             f"!= the plain version's on its logits {cm}")
    if n_pix != N_PATCHES * SIZE * SIZE:
        raise AssertionError(f"n_pix {n_pix} != {N_PATCHES}*{SIZE}^2")
    if results["rejection_ratio"] != n_reject / n_pix:
        raise AssertionError(f"evaluate()'s rejection_ratio {results['rejection_ratio']!r} "
                             f"!= {n_reject}/{n_pix} from the plain version")
    print(f"[phase 4] evaluate()'s confusion matrix and rejection ratio == the plain "
          f"version on evaluate()'s own logits and the dataset's labels, batch by batch "
          f"({len(seen)} batches; the kernel equal too); inputs == the dataset's patches; "
          f"n_pix = {n_pix} = {N_PATCHES}*{SIZE}^2; n_reject = {n_reject}; "
          f"rejection_ratio {results['rejection_ratio']:.6f}; mIoU {results['mIoU']:.6f}")
    step = make_eval_step(models, cfg, use_kernel=True)
    return models, step, next(iter(loader)), launches


def median_ms_device(torch, fn) -> float:
    """Median device time of fn's kernels: the card first spins on a ~2 ms
    sleep kernel while the host enqueues fn, so the events bracket the
    enqueued kernels and none of the host's Python time."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timings(torch, em, models, step, batch, card: str) -> dict:
    """Phase 5, at batch 128, 256x256, bfloat16."""
    from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import device_preprocess
    from selectivenet_for_semantic_segmentation_binary_torch.tools.profile_eval_step import (
        median_ms)

    model = models[0]
    with torch.inference_mode():
        step_ms = median_ms(lambda: step(batch), RUNS, WARMUP)
        x, label = device_preprocess(batch)
        fwd_ms = median_ms(lambda: model(x), RUNS, WARMUP)
        out, sel, _aux = model(x)
    kw = dict(apply_sigmoid=True, selective=True, cut_off=0.5, s_cut_off=0.5)
    # plain, kernel, kernel, plain: both sides see the same clocks
    plain_a = median_ms_device(torch, lambda: em.eval_metrics_reference(out, label, sel, **kw))
    kern_a = median_ms_device(torch, lambda: em.fused_eval_metrics(out, label, sel, **kw))
    kern_b = median_ms_device(torch, lambda: em.fused_eval_metrics(out, label, sel, **kw))
    plain_b = median_ms_device(torch, lambda: em.eval_metrics_reference(out, label, sel, **kw))
    kern_ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    nbytes = out.numel() * (out.element_size() + sel.element_size() + label.element_size())
    print(f"[phase 5] on {card}: eval step (preprocess + forward + metrics), batch {BATCH}, "
          f"{SIZE}x{SIZE}, bfloat16: {step_ms:.3f} ms median -> "
          f"{BATCH / step_ms * 1e3:.2f} patches/s")
    print(f"[phase 5] on {card}: forward alone: {fwd_ms:.3f} ms median -> "
          f"{BATCH / fwd_ms * 1e3:.2f} patches/s")
    print(f"[phase 5] on {card}: eval_metrics device time at {tuple(out.shape)} (selective, sigmoid, "
          f"uint8 labels, {nbytes} bytes read; kernel + int64 sum of the partials): "
          f"kernel {kern_ms * 1e3:.2f} us "
          f"({nbytes / kern_ms / 1e6:.1f} GB/s; medians {kern_a * 1e3:.2f}/{kern_b * 1e3:.2f} us), "
          f"plain version {plain_ms * 1e3:.2f} us ({nbytes / plain_ms / 1e6:.1f} GB/s; "
          f"medians {plain_a * 1e3:.2f}/{plain_b * 1e3:.2f} us)")
    return {"ms": kern_ms, "plain_ms": plain_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    from selectivenet_for_semantic_segmentation_binary_torch import kernels
    from selectivenet_for_semantic_segmentation_binary_torch.ops import eval_metrics as em

    device = torch.device("cuda", 0)
    # phase 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"[phase 1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
          f"capability {torch.cuda.get_device_capability(0)}")

    # phase 2: a fresh build from the checkout's source
    lib = kernels.library_path("eval_metrics")
    if os.path.exists(lib):
        os.remove(lib)
    t0 = time.perf_counter()
    kernels.build("eval_metrics")
    print(f"[phase 2] nvcc built {KERNEL_SOURCE} in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(kernels.BUILD_DIR, "eval_metrics.log")) as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[phase 2] {line.strip()}")

    worst = phase_kernel_exact(torch, em, device)
    models, step, batch, launches = phase_slice(torch, em, device)
    times = phase_timings(torch, em, models, step, batch, card)

    for name in ("jax", "selectivenet_for_semantic_segmentation_binary_tpu"):
        if name in sys.modules:
            raise AssertionError(f"the port imported {name}")
    print(json.dumps({"kernels": [{
        "name": "eval_metrics", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": worst,
        "ms": times["ms"], "plain_ms": times["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
