"""Where the eval step's time goes on the card.

Run from the repository root, on a CUDA device::

    python -m selectivenet_for_semantic_segmentation_binary_torch.tools.profile_eval_step

On the full-width selective UNet_B (seeded random weights) at batch 128,
256x256, bfloat16, with 2x128+37 seeded in-memory patches, it prints:

* the conv layers' multiply-accumulates per patch, layer by layer, and the
  FLOP totals per patch and per batch;
* a ``torch.profiler`` trace of the eval-metrics kernel wrapper, of its
  plain version and of ``eval_lib.make_eval_step``'s step: wall and device
  time per call, the busy share (device kernel time / wall) and the kernels
  by device time; for the step also the rate of the kernels whose name
  marks a forward convolution ("fprop", the 3x3 convs);
* the forward with ``cudnn.benchmark`` off and on;
* ``evaluate()`` end to end, the loader alone, and the loader feeding the
  step, with the busy share of the last.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

from ..config import EvalConfig
from ..data.loader import PatchLoader
from ..eval_lib import device_preprocess, evaluate, load_models, make_eval_step
from ..ops import eval_metrics as em
from .synthetic import InMemoryPatches, conv_macs, seeded_model

BATCH, SIZE, SEED = 128, 256, 0
N_PATCHES = 2 * BATCH + 37
STEPS = 5  # profiled calls per region


def _kernel_times(prof):
    """Device time (us) and calls by kernel name over the profiled region,
    read from the trace's ``kernel`` events (memory copies and sets are
    left out)."""
    times = collections.defaultdict(float)
    calls = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="profile_eval_step_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            times[e["name"]] += float(e["dur"])
            calls[e["name"]] += 1
    if not times:
        raise RuntimeError("the profiler recorded no device kernels")
    return times, calls


def profile(label: str, fn, steps: int = STEPS, top: int = 16):
    """Profile ``steps`` calls of ``fn`` after two warm-up calls; print wall
    and device time per call, the busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
    times, calls = _kernel_times(prof)
    device_us = sum(times.values()) / steps
    print(f"== {label}: wall {wall_us / 1e3:.3f} ms/call, device kernels "
          f"{device_us / 1e3:.3f} ms/call, busy share {device_us / wall_us:.3f}")
    for name, us in sorted(times.items(), key=lambda kv: -kv[1])[:top]:
        print(f"   {us / steps:10.1f} us x{calls[name] // steps:<3d} {name[:110]}")
    return times, device_us


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median host time of ``fn`` in ms, the card synchronised around each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval_step needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    model = seeded_model(SEED, "bfloat16").to(device)
    rows = conv_macs(model, SIZE, SIZE)
    print(f"== conv layers, MACs per {SIZE}x{SIZE} patch")
    by_kind = collections.defaultdict(int)
    for name, kind, macs in rows:
        by_kind[kind] += macs
        print(f"   {name:22s} {kind:9s} {macs / 1e9:8.4f} GMAC")
    for kind, macs in sorted(by_kind.items()):
        print(f"   total {kind}: {len([r for r in rows if r[1] == kind])} layers, "
              f"{2 * macs / 1e9:.3f} GFLOP per patch, {2 * macs * BATCH / 1e12:.3f} TFLOP per batch")
    total = sum(by_kind.values())
    print(f"   total: {2 * total / 1e9:.3f} GFLOP per patch, "
          f"{2 * total * BATCH / 1e12:.3f} TFLOP per batch of {BATCH}")

    data = InMemoryPatches(N_PATCHES, SIZE, SEED)
    loader = PatchLoader(data, BATCH, num_workers=8, device=device)
    batch = next(iter(loader))
    with tempfile.TemporaryDirectory(prefix="profile_eval_step_") as model_dir:
        torch.save({"net": model.state_dict()}, os.path.join(model_dir, "model_epoch1.pth"))
        cfg = EvalConfig(model_dir=model_dir, model_arch=["UNet_B"], selective=True,
                         select_eval=True, batch_size=BATCH, patch_size=SIZE,
                         compute_dtype="bfloat16", use_pallas=True, num_workers=8)
        models = load_models(cfg, device)
        step = make_eval_step(models, cfg, use_kernel=True)

        with torch.inference_mode():
            x, label = device_preprocess(batch)
            out, sel, _aux = models[0](x)
        kw = dict(apply_sigmoid=True, selective=True, cut_off=0.5, s_cut_off=0.5)
        profile("kernel wrapper", lambda: em.fused_eval_metrics(out, label, sel, **kw), top=4)
        profile("plain version", lambda: em.eval_metrics_reference(out, label, sel, **kw),
                top=10)
        times, _ = profile("eval step, bf16", lambda: step(batch))
        conv_us = sum(us for name, us in times.items() if "fprop" in name) / STEPS
        conv_flop = 2 * by_kind["conv3x3"] * BATCH
        print(f"   kernels named *fprop* (the 3x3 convs): {conv_us / 1e3:.3f} ms per step, "
              f"{conv_flop / conv_us / 1e6:.1f} TFLOP/s on {conv_flop / 1e12:.3f} TFLOP")

        with torch.inference_mode():
            for bench in (False, True, True, False):
                torch.backends.cudnn.benchmark = bench
                print(f"cudnn.benchmark={bench}: forward "
                      f"{median_ms(lambda: models[0](x)):.3f} ms median")
        torch.backends.cudnn.benchmark = False

        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate(cfg, loader=loader, verbose=False, device=device)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            print(f"evaluate() run {i}: {s:.3f} s -> {N_PATCHES / s:.1f} patches/s "
                  f"(incl. checkpoint load)")

    def loader_only():
        for b in loader:
            b["label"].sum()

    def loader_and_step():
        for b in loader:
            step(b)

    for label_, fn in (("loader alone", loader_only), ("loader + step", loader_and_step)):
        for i in range(2):
            ms = median_ms(fn, runs=1, warmup=1)
            print(f"{label_} {i}: {ms:.1f} ms for {N_PATCHES} patches -> "
                  f"{N_PATCHES / ms * 1e3:.1f} patches/s")
    profile(f"loader + step over {N_PATCHES} patches", loader_and_step, 2, top=3)


if __name__ == "__main__":
    main()
