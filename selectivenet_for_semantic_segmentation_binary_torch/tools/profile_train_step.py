"""Where the train step's time goes on the card, fused trunk against classic.

Run from the repository root, on a CUDA device::

    python -m selectivenet_for_semantic_segmentation_binary_torch.tools.profile_train_step

On the full-width selective UNet_B (seeded initialisation; BCElogit
selective risk, Adam) at batch 128, 256x256, bfloat16, for the classic
trunk (cuDNN convs, the port's BatchNorm) and the fused-CBR trunk
(``kernels/fused_conv_stats.cu``), it prints:

* a ``torch.profiler`` trace of the train step and of the train-mode
  forward alone: wall and device time per call, the busy share (device
  kernel time / wall), the device time by kind of kernel and the top
  kernels by device time;
* the median step time and the peak device memory of a step.
"""

from __future__ import annotations

import collections
import subprocess

import torch

from ..config import TrainConfig
from ..data.loader import PatchLoader
from ..models import build_model, init_weights
from ..optim import build_optimizer
from ..train_lib import device_preprocess, make_train_step
from .profile_eval_step import median_ms, profile
from .synthetic import InMemoryPatches

BATCH, SIZE, SEED = 128, 256, 0

# kernel-name fragments -> kind, first match wins
KINDS = (
    ("fused_conv_stats", ("fused_conv_stats_kernel", "rows_reduce_kernel")),
    ("cuDNN / cuBLAS conv and matmul", ("xmma", "cutlass", "dgrad", "wgrad", "fprop", "nvjet",
                                        "implicit_gemm", "gemm", "conv")),
    ("batch norm", ("batch_norm",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("cat, copies, pooling", ("CatArray", "copy", "max_pool")),
    ("elementwise", ("elementwise", "vectorized", "Functor", "where", "clamp")),
)


def kind_of(name: str) -> str:
    for kind, fragments in KINDS:
        if any(f in name for f in fragments):
            return kind
    return "other"


def by_kind(times, steps: int) -> None:
    totals = collections.defaultdict(float)
    for name, us in times.items():
        totals[kind_of(name)] += us / steps
    total = sum(totals.values())
    for kind, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"   {kind:32s} {us / 1e3:9.3f} ms  {us / total:6.1%}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", batch_size=BATCH,
                      patch_size=SIZE, compute_dtype="bfloat16", seed=SEED)
    loader = PatchLoader(InMemoryPatches(BATCH, SIZE, SEED), BATCH, num_workers=8,
                         device=device, shuffle=True, drop_last=True, seed=SEED,
                         random_flip=True)
    batch = next(iter(loader))
    x, _ = device_preprocess(batch)
    steps = 3
    for fused in (False, True):
        name = "fused trunk" if fused else "classic trunk"
        model = build_model("UNet_B", selective=True, compute_dtype="bfloat16", fused=fused)
        init_weights(model, torch.Generator().manual_seed(SEED)).to(device)
        step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
        times, _ = profile(f"train step, {name}", lambda: step(batch, cfg.lr), steps, top=20)
        by_kind(times, steps)
        with torch.no_grad():
            model.train()
            times, _ = profile(f"train-mode forward alone, {name}", lambda: model(x), steps,
                               top=12)
            by_kind(times, steps)
        ms = median_ms(lambda: step(batch, cfg.lr), runs=8, warmup=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(batch, cfg.lr)
        torch.cuda.synchronize()
        print(f"== {name}: train step {ms:.3f} ms median -> {BATCH / ms * 1e3:.2f} patches/s; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del model, step


if __name__ == "__main__":
    main()
