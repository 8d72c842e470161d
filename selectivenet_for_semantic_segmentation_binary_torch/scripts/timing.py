"""Device timing and the card's identity, shared by the entry points of this
package and ``chip_smoke.py``."""

from __future__ import annotations

import statistics
import subprocess

import torch

WARMUP = 3
RUNS = 20
# NVIDIA H100 SXM, data sheet: HBM3 bandwidth and dense bf16 and int8
# tensor-core rates
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
# bytes written before each timed run with flush_l2: well past the 50 MB L2
FLUSH_BYTES = 256 << 20
# the fused trunk's kernel layers at a 256x256 input: (name, Cin, Cout,
# H = W, prologue); enc1_1 (Cin 3) is a PyTorch conv
CBR_LAYERS = (
    ("enc1_2", 64, 64, 256, True), ("enc2_1", 64, 128, 128, False),
    ("enc2_2", 128, 128, 128, True), ("enc3_1", 128, 256, 64, False),
    ("enc3_2", 256, 256, 64, True), ("dec4_2", 256, 512, 32, False),
    ("dec4_1", 512, 512, 32, True), ("dec3_2", 512, 256, 64, False),
    ("dec3_1", 256, 256, 64, True), ("dec2_2", 256, 128, 128, False),
    ("dec2_1", 128, 128, 128, True), ("dec1_2", 128, 64, 256, False),
    ("dec1_1", 64, 64, 256, True),
)
# the 14 trunk convs of a UNet_B forward at a 256x256 RGB input: (name, Cin,
# Cout, H = W), the int8 kernel's layers
INT8_LAYERS = (("enc1_1", 3, 64, 256),) + tuple(l[:4] for l in CBR_LAYERS)


def require_cuda(what: str) -> torch.device:
    """The first CUDA device; raises SystemExit without one."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{what} needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms_device(fn, runs: int = RUNS, warmup: int = WARMUP, flush_l2: bool = False
                     ) -> float:
    """Median device time of fn's kernels in ms: the card first spins on a
    ~2 ms sleep kernel while the host enqueues fn, so the events bracket the
    enqueued kernels and none of the host's Python time. With ``flush_l2``
    a 256 MB scratch buffer is written before each timed run, outside the
    events, so fn finds its inputs in device memory and not in the L2, as a
    caller that makes an input once and reads it once does."""
    for _ in range(warmup):
        fn()
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda") if flush_l2 else None
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if scratch is not None:
            scratch.fill_(1)
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(plain, kernel, flush_l2: bool = False) -> dict:
    """Device medians of the plain version and the kernel timed in turns
    (plain, kernel, kernel, plain), so both see the same clocks."""
    p1 = median_ms_device(plain, flush_l2=flush_l2)
    k1 = median_ms_device(kernel, flush_l2=flush_l2)
    k2 = median_ms_device(kernel, flush_l2=flush_l2)
    p2 = median_ms_device(plain, flush_l2=flush_l2)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "kernel_runs": (k1, k2),
            "plain_runs": (p1, p2)}


def bound_ms(nbytes: int, flops: int, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take for a function that moves
    ``nbytes`` (each input read once, each output written once) and does
    ``flops`` operations at ``peak`` a second (bf16 by default;
    ``PEAK_INT8_OPS`` for int8): the larger of the two times, and which."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def summed_bounds(bounds) -> dict:
    """Several calls' ``bound_ms`` added up; ``bound_by`` is the limit of the
    calls that hold most of the total."""
    total = sum(b["bound_ms"] for b in bounds)
    by_bytes = sum(b["bound_ms"] for b in bounds if b["bound_by"] == "bytes")
    return {"bound_ms": total, "bound_by": "bytes" if 2 * by_bytes >= total else "operations"}


def cbr_bytes(n: int, h: int, w: int, cin: int, cout: int) -> int:
    """Bytes a bf16 fused CBR must move: x and w read, y written, the float32
    affine, bias and stats."""
    return 2 * (n * h * w * (cin + cout) + 9 * cin * cout) + 4 * (2 * cin + 3 * cout)
