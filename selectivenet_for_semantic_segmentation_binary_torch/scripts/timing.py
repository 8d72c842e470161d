"""Device timing and the card's identity, shared by the entry points of this
package and ``chip_smoke.py``."""

from __future__ import annotations

import statistics
import subprocess

import torch

WARMUP = 3
RUNS = 20
# NVIDIA H100 SXM, data sheet: HBM3 bandwidth and dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


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


def median_ms_device(fn, runs: int = RUNS, warmup: int = WARMUP) -> float:
    """Median device time of fn's kernels in ms: the card first spins on a
    ~2 ms sleep kernel while the host enqueues fn, so the events bracket the
    enqueued kernels and none of the host's Python time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
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


def in_turns(plain, kernel) -> dict:
    """Device medians of the plain version and the kernel timed in turns
    (plain, kernel, kernel, plain), so both see the same clocks."""
    p1 = median_ms_device(plain)
    k1 = median_ms_device(kernel)
    k2 = median_ms_device(kernel)
    p2 = median_ms_device(plain)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "kernel_runs": (k1, k2),
            "plain_runs": (p1, p2)}


def bound_ms(nbytes: int, flops: int) -> dict:
    """The least time the card could take for a function that moves
    ``nbytes`` (each input read once, each output written once) and does
    ``flops`` bf16 operations: the larger of the two times, and which."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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
