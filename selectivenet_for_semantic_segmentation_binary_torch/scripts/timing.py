"""Device timing and the card's identity, shared by the entry points of this
package and ``chip_smoke.py``."""

from __future__ import annotations

import statistics
import subprocess

import torch

WARMUP = 3
RUNS = 20


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
