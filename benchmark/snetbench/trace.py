"""Spans the harness records around its calls into the program, and the
device trace of a ``--trace 1`` window.

``Spans`` keeps (name, start, end) on the host clock (``time.time_ns``) in
memory; the harness opens one around each call it makes into a layer
(``feed_wait`` around the loader's ``next``, ``step`` around the train step,
``predict`` around a ``Predictor`` call). ``Window`` runs the measured
window, under ``torch.profiler`` (CUDA activity only) when tracing, and
reduces the trace to the device's kernels, its busy time (the union of
kernel, copy and set intervals on one card), the longest idle gaps named by
the harness span that covers them, and the kernels by time.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named host intervals, thread-safe; ``mark`` opens and closes one."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def mark(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            with self._lock:
                self.items.append((name, t0, time.time_ns()))

    def __getstate__(self):
        return {"items": self.items}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def clear(self) -> None:
        with self._lock:
            self.items = []

    def durations_ms(self, name: str) -> List[float]:
        return [(b - a) / 1e6 for n, a, b in self.items if n == name]


class Window:
    """The measured window. ``with window:`` starts the host clock (and the
    profiler when ``trace``); ``window.close(sync)`` calls ``sync`` (a device
    synchronise) and stops the clock. After it: ``seconds``, and when
    tracing ``kernels`` [(name, us)], ``busy_s`` and the merged busy
    ``intervals`` that ``idle_gaps`` reads."""

    def __init__(self, trace: bool, device_index: int = 0, tmpdir: Optional[str] = None):
        self.trace = trace
        self.device_index = device_index
        self.tmpdir = tmpdir
        self.seconds = None
        self.kernels: List[Tuple[str, float]] = []
        self.busy_s = None
        self.intervals: List[Tuple[int, int]] = []
        self._prof = None
        self.t0_ns = self.t1_ns = None

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.t0_ns = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def close(self, sync) -> None:
        sync()
        self.seconds = time.perf_counter() - self._t0
        self.t1_ns = time.time_ns()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._read(self._prof)
            self._prof = None

    def __exit__(self, *exc):
        if self._prof is not None:  # an error inside the window
            self._prof.__exit__(*exc)
            self._prof = None
        return False

    def _read(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.tmpdir)
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        base_ns = int(data.get("baseTimeNanoseconds", 0))
        spans = []
        for e in data.get("traceEvents", []):
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            if int(e.get("args", {}).get("device", self.device_index)) != self.device_index:
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if e.get("cat") == "kernel":
                self.kernels.append((e.get("name", "?"), dur))
            spans.append((base_ns + int(ts * 1e3), base_ns + int((ts + dur) * 1e3)))
        spans.sort()
        merged: List[List[int]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.intervals = [(a, b) for a, b in merged]
        self.busy_s = sum(b - a for a, b in merged) / 1e9

    def idle_gaps(self, spans: Spans, top: int = 10) -> List[List]:
        """The longest stretches of the window with nothing on the card, each
        named by the innermost harness span that covers its middle (``host``
        where none does)."""
        if not self.intervals:
            return []
        edges = [self.t0_ns] + [x for ab in self.intervals for x in ab] + [self.t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) // 2
            cover = [s for s in spans.items if s[1] <= mid <= s[2]]
            name = min(cover, key=lambda s: s[2] - s[1])[0] if cover else "host"
            out.append([name, (b - a) / 1e9])
        return out

    def top_kernels(self, top: int = 10) -> List[List]:
        totals: Dict[str, float] = collections.defaultdict(float)
        for name, us in self.kernels:
            totals[name[:120]] += us / 1e6
        return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def by_kind(self) -> Dict[str, float]:
        from .counts import kind_of

        totals: Dict[str, float] = collections.defaultdict(float)
        for name, us in self.kernels:
            totals[kind_of(name)] += us / 1e6
        return dict(sorted(totals.items(), key=lambda kv: -kv[1]))
