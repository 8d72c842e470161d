"""The port's own spans (``utils/tracing.py``) as the per-layer readers see
them, and what a traced window's device intervals say about them.

The port records its spans while ``torch.profiler`` profiles the process,
so a ``--trace 1`` window holds exactly the window's spans. ``spans()``
takes them from the port once in the reporting process and keeps them for
every reader; on a program without the recorder it is empty, and every
reader of it returns None. That process-wide copy is temporary: the
readers cannot read the spans from their ``Readings`` until the harness's
drivers put them there (and a fleet rank's spans reach the reporting
process), and then ``spans()`` goes. The rest are plain functions of spans
and intervals (ns on ``time.time_ns``, the device trace's clock).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

_taken: Optional[list] = None


def spans() -> list:
    """The spans the port recorded in this process (taken once)."""
    global _taken
    if _taken is None:
        try:
            from selectivenet_for_semantic_segmentation_binary_torch.utils import tracing
        except ImportError:  # a program without the recorder
            _taken = []
        else:
            _taken = list(tracing.take())
    return _taken


def named(items: Sequence, name: str) -> list:
    return [s for s in items if s.name == name]


def mean_host_ms(items: Sequence, name: str) -> Optional[float]:
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in named(items, name)]
    return sum(ms) / len(ms) if ms else None


def mean_device_ms(items: Sequence, name: str) -> Optional[float]:
    ms = [s.device_ms for s in named(items, name) if s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None


def _clip(a: int, b: int, lo: int, hi: int) -> Tuple[int, int]:
    return max(a, lo), min(b, hi)


def covered_ns(intervals: Sequence[Tuple[int, int]], a: int, b: int) -> int:
    """How much of [a, b) the sorted, disjoint ``intervals`` cover."""
    total = 0
    for x, y in intervals:
        if y <= a:
            continue
        if x >= b:
            break
        lo, hi = _clip(x, y, a, b)
        total += hi - lo
    return total


def idle_in_pct(items: Sequence, name: str, thread: int, busy: Sequence[Tuple[int, int]],
                t0: int, t1: int) -> Optional[float]:
    """Share of the window [t0, t1) in which the card is idle (outside the
    merged ``busy`` intervals) while ``thread`` is inside a span ``name``."""
    mine = [s for s in named(items, name) if s.thread == thread]
    if not mine or t1 <= t0:
        return None
    idle = 0
    for s in mine:
        a, b = _clip(s.start_ns, s.end_ns, t0, t1)
        if b > a:
            idle += (b - a) - covered_ns(busy, a, b)
    return 100.0 * idle / (t1 - t0)


def idle_gaps(items: Sequence, thread: int, busy: Sequence[Tuple[int, int]], t0: int, t1: int,
              harness: Sequence[Tuple[str, int, int]] = (), top: int = 10) -> List[list]:
    """The longest stretches of the window with nothing on the card, each
    named by the innermost program span on ``thread`` covering its middle,
    else by the innermost ``harness`` span (name, start, end), else
    ``host``: [name, seconds]."""
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    mine = [(s.name, s.start_ns, s.end_ns) for s in items if s.thread == thread]
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        name = "host"
        for group in (mine, harness):
            cover = [s for s in group if s[1] <= mid <= s[2]]
            if cover:
                name = min(cover, key=lambda s: s[2] - s[1])[0]
                break
        out.append([name, (b - a) / 1e9])
    return out


def copies_inside(items: Sequence, name: str, copies: Sequence[Tuple[int, int]]) -> Dict:
    """Device copies (start, end) against the spans ``name``: the share of
    their time inside some such span, the copies that overlap none, and the
    most any copy starts before the span it overlaps most (us; negative:
    every copy starts inside its span)."""
    mine = sorted((s.start_ns, s.end_ns) for s in named(items, name))
    total = sum(b - a for a, b in copies)
    inside, worst, outside = 0, None, 0
    for a, b in copies:
        inside += covered_ns(mine, a, b)
        over = [(min(b, y) - max(a, x), x) for x, y in mine if x < b and y > a]
        if not over:
            outside += 1
            continue
        early = (max(over)[1] - a) / 1e3
        worst = early if worst is None else max(worst, early)
    return {"copies": len(copies), "outside": outside, "copy_ms": total / 1e6,
            "inside_pct": 100.0 * inside / total if total else None,
            "worst_early_us": worst}
