"""Spans inside the port: named stretches of one thread's work, kept in
memory and handed over by :func:`take`.

A span is opened with ``with span(name, key=None, device=False):``. Its
record (:class:`Span`) holds an id, the id of its parent (the innermost span
open on the same thread when it opened), its name, the thread (its native
id, as the profiler names CPU threads), its start and
end on ``time.time_ns()`` (the clock ``torch.profiler``'s chrome trace is put
on: ``baseTimeNanoseconds`` + ``ts``, so the spans and the device trace line
up), a ``key`` that ties the spans of one piece of work together (one
``Predictor`` call, one batch of an epoch) and, for a span timed on a CUDA
device, the milliseconds between its two ``torch.cuda.Event``s.

The recorder is on between :func:`enable` and :func:`disable`, and while a
``torch.profiler`` session profiles the process, so a traced window and
``--profile_dir`` carry the program's spans beside their kernels. The first
span to find a profiler session after a span that found none drops what the
recorder holds untaken, so a caller that profiles and never calls
:func:`take` holds no more than its newest session's spans, fewer than the
profiler's own record of that session.
Off, :func:`span` returns one shared no-op context: nothing is allocated, no
event is recorded, nothing synchronises.

Device spans (``device=True``, or the ``torch.device`` the work runs on; a
CPU device records host time only) record an event on the current stream at
each boundary. The recorder never synchronises while it records: ``take``
reads the elapsed times, after the caller's own synchronise. Neighbours
share events: a device span opened as the next device boundary after its
parent opened, or after its previous sibling closed, starts at that
boundary's event, so the device children of a span tile it from its start
(work enqueued between two of them counts to the later one).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

if not hasattr(_profiler, "_is_profiler_enabled"):
    raise ImportError("utils/tracing.py follows torch.profiler by "
                      "torch.autograd.profiler._is_profiler_enabled, which torch "
                      f"{torch.__version__} lacks")


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    thread: int
    start_ns: int
    end_ns: int
    key: Any
    device_ms: Optional[float]


_enabled = False
_profiled = False  # the last span() outside enable() saw a profiler session
_records: list = []  # Span fields, then the two events of a device span (or None, None)
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Record spans from now on, device spans with their events."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def take() -> List[Span]:
    """The spans recorded since the last ``take``, by start; the recorder
    keeps none of them. A device span's time is read here (its end event
    waited for), so call it after the work has been synchronised."""
    global _records
    records, _records = _records, []
    out = []
    for *fields, ev0, ev1 in records:
        ms = None
        if ev0 is not None:
            ev1.synchronize()
            ms = float(ev0.elapsed_time(ev1))
        out.append(Span(*fields, ms))
    out.sort(key=lambda s: (s.start_ns, s.id))
    return out


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "key", "stream", "id", "parent", "thread", "start", "ev0")

    def __init__(self, name: str, key, stream):
        self.name, self.key, self.stream = name, key, stream

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.thread = threading.get_native_id()
        self.ev0 = None
        if self.stream is not None:
            last = getattr(_local, "last", None)  # (event, stream, whose children may share it)
            if last is not None and self.parent is not None and last[1] == self.stream \
                    and last[2] == self.parent:
                self.ev0 = last[0]
            else:
                self.ev0 = _event(self.stream)
            _local.last = (self.ev0, self.stream, self.id)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        ev1 = None
        if self.ev0 is not None:
            ev1 = _event(self.stream)
            _local.last = (ev1, self.stream, self.parent)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # closed out of order: drop it wherever it sits
            stack.remove(self)
        _records.append((self.id, self.parent, self.name, self.thread, self.start, end,
                         self.key, self.ev0, ev1))
        return False


def _event(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def span(name: str, key=None, device=False):
    """A context that records one span named ``name`` when the recorder is
    on, and the shared no-op when it is off. ``device``: True (the current
    CUDA device) or the ``torch.device`` the span's work is enqueued on, to
    time it on that device's current stream as well."""
    global _profiled
    if not _enabled:
        if not _profiler._is_profiler_enabled:
            if _profiled:
                _profiled = False
            return _NOOP
        if not _profiled:  # a new profiler session: what the last left untaken goes
            _profiled = True
            _records.clear()
    stream = None
    if device is not False and device is not None:
        dev = None if device is True else torch.device(device)
        if dev is None or dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
    return _Open(name, key, stream)
