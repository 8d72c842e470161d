"""Run one cell once and read the port's own spans and counters against
the window's device trace: what the result line of ``run.py`` cannot carry
yet, because its drivers hand the readers neither the window's busy
intervals nor a fleet rank's spans. Temporary: it swaps in its own
``core.report``, ``train.Window``, ``infer.Window`` and ``fleet._rank`` at
run time, a fork of ``run.py``'s path that goes once the harness's
``Readings`` carry the program's spans and the window's intervals and the
readers read them from there::

    python3 benchmark/program_spans.py --workload <cell> --seed <n> --seconds <s> \\
        [--recorder profile|on]

from the root of a checkout on the cell's cards. ``--recorder profile`` (the
default) runs the cell as ``run.py --trace 1`` does, the port recording its
spans while the window's profiler runs, prints ``run.py``'s result line and
then, as the last line, one JSON object ``{"program": ...}``: the window's
idle share inside each span of the thread that drives it
(``idle_pct_in``), its longest idle gaps named by the innermost program span
there (``idle_gaps_program``; the harness's span, else ``host``, where none
covers the gap), each span's mean host and device ms and count, the device
to host copies against ``predict.fetch`` (``dtoh_in_fetch``), and the
window's collective calls and MB (``parallel/mesh.py``) a step or a
batch, and each ``loader.fill``'s host ms. On a fleet, rank 0's. ``--recorder on`` turns the
recorder on, with device time, for the whole run (every rank's), and runs
the cell as ``run.py --trace 0``: its result line alone, to set against
``run.py``'s for what the recorder costs when it is on.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here, as in run.py

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (HERE, os.path.dirname(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from snetbench import core, program, trace  # noqa: E402
from snetbench.drivers import fleet, infer, train  # noqa: E402

OUT_ENV = "SNET_PROGRAM_SPANS_OUT"  # where a fleet's rank 0 writes what it read
ON_ENV = "SNET_PROGRAM_SPANS_ON"  # every rank turns the recorder on
_windows = []


def _counters() -> dict:
    from selectivenet_for_semantic_segmentation_binary_torch.parallel import mesh

    return {"collective_calls": mesh.collective_calls,
            "collective_bytes": mesh.collective_bytes}


class KeptWindow(trace.Window):
    """The harness's window, keeping its device to host copies and the
    port's counters over it."""

    def __enter__(self):
        self.counters0 = _counters()
        self.dtoh = []
        _windows.append(self)
        return super().__enter__()

    def close(self, sync) -> None:
        super().close(sync)
        now = _counters()
        self.counters = {k: now[k] - self.counters0[k] for k in now}

    def _read(self, prof) -> None:
        export = prof.export_chrome_trace

        def keep(path):
            export(path)
            with open(path) as f:
                data = json.load(f)
            base = int(data.get("baseTimeNanoseconds", 0))
            for e in data.get("traceEvents", []):
                if (e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                        and "DtoH" in e.get("name", "")
                        and int(e.get("args", {}).get("device", self.device_index))
                        == self.device_index):
                    ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
                    self.dtoh.append((base + int(ts * 1e3), base + int((ts + dur) * 1e3)))
            self.dtoh.sort()

        prof.export_chrome_trace = keep
        super()._read(prof)


def _keep_windows() -> None:
    train.Window = KeptWindow
    infer.Window = KeptWindow


def _recorder_on() -> None:
    from selectivenet_for_semantic_segmentation_binary_torch.utils import tracing

    tracing.enable()


def kept(window: KeptWindow) -> dict:
    """What ``read`` needs of a closed window, as plain values."""
    return {k: getattr(window, k) for k in
            ("t0_ns", "t1_ns", "intervals", "busy_s", "seconds", "dtoh", "counters")}


def read(spans: list, window: dict, thread: int, harness=(), steps: int = 0,
         batches: int = 0) -> dict:
    """What the window's spans, intervals and counters say (see the module)."""
    t0, t1, busy = window["t0_ns"], window["t1_ns"], window["intervals"]
    names = sorted({s.name for s in spans})
    mine = sorted({s.name for s in spans if s.thread == thread})
    per = steps or batches or 1
    c = window["counters"]
    busy_s, seconds = window["busy_s"], window["seconds"]
    out = {
        "window_s": seconds, "steps": steps, "batches": batches,
        "device_idle_pct": 100.0 * (1.0 - busy_s / seconds) if busy_s is not None else None,
        "idle_pct_in": {n: program.idle_in_pct(spans, n, thread, busy, t0, t1) for n in mine},
        "idle_gaps_program": program.idle_gaps(spans, thread, busy, t0, t1, harness),
        "host_ms": {n: program.mean_host_ms(spans, n) for n in names},
        "device_ms": {n: program.mean_device_ms(spans, n) for n in names
                      if program.mean_device_ms(spans, n) is not None},
        "count": {n: len(program.named(spans, n)) for n in names},
        "fill_ms": [(s.end_ns - s.start_ns) / 1e6 for s in program.named(spans, "loader.fill")],
        "counters": c,
        "collective_calls_per": c.get("collective_calls", 0) / per,
        "collective_mb_per": c.get("collective_bytes", 0) / 1e6 / per,
    }
    if window["dtoh"]:
        out["dtoh_in_fetch"] = program.copies_inside(spans, "predict.fetch", window["dtoh"])
    return out


def _rank(r, path: str) -> None:
    """A fleet rank as ``drivers/fleet._rank``, its window kept; rank 0 also
    writes what ``read`` needs to ``$SNET_PROGRAM_SPANS_OUT``."""
    from selectivenet_for_semantic_segmentation_binary_torch.parallel import multihost

    _keep_windows()
    if os.environ.get(ON_ENV):
        _recorder_on()
    fleet._rank(r, path)
    if multihost.process_info()[0] == 0 and _windows and os.environ.get(OUT_ENV):
        with open(os.environ[OUT_ENV], "wb") as f:
            pickle.dump({"spans": program.spans(), "window": kept(_windows[-1]),
                         "thread": threading.main_thread().native_id}, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", choices=("profile", "on"), default="profile")
    args = ap.parse_args(argv)
    traced = args.recorder == "profile"
    run_argv = ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                str(args.seconds), "--trace", "1" if traced else "0"]
    outcomes = []
    report = core.report

    def keep(a, out, *rest):
        outcomes.append(out)
        return report(a, out, *rest)

    core.report = keep
    _keep_windows()
    fleet_cell = core.traffic(core.workload(core.benchmark_file(), args.workload)["traffic"])[
        "kind"] == "fleet"
    with tempfile.TemporaryDirectory(prefix="snet_program_") as tmp:
        os.environ[OUT_ENV] = os.path.join(tmp, "rank0.pkl")
        if not traced:
            os.environ[ON_ENV] = "1"
            _recorder_on()
        if fleet_cell:
            fleet._rank = _rank
        rc = core.main(run_argv, T0)
        if rc != 0 or not traced or not outcomes:
            return rc
        out = outcomes[-1]
        harness = out.readings.spans.items if out.readings.spans is not None else ()
        if fleet_cell:
            with open(os.environ[OUT_ENV], "rb") as f:
                got = pickle.load(f)
            spans, window, thread = got["spans"], got["window"], got["thread"]
        else:
            spans, window = program.spans(), kept(_windows[-1])
            thread = threading.main_thread().native_id
    line = read(spans, window, thread, harness, out.readings.steps, out.readings.batches)
    print(json.dumps({"program": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
