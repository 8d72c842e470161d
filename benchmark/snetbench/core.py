"""One run of one cell: arguments, the files found by name, the device
check, the driver, the comparison with the limits, and the result line.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the model, as run;
* ``traffic/<traffic>.json``: the traffic's parameters; its ``kind`` names
  the driver (``drivers/<kind>.py``) that generates and runs it;
* ``limits/<workload>.json``: the cell's compared numbers and their limits;
* ``metrics/<metric>.py``: a reader, ``read(r) -> float or None``, of one
  per-layer metric from the run's ``Readings``; where there is none, the
  reader of the name's stem before its first dot (``metrics/device_idle.py``
  reads ``device_idle.train`` and ``device_idle.infer``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)  # the checkout
# top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "selectivenet_for_semantic_segmentation_binary_tpu")
PORT = "selectivenet_for_semantic_segmentation_binary_torch"


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.seed = args.seed % (1 << 63)
    return args


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc builds sit in its own ``kernels/_build/``)."""
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.append(ROOT)


def load_json(*parts) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_file() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE, "configs", f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE, "traffic", f"{name}.json")


def limits(workload_name: str) -> Dict[str, float]:
    return load_json(HERE, "limits", f"{workload_name}.json")["limits"]


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"snetbench_metric_{len(name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, wl_name: str) -> tuple:
    """(end-to-end entries, per-layer entries) that this cell reports."""
    e2e = [m for m in bench["end_to_end"] if wl_name in m.get("workloads", [wl_name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (wl_name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


@dataclass
class Run:
    """What a driver needs: the arguments, the cell's files, the device."""
    args: argparse.Namespace
    workload: dict
    config: dict
    traffic: dict
    t0: float  # process start on the perf_counter clock: set-up begins here
    device: Any = None
    tmpdir: str = ""
    small: Optional[dict] = None  # tests: overrides of sizes on the CPU
    controls: bool = False  # controls.py: also read the controls a driver can read


@dataclass
class Readings:
    """What the per-layer readers read: the window, the trace, the spans,
    the program's counters, and the cell's counts."""
    window_s: float
    chips: int
    steps: int = 0
    batches: int = 0
    batch: int = 0
    kernels: list = field(default_factory=list)  # [(name, us)] on the first card
    busy_s: Optional[float] = None
    spans: Any = None
    counters: dict = field(default_factory=dict)


@dataclass
class Outcome:
    """A driver's result: end-to-end values, readings, compared numbers."""
    e2e: Dict[str, float]
    readings: Readings
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    kind: str
    count: int
    busy_s: Optional[float] = None
    breakdown: Optional[dict] = None
    notes: List[str] = field(default_factory=list)
    # forbidden modules that other processes of the run (a fleet's ranks) loaded
    loaded: List[str] = field(default_factory=list)
    controls: Dict[str, Dict[str, float]] = field(default_factory=dict)


def judge(numbers: Dict[str, float], lim: Dict[str, float]) -> tuple:
    """(correct, [(name, value, limit)]): every number the cell's limits name,
    at or under its limit; one that was not read, or is not finite, fails."""
    rows, ok = [], True
    for name in sorted(lim):
        v, l = numbers.get(name, float("nan")), lim[name]
        rows.append((name, v, l))
        if not (math.isfinite(v) and math.isfinite(l) and v <= l):
            ok = False
    return ok, rows


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    args = parse(argv)
    set_cache_dirs()
    bench = benchmark_file()
    wl = workload(bench, args.workload)
    run = Run(args, wl, config(wl["config"]), traffic(wl["traffic"]), t0)
    lim = limits(wl["name"])
    e2e_entries, layer_entries = cell_metrics(bench, wl["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s): torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    run.device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="snetbench_") as tmp:
        run.tmpdir = tmp
        driver = importlib.import_module(f"snetbench.drivers.{run.traffic['kind']}")
        out = driver.run(run)
    return report(args, out, lim, e2e_entries, layer_entries)


def report(args, out: Outcome, lim, e2e_entries, layer_entries) -> int:
    correct, rows = judge(out.numbers, lim)
    correct = correct and out.failed == 0
    if args.trace:
        metrics = {}
        for m in layer_entries:
            v = metric_reader(m["name"])(out.readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in e2e_entries}
    found = forbidden_modules()
    if found or out.loaded:
        print(f"loaded in the reporting process: {', '.join(found) or 'none'}; "
              f"in the run's other processes: {', '.join(out.loaded) or 'none'}",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": out.kind, "count": out.count,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if args.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.readings.window_s
    line = {"correct": bool(correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if args.trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {n: {"value": v, "limit": l} for n, v, l in rows}
    for note in out.notes:
        print(note, file=sys.stderr)
    for n, v, l in rows:
        print(f"check {n} {v!r} limit {l!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
