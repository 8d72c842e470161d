"""The readings the limits of ``limits/<workload>.json`` are set from, on
the chip at the cell's own size::

    python3 benchmark/controls.py --workload <name> --program-seeds S ... \
        [--fault-seeds S ... [--faults NAME ...]] [--control-seeds S ...] \
        [--seconds 1] [--out FILE]

(``--device cpu --small '{"batch": 8, ...}'`` makes a dry run on the CPU at
a small size.)

In one process (on a fleet, one set of ranks), one JSON object a line:

* ``--program-seeds``: a whole run of the cell for each (set-up, a short
  window, the comparison), its compared numbers (side ``program``); in a
  training cell also the window's checked step taken by the reference from
  the program's state in the nearest precision below the configuration's
  (float8 e4m3 operands in every conv: ``window_control_fp8``) and with half
  of the batch left out (``window_half_batch``), each against the float32
  reference's step;
* ``--fault-seeds``, a whole run each of the program with each fault of
  ``--faults`` planted (``snetbench/faults.py``): on a fleet by default its
  gradient mean over the ranks taken out (``no_exchange``), in a one-card
  training cell its loss times 1.05 from the window's first step on
  (``loss_altered_in_window``);
* ``--control-seeds``: the reference put in the program's place, against
  the float32 reference by the same numbers: bf16 -> float8 e4m3 operands
  (``control_fp8``), int8 -> int4 levels, qmax 7 (``control_int4``); in a
  training cell also half of each batch left out (``half_batch``) and steps
  that leave the state unchanged (``state_unchanged``; ``update_gap`` reads 1
  by its definition).
"""

import argparse
import contextlib
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    sys.path.insert(0, HERE)
    from snetbench import core

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=None)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", type=json.loads, default=None)
    a = ap.parse_args(argv)
    core.set_cache_dirs()
    import tempfile

    import torch

    from reference import unet_b as ref
    from snetbench import compare, data, faults

    bench = core.benchmark_file()
    wl = core.workload(bench, a.workload)
    cfg, tr = core.config(wl["config"]), core.traffic(wl["traffic"])
    kind = tr["kind"]
    out = open(a.out, "a") if a.out else sys.stdout

    def emit(seed, side, numbers, **more):
        out.write(json.dumps({"workload": a.workload, "side": side, "seed": seed,
                              "numbers": numbers, **more}) + "\n")
        out.flush()

    def run_for(seed):
        args = argparse.Namespace(workload=a.workload, seed=seed % (1 << 63),
                                  seconds=a.seconds, trace=0)
        r = core.Run(args, wl, cfg, tr, time.perf_counter(), device=torch.device(a.device, 0),
                     small=a.small, controls=True)
        return r

    with tempfile.TemporaryDirectory(prefix="snetbench_controls_") as tmp:
        if kind == "fleet":
            from snetbench.drivers import fleet

            r = run_for(0)
            r.tmpdir = tmp
            plan = ([(s % (1 << 63), "program") for s in a.program_seeds]
                    + [(s % (1 << 63), f) for s in a.fault_seeds
                       for f in a.faults or ["no_exchange"]])
            for seed, side, numbers, controls, e2e in fleet.readings(r, plan):
                emit(seed, side, numbers, e2e=e2e)
                for name, n in controls.items():
                    emit(seed, f"window_{name}", n)
        else:
            driver = importlib.import_module(f"snetbench.drivers.{kind}")
            for seed, side in ([(s, "program") for s in a.program_seeds]
                               + [(s, f) for s in a.fault_seeds
                                  for f in a.faults or ["loss_altered_in_window"]]):
                r = run_for(seed)
                r.tmpdir = tmp
                with (faults.planted(side) if side != "program" else contextlib.nullcontext()):
                    o = driver.run(r)
                emit(seed, side, o.numbers, e2e=o.e2e, attempted=o.attempted, failed=o.failed)
                for name, n in o.controls.items():
                    emit(seed, f"window_{name}", n)
                torch.cuda.empty_cache()
        for seed in a.control_seeds:
            r = run_for(seed)
            dev = r.device
            w = data.make_weights(ref.leaves(), tr["init"], r.args.seed, dev)
            if kind in ("train", "fleet"):
                from snetbench.drivers import train

                s = train.sizes(r)
                pool = data.patch_pool(s["pool"], s["side"], r.args.seed, dev)
                base = train.reference(r, s, w, pool)
                faults = {"control_fp8": train.reference(r, s, w, pool, lowp=ref.fp8_operands),
                          "half_batch": train.reference(r, s, w, pool, rows_kept=s["batch"] // 2),
                          "state_unchanged": train.reference(r, s, w, pool, update=False)}
                for name, f in faults.items():
                    emit(seed, name, compare.train_numbers(f, base, w))
            else:
                from snetbench.drivers import infer

                s = infer.sizes(r)
                pool, _ = data.patch_pool(s["pool"], s["side"], r.args.seed, dev)
                calib, _ = data.patch_pool(s["calib"], s["side"], r.args.seed, dev,
                                           stream="calib")
                images = [pool[i * s["batch"]:(i + 1) * s["batch"]]
                          for i in range(min(tr["sample_calls"], s["pool"] // s["batch"]))]
                scales, base = infer.reference_answers(r, w, calib, images)
                lscales, low = infer.reference_answers(r, w, calib, images, qmax=7.0)
                numbers = compare.answer_numbers([compare.from_compact(x) for x in low], base)
                numbers["scale_gap"] = max(abs(lscales[k] - v) / v for k, v in scales.items())
                emit(seed, "control_int4", numbers)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
