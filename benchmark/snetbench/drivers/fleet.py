"""Training on a fleet: the ``train`` traffic over one process a card, each
rank a process spawned by the run through the port's
``parallel/multihost.spawn`` (NCCL, its file store under ``TMPDIR``). Each
rank runs ``drivers/train.train_cell`` with the fleet's process group: its
loader slice of every global batch, global BatchNorm and the gradient mean
over NCCL. Rank 0 gathers the fleet's totals, compares the fleet's step with
the reference's one-process step on the global batch, and hands its outcome
to this process, which prints it. Each rank, once its part of the run is
over, names the forbidden modules (``core.FORBIDDEN``) its own interpreter
loaded; the outcome carries them, and the result is refused if any did.
"""

from __future__ import annotations

import json
import os
import pickle
import time

from .. import core
from . import train


def _rank(r: core.Run, path: str) -> None:
    from selectivenet_for_semantic_segmentation_binary_torch.parallel import multihost

    rank, world = multihost.process_info()
    if r.device.type == "cuda":
        r.device = multihost.local_device()
    out = train.train_cell(r, rank, world, multihost.group())
    if rank == 0:
        with open(path, "wb") as f:
            pickle.dump(out, f)
    with open(f"{path}.modules{rank}", "w") as f:
        json.dump(core.forbidden_modules(), f)


def loaded_by_ranks(path: str, world: int) -> list:
    """``rank r: name`` for each forbidden module a rank loaded; a rank
    that left no list is named as unread."""
    found = []
    for rank in range(world):
        try:
            with open(f"{path}.modules{rank}") as f:
                found += [f"rank {rank}: {m}" for m in json.load(f)]
        except OSError:
            found.append(f"rank {rank}: unread")
    return found


def run(r: core.Run) -> core.Outcome:
    from selectivenet_for_semantic_segmentation_binary_torch.parallel import multihost

    path = os.path.join(r.tmpdir, "rank0_outcome.pkl")
    world = int(r.workload["chips"])
    multihost.spawn(_rank, (r, path), nprocs=world)
    with open(path, "rb") as f:
        out = pickle.load(f)
    out.loaded = loaded_by_ranks(path, world)
    return out


def _readings_rank(r: core.Run, path: str, plan: list) -> None:
    """``controls.py``'s fleet: one whole run of the cell (set-up, window,
    comparison) for each (seed, side) of ``plan`` in one set of ranks; a side
    other than ``program`` names a fault planted for its run
    (``faults.planted``). Rank 0 writes the list of (seed, side, numbers,
    the window's controls, end-to-end values)."""
    import contextlib

    from selectivenet_for_semantic_segmentation_binary_torch.parallel import multihost

    from .. import faults

    rank, world = multihost.process_info()
    if r.device.type == "cuda":
        r.device = multihost.local_device()
    found = []
    for seed, side in plan:
        r.args.seed, r.t0 = seed, time.perf_counter()
        with (faults.planted(side) if side != "program" else contextlib.nullcontext()):
            out = train.train_cell(r, rank, world, multihost.group())
        if rank == 0:
            found.append((seed, side, out.numbers, out.controls, out.e2e))
    if rank == 0:
        with open(path, "wb") as f:
            pickle.dump(found, f)


def readings(r: core.Run, plan: list) -> list:
    from selectivenet_for_semantic_segmentation_binary_torch.parallel import multihost

    path = os.path.join(r.tmpdir, "fleet_readings.pkl")
    multihost.spawn(_readings_rank, (r, path, plan), nprocs=int(r.workload["chips"]))
    with open(path, "rb") as f:
        return pickle.load(f)
