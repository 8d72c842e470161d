"""Several processes, one card each: the fleet's ``torch.distributed`` set-up.

Counterpart of the JAX package's ``parallel/multihost.py:1-89``. There, every
host calls ``jax.distributed.initialize`` and one jitted step runs over
batch-sharded global arrays. Here every card is one process, and the
process group carries what XLA's cross-chip reductions carry there:

1. ``initialize()`` joins the fleet: torchrun's ``env://`` variables
   (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
   ``MASTER_PORT``), SLURM's or MPI's rank variables with ``MASTER_ADDR`` and
   ``MASTER_PORT``, or an explicit ``init_method``, ``world_size`` and
   ``rank`` (the tests use a ``file://`` store). The backend is NCCL where a
   card is visible and gloo on the CPU, unless the caller names one;
2. the loss, the coverage and the BatchNorm statistics are global-batch
   quantities: their per-rank sums go through ``parallel.mesh.all_reduce_sum``
   before any division, and the gradients are averaged over the ranks;
3. each rank decodes only its contiguous slice of every global batch
   (``PatchLoader(process_index=..., process_count=...)``).

Without a launcher's variables ``initialize()`` does nothing and the run is
one process, as before. With them, a failed initialisation raises: a rank
that quietly ran alone beside its peers would also think it is the writer
(``is_writer``), and two writers tear each other's checkpoints.

Every collective of the port is ``all_reduce`` or ``broadcast``, counted in
``mesh.all_reduce_`` and ``mesh.broadcast_``: gloo runs both on CUDA tensors
too, so two ranks can share one card under gloo.
``spawn`` runs a function in one process per card from a single command
(``--local_rank a b ...`` without torchrun), through a file store in a
temporary directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# (world, rank, local rank) variables of each launcher, in the order they
# are looked for: torchrun, SLURM's srun, Open MPI, MPICH/Intel MPI
_LAUNCHER_ENV = (
    ("WORLD_SIZE", "RANK", "LOCAL_RANK"),
    ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"),
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"),
    ("PMI_SIZE", "PMI_RANK", "MPI_LOCALRANKID"),
)

_local_rank = 0


def launcher_env() -> Optional[Tuple[int, int, int, str]]:
    """``(world, rank, local_rank, variable)`` from the first launcher whose
    world-size variable is set, or None when no launcher started this
    process."""
    for world_key, rank_key, local_key in _LAUNCHER_ENV:
        if os.environ.get(world_key):
            return (int(os.environ[world_key]), int(os.environ.get(rank_key, "0")),
                    int(os.environ.get(local_key, "0")), world_key)
    return None


def default_backend() -> str:
    """NCCL where a card is visible, else gloo."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, local_rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the fleet (``torch.distributed.init_process_group``); a no-op
    when a group exists already or no launcher started this process.

    With no arguments the launcher's variables decide: torchrun's
    ``WORLD_SIZE`` (a group even of one rank: the launcher asked for one),
    or SLURM's/MPI's task count when it is above 1, through ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``). Any failure then raises. With an
    ``init_method`` the caller gives ``world_size`` and ``rank`` too.
    ``local_rank`` (default: the launcher's, else ``rank``) names this
    process's card, ``cuda:local_rank``; NCCL is bound to it."""
    global _local_rank
    if dist.is_initialized():
        return
    if init_method is None and world_size is None and rank is None:
        found = launcher_env()
        if found is None:
            return  # one process: no launcher asked for a fleet
        world_size, rank, env_local, variable = found
        if variable != "WORLD_SIZE" and world_size == 1:
            return  # a one-task SLURM/MPI job
        init_method = "env://"
        local_rank = env_local if local_rank is None else local_rank
    if world_size is None or rank is None:
        raise ValueError("initialize(init_method=...) needs world_size and rank")
    backend = backend or default_backend()
    _local_rank = int(rank if local_rank is None else local_rank)
    if backend == "nccl":
        torch.cuda.set_device(_local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank))


def shutdown() -> None:
    """Leave the fleet (``destroy_process_group``), if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def group():
    """The fleet's process group, or None for a run of one process."""
    return dist.group.WORLD if dist.is_initialized() else None


def process_info(pg=None) -> Tuple[int, int]:
    """``(rank, world)``: ``(0, 1)`` outside a fleet."""
    if pg is None:
        pg = group()
    if pg is None:
        return 0, 1
    return dist.get_rank(pg), dist.get_world_size(pg)


def is_writer() -> bool:
    """Whether this process owns the run's files: rank 0, or the only one."""
    return process_info()[0] == 0


def local_device() -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK`` (``cuda:0`` outside a fleet)."""
    return torch.device("cuda", _local_rank if dist.is_initialized() else 0)


def _flag_device(pg) -> torch.device:
    """Where a collective's small host value lives: NCCL takes only CUDA
    tensors, gloo any."""
    if dist.get_backend(pg) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(pg=None) -> None:
    """Wait for every rank: an ``all_reduce`` of one integer (the port's
    collectives are ``all_reduce`` and ``broadcast`` only)."""
    agree(True, pg)


def agree(ok: bool, pg=None) -> bool:
    """True on every rank iff ``ok`` is true on every rank (an ``all_reduce``
    MIN of an integer flag); ``ok`` itself outside a fleet."""
    if pg is None:
        pg = group()
    if pg is None:
        return bool(ok)
    from .mesh import all_reduce_  # mesh imports this module

    flag = torch.tensor([int(bool(ok))], dtype=torch.int32, device=_flag_device(pg))
    return bool(all_reduce_(flag, pg, "min").item())


def broadcast_flag(value: bool, pg=None) -> bool:
    """Rank 0's ``value`` on every rank (``value`` itself outside a fleet)."""
    if pg is None:
        pg = group()
    if pg is None:
        return bool(value)
    from .mesh import broadcast_  # mesh imports this module

    flag = torch.tensor([int(bool(value))], dtype=torch.int32, device=_flag_device(pg))
    return bool(broadcast_(flag, 0, pg).item())


def _spawned(rank: int, world: int, init_method: str, backend: str,
             target: Callable, args: Sequence) -> None:
    initialize(init_method=init_method, world_size=world, rank=rank, local_rank=rank,
               backend=backend)
    try:
        target(*args)
    finally:
        shutdown()


def spawn(target: Callable, args: Sequence, nprocs: int, backend: Optional[str] = None) -> None:
    """Run ``target(*args)`` in ``nprocs`` new processes, rank r on
    ``cuda:r``, joined through a file store in a temporary directory.
    ``target`` must be importable by name (a module-level function). A rank
    that raises makes ``torch.multiprocessing.spawn`` end the others and
    raise here."""
    import torch.multiprocessing as mp

    store = tempfile.mkdtemp(prefix="snet_fleet_")
    try:
        mp.spawn(_spawned, nprocs=nprocs, join=True,
                 args=(nprocs, f"file://{os.path.join(store, 'store')}",
                       backend or default_backend(), target, tuple(args)))
    finally:
        shutil.rmtree(store, ignore_errors=True)
