"""The cards a run uses, the fleet's checks, and its reductions.

Counterpart of the JAX package's ``parallel/mesh.py:33-111``. The JAX step is
one ``jax.jit`` over batch-sharded global arrays, so its means are global
means with no extra code. The port runs one process per card (training and
evaluation, ``parallel/multihost.py``) or splits a batch over the cards of
one process (serving), and says each reduction out loud:

* ``make_mesh``: the cards of one process, the first ``n_devices`` visible
  ones (all by default), as JAX ``make_mesh`` takes
  ``min(n_devices, len(jax.devices()))``; ``shard_apply`` splits a batch over
  them on dim 0 (``--shard_windows``, ``--shard_chips 1``);
* ``make_mesh_dp_sp``: the (dp, sp) ``Grid`` of a training or evaluation
  run's ranks, with JAX's divisibility checks and messages: rank r holds
  rows block ``r % sp`` of the examples of data-parallel group ``r // sp``
  (JAX ``make_mesh_2d``'s row-major layout), and each group of ``sp``
  consecutive ranks gets a process group of its own for the halo exchange
  (``parallel/spatial.py``); ``make_mesh_2d`` (in ``spatial.py``) is the
  2-D form of ``Mesh``, ``Mesh2D``, for the one-process spatial forward;
* ``all_reduce_sum``: an ``all_reduce`` of per-rank sums that autograd sees
  through (its backward is an ``all_reduce`` of the gradients). A loss built
  from such sums is the same value on every rank; backward then gives each
  rank ``world`` times its share of the global gradient, and
  ``mean_gradients`` (the mean over ranks) makes that the gradient of the
  global loss, as one process computes it on the whole batch;
* ``all_reduce_`` for counts and extrema that autograd does not see.

Every collective of the port goes through ``all_reduce_`` or ``broadcast_``,
which count it: ``collective_calls`` and ``collective_bytes`` (the bytes of
the tensor handed over) are plain module integers of this process, always
on, read as differences.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .multihost import process_info


DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

collective_calls = 0
collective_bytes = 0


@dataclass(frozen=True)
class Mesh:
    """The cards one process splits its batches over, in order; ``size`` of them."""

    devices: Tuple[torch.device, ...]
    axis_names = (DATA_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclass(frozen=True)
class Mesh2D:
    """A (DATA_AXIS, SPATIAL_AXIS) grid of entries, row-major: ``devices[i][j]``
    holds row block j of example block i (JAX ``make_mesh_2d``'s mesh)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names = (DATA_AXIS, SPATIAL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices), SPATIAL_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


@dataclass(frozen=True)
class Grid:
    """The (dp, sp) layout of a training or evaluation run's ranks: ``rank``
    sits at (``rank // sp``, ``rank % sp``) and holds row block ``sp_index``
    of the examples of data-parallel group ``dp_index``; ``sp_group`` is the
    process group of its ``sp`` row blocks (None where sp is 1)."""

    dp: int
    sp: int
    rank: int = 0
    sp_group: Optional[Any] = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The first ``n_devices`` visible cards (all by default): JAX
    ``make_mesh``, which takes ``min(n_devices, len(jax.devices()))``. With
    ``device="cpu"`` the CPU is the one device. Without a card, and without
    the CPU asked for, it raises as the entry points do."""
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found (torch.cuda.is_available() is False); "
                               "pass device=\"cpu\" to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices) if n_devices is None else max(1, min(int(n_devices), len(devices)))
    return Mesh(tuple(devices[:n]))


def dp_sp_ways(world: int, sp_ways: int, batch_size: int, patch_size: int) -> Tuple[int, int]:
    """``(dp, sp)`` for a fleet of ``world`` ranks, with the checks and
    messages of JAX ``make_mesh_dp_sp``: the batch splits evenly over the
    data-parallel ways, and with ``sp_ways`` above 1, sp divides the rank
    count and each row block keeps a multiple of 8 rows (2^#pools, so that
    every pool and upconv stays within a block)."""
    sp = int(sp_ways or 1)
    if sp <= 1:
        if batch_size % world != 0:
            raise ValueError(f"batch_size {batch_size} must be divisible by the mesh "
                             f"size {world}")
        return world, 1
    if world % sp != 0:
        raise ValueError(f"sp_ways {sp} must divide the device count {world}")
    dp = world // sp
    if batch_size % dp != 0:
        raise ValueError(f"batch_size {batch_size} must be divisible by "
                         f"the data-parallel ways {dp} (= {world} devices / "
                         f"sp_ways {sp})")
    if patch_size % (8 * sp) != 0:
        raise ValueError(f"patch_size {patch_size} must be divisible by "
                         f"8 * sp_ways = {8 * sp}")
    return dp, sp


# sp -> (the world group, this rank's sp group in it): the groups are made once a fleet
_SP_GROUPS: Dict[int, Tuple[Any, Any]] = {}


def _sp_group(rank: int, world: int, sp: int):
    """This rank's group of ``sp`` consecutive ranks. Every rank makes every
    group, in the same order (``new_group`` is collective); the world's own
    group where sp is the whole world."""
    pg = dist.group.WORLD
    if sp == world:
        return pg
    cached = _SP_GROUPS.get(sp)
    if cached is None or cached[0] is not pg:
        groups = [dist.new_group(list(range(d * sp, (d + 1) * sp))) for d in range(world // sp)]
        cached = _SP_GROUPS[sp] = (pg, groups[rank // sp])
    return cached[1]


def make_mesh_dp_sp(n_devices: Optional[int], sp_ways: int, batch_size: int,
                    patch_size: int) -> Grid:
    """The (dp, sp) ``Grid`` of a training or evaluation run over the
    fleet's ranks (one rank for one process; the cards were chosen when the
    fleet was launched, so ``n_devices`` is not read again here), with JAX
    ``make_mesh_dp_sp``'s checks (``dp_sp_ways``). JAX refuses an sp group
    that spans processes, because its host loader does not slice rows; here
    every rank is a process and ``data/loader.py`` slices them."""
    del n_devices  # the launcher chose the cards
    rank, world = process_info()
    dp, sp = dp_sp_ways(world, sp_ways, batch_size, patch_size)
    return Grid(dp, sp, rank, _sp_group(rank, world, sp) if sp > 1 else None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the gradients over the ranks."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pg) -> torch.Tensor:
        ctx.pg = pg
        return all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), pg)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.pg), None


def all_reduce_sum(x: torch.Tensor, pg=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``pg``, differentiable; ``x`` itself
    when ``pg`` is None (one process)."""
    if pg is None:
        return x
    return _AllReduceSum.apply(x, pg)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _count(x: torch.Tensor) -> None:
    global collective_calls, collective_bytes
    collective_calls += 1
    collective_bytes += x.numel() * x.element_size()


def all_reduce_(x: torch.Tensor, pg=None, op: str = "sum") -> torch.Tensor:
    """In place, outside autograd: ``x`` summed (or its ``"min"``/``"max"``)
    over the ranks of ``pg``; nothing when ``pg`` is None."""
    if pg is not None:
        _count(x)
        dist.all_reduce(x, op=_OPS[op], group=pg)
    return x


def broadcast_(x: torch.Tensor, src: int, pg=None) -> torch.Tensor:
    """In place: rank ``src``'s ``x`` on every rank of ``pg``; nothing when
    ``pg`` is None."""
    if pg is not None:
        _count(x)
        dist.broadcast(x, src=src, group=pg)
    return x


def mean_gradients(params: Sequence[torch.nn.Parameter], pg) -> None:
    """Average every parameter's gradient over the ranks of ``pg``: one
    ``all_reduce`` of the gradients flattened into one buffer, then a
    division by the world size (exact for one rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), pg)
    flat.div_(dist.get_world_size(pg))
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view(g.shape))
        offset += n


def replicas(model: torch.nn.Module, home, mesh: Mesh,
             cache: Optional[Dict[torch.device, torch.nn.Module]] = None
             ) -> List[torch.nn.Module]:
    """``model`` on each card of ``mesh``: the model itself on ``home``, its
    own device, and a copy on every other card, kept in ``cache`` (when
    given) to be made once."""
    home = torch.device(home)
    cache = {} if cache is None else cache
    out = []
    for d in mesh.devices:
        if torch.device(d) == home:
            out.append(model)
        else:
            if d not in cache:
                cache[d] = copy.deepcopy(model).to(d)
            out.append(cache[d])
    return out


def shard_apply(fns: Sequence[Callable], x: torch.Tensor, mesh: Mesh):
    """``fns[i]`` (the forward of the replica on ``mesh.devices[i]``) applied
    to the i-th of ``mesh.size`` equal row blocks of ``x``, each copied to
    its card first; the outputs (a tensor or a tuple of them) gathered on
    ``mesh.devices[0]``. A batch that does not split evenly is padded by
    repeating its last row, and the padded rows' outputs are dropped (JAX
    ``tiled_inference`` pads its tail batch so). On one card this is
    ``fns[0](x)``."""
    n, k = x.shape[0], mesh.size
    if k == 1:
        return fns[0](x.to(mesh.devices[0], non_blocking=True))
    pad = (-n) % k
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    per = x.shape[0] // k
    outs = [fn(x[i * per:(i + 1) * per].to(dev, non_blocking=True))
            for i, (fn, dev) in enumerate(zip(fns, mesh.devices))]
    home = mesh.devices[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[j].to(home) for o in outs])[:n] for j in range(len(outs[0])))
    return torch.cat([o.to(home) for o in outs])[:n]
