"""The UNet with its image rows split into blocks: a one-row halo from each
neighbouring block before every 3x3 conv.

Counterpart of the JAX package's ``parallel/spatial.py`` (``spatial_forward``
:125, ``make_mesh_2d`` :157, ``spatial_forward_2d`` :172,
``_halo_exchange_rows`` :42-50), and of what GSPMD does for JAX's
``--sp_ways`` step (JAX ``parallel/mesh.py:44-141``). The blocks stay exact:

* before every 3x3 conv, a block gets the last row of the block above it
  and the first row of the block below it; the top and bottom blocks get
  zeros there, which is the conv's own zero padding, and the conv then pads
  W only (``CBR.haloed``);
* 2x2 max-pools, the k2s2 ``UpConv``s and the 1x1 heads stay within a
  block, as long as each block keeps a multiple of 8 rows (2^#pools).

Two forms:

* one process (``spatial_forward``, ``spatial_forward_2d``): the eval-mode
  forward over the entries of a ``parallel.mesh.Mesh`` (row blocks) or
  ``Mesh2D`` (example blocks x row blocks), each block on its entry; a
  halo is a copy between entries (``halo_rows``), and BatchNorm runs from
  its running statistics. The model is the port's own (``build_model``,
  classic or ``folded=True``), whose weights are read where they are (a
  copy is made for an entry on another card); its ``selective`` and
  ``compute_dtype`` choose the heads and the dtype, where JAX takes them as
  arguments. The outputs are gathered on the mesh's first entry, as
  ``mesh.shard_apply`` gathers: JAX returns arrays sharded on H, which
  PyTorch has no counterpart for;
* a fleet (``--sp_ways``, ``models.set_process_group``): each rank holds
  one row block, and ``exchange_halo`` swaps the edge rows within the
  rank's sp group, differentiably: its backward sends each halo row's
  gradient back to the rank that owns the row, where it is added to the
  gradient of that edge row. Without that backward the conv gradients at
  the block edges would be wrong.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, SPATIAL_AXIS, Mesh, Mesh2D, all_reduce_, replicas


def halo_rows(blocks: Sequence[torch.Tensor], i: int) -> torch.Tensor:
    """Block ``i`` of the row blocks (N, C, h, W) with its neighbours' edge
    rows stitched on: (N, C, h + 2, W), zeros above the first block and
    below the last (the 3x3 conv's zero padding)."""
    x = blocks[i]
    top = blocks[i - 1][:, :, -1:].to(x.device) if i > 0 else 0.0
    bottom = blocks[i + 1][:, :, :1].to(x.device) if i + 1 < len(blocks) else 0.0
    return _with_rows(x, top, bottom)


def _with_rows(x: torch.Tensor, top, bottom) -> torch.Tensor:
    """(N, C, h + 2, W): ``top``, x and ``bottom`` (rows, or 0.0 for zeros) in
    x's memory format."""
    n, c, h, w = x.shape
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    out = torch.empty((n, c, h + 2, w), dtype=x.dtype, device=x.device, memory_format=fmt)
    out[:, :, :1] = top
    out[:, :, 1:-1] = x
    out[:, :, -1:] = bottom
    return out


class _HaloExchange(torch.autograd.Function):
    """``exchange_halo``. Both directions are one ``all_reduce`` (a sum)
    within the sp group of a zeroed (sp, 2, N, C, 1, W) buffer in which each
    rank writes its own slot: its first and last rows forward, the
    gradients of its two halo rows backward. Adding zeros is exact."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        s, k = dist.get_rank(group), dist.get_world_size(group)
        ctx.group, ctx.s, ctx.k = group, s, k
        edges = x.new_zeros((k, 2) + tuple(x[:, :, :1].shape))
        edges[s, 0] = x[:, :, :1]
        edges[s, 1] = x[:, :, -1:]
        all_reduce_(edges, group)
        return _with_rows(x, edges[s - 1, 1] if s > 0 else 0.0,
                          edges[s + 1, 0] if s + 1 < k else 0.0)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        s, k = ctx.s, ctx.k
        edges = g.new_zeros((k, 2) + tuple(g[:, :, :1].shape))
        edges[s, 0] = g[:, :, :1]    # the halo above: rank s - 1's last row
        edges[s, 1] = g[:, :, -1:]   # the halo below: rank s + 1's first row
        all_reduce_(edges, ctx.group)
        fmt = (torch.channels_last if g.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        dx = g[:, :, 1:-1].clone(memory_format=fmt)
        if s > 0:
            dx[:, :, :1] += edges[s - 1, 1]
        if s + 1 < k:
            dx[:, :, -1:] += edges[s + 1, 0]
        return dx, None


def exchange_halo(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's row block (N, C, h, W) with the edge rows of the ranks
    above and below it in ``group`` (its sp group, ranks in row order)
    stitched on: (N, C, h + 2, W), zeros at the image's top and bottom.
    Differentiable: the gradients of the two halo rows go back to their
    owners."""
    return _HaloExchange.apply(x, group)


def _blocks_forward(models: Sequence[torch.nn.Module], xs: List[torch.Tensor]):
    """The UNet trunk and heads on row blocks ``xs`` of one example block,
    block i with ``models[i]`` (the topology of ``models/unet.py::_trunk``)."""

    def cbr(name, xs):
        return [getattr(m, name).haloed(halo_rows(xs, i)) for i, m in enumerate(models)]

    def each(name, xs):
        return [getattr(m, name)(x) for m, x in zip(models, xs)]

    def cat(ups, skips):
        return [torch.cat([u, s], 1) for u, s in zip(ups, skips)]

    e1 = cbr("encoder_layer_1_2", cbr("encoder_layer_1_1", xs))
    e2 = cbr("encoder_layer_2_2", cbr("encoder_layer_2_1", each("pool", e1)))
    e3 = cbr("encoder_layer_3_2", cbr("encoder_layer_3_1", each("pool", e2)))
    b = cbr("decoder_layer_4_1", cbr("decoder_layer_4_2", each("pool", e3)))
    d3 = cbr("decoder_layer_3_1", cbr("decoder_layer_3_2", cat(each("unpool3", b), e3)))
    d2 = cbr("decoder_layer_2_1", cbr("decoder_layer_2_2", cat(each("unpool2", d3), e2)))
    d1 = cbr("decoder_layer_1_1", cbr("decoder_layer_1_2", cat(each("unpool1", d2), e1)))
    return [m._heads(f) for m, f in zip(models, d1)]


@contextlib.contextmanager
def _eval_mode(models: Sequence[torch.nn.Module]):
    modes = {id(m): (m, m.training) for m in models}
    for m, _ in modes.values():
        m.eval()
    try:
        yield
    finally:
        for m, training in modes.values():
            m.train(training)


def _sharded_forward(model: torch.nn.Module, x: torch.Tensor, grid) -> object:
    """The eval-mode forward of ``model`` on x (N, C, H, W), example block i
    and row block j on ``grid[i][j]``, gathered on ``grid[0][0]``."""
    home = next(model.parameters()).device
    out_dev = torch.device(grid[0][0])
    dp, sp = len(grid), len(grid[0])
    n, h = x.shape[0] // dp, x.shape[2] // sp
    cache = {}
    outs = []
    with torch.no_grad(), model._autocast(out_dev.type):
        for i, row in enumerate(grid):
            models = replicas(model, home, Mesh(tuple(torch.device(d) for d in row)), cache)
            with _eval_mode(models):
                blocks = [x[i * n:(i + 1) * n, :, j * h:(j + 1) * h].to(d, non_blocking=True)
                          for j, d in enumerate(row)]
                heads = _blocks_forward(models, blocks)
            if isinstance(heads[0], tuple):
                outs.append(tuple(torch.cat([o[k].to(out_dev) for o in heads], 1)
                                  for k in range(len(heads[0]))))
            else:
                outs.append(torch.cat([o.to(out_dev) for o in heads], 1))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[k] for o in outs]) for k in range(len(outs[0])))
    return torch.cat(outs)


def spatial_forward(model: torch.nn.Module, x: torch.Tensor, mesh: Mesh):
    """Eval-mode forward of ``model`` (``build_model``'s UNet_B or UNet,
    classic or BN-folded) with the rows of x (N, C, H, W) split into
    ``mesh.size`` blocks, one an entry of ``mesh``; H divisible by 8 *
    mesh size. Returns what ``model(x)`` returns ((N, H, W) logits, or
    (output, select, aux) when selective), gathered on ``mesh.devices[0]``."""
    n = mesh.size
    H = x.shape[2]
    if H % (8 * n) != 0:
        raise ValueError(f"H={H} must be divisible by 8*mesh={8 * n}")
    return _sharded_forward(model, x, [list(mesh.devices)])


def make_mesh_2d(batch_ways: int, spatial_ways: int, device=None) -> Mesh2D:
    """A (DATA_AXIS, SPATIAL_AXIS) mesh over the first ``batch_ways *
    spatial_ways`` cards, row-major; with ``device="cpu"``, a mesh of CPU
    entries."""
    n = batch_ways * spatial_ways
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")] * n
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh2D(tuple(tuple(devices[i * spatial_ways:(i + 1) * spatial_ways])
                        for i in range(batch_ways)))


def spatial_forward_2d(model: torch.nn.Module, x: torch.Tensor, mesh: Mesh2D):
    """Eval-mode forward with the examples of x (N, C, H, W) split over
    ``mesh``'s DATA_AXIS and each example block's rows over its
    SPATIAL_AXIS: halos pass only between the row blocks of one example
    block. N divisible by the data axis, H by 8 * the spatial axis; the
    outputs gathered on the mesh's first entry."""
    if set(getattr(mesh, "axis_names", ())) != {DATA_AXIS, SPATIAL_AXIS}:
        raise ValueError(f"mesh axes must be ({DATA_AXIS}, {SPATIAL_AXIS}), "
                         f"got {getattr(mesh, 'axis_names', None)}")
    dp, sp = mesh.shape[DATA_AXIS], mesh.shape[SPATIAL_AXIS]
    N, H = x.shape[0], x.shape[2]
    if N % dp != 0:
        raise ValueError(f"N={N} must be divisible by batch mesh axis {dp}")
    if H % (8 * sp) != 0:
        raise ValueError(f"H={H} must be divisible by 8*spatial mesh axis {8 * sp}")
    return _sharded_forward(model, x, mesh.devices)
