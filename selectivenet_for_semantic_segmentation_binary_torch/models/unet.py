"""U-Net / U-Net_B with optional SelectiveNet heads, in eval and train mode.

Counterpart of the JAX package's ``models/unet.py`` (CBR :281-382, UpConv
:385-418, Head :421-439, FusedCBR :478-560, fused trunk :563-612, trunk
:615-669, UNetB :672-713, UNet :716-757, build_model :760-864), which
follows reference model.py:

* ``CBR`` = Conv3x3(pad 1, bias) -> BatchNorm -> ReLU; channel schedule
  64/128/256 encoder, 512 bottleneck, k2s2 transposed-conv upsampling, skip
  concatenation in the order (upsampled, skip);
* ``UNetB``: 1-channel 1x1 head squeezed to (N, H, W); selective mode adds
  the 1-channel ``conv_select`` and ``conv_aux`` heads;
* ``UNet``: n_cls-channel head, selective heads with 2 and n_cls channels,
  returned channels-last (N, H, W, C) as the JAX package returns them;
* ``folded=True``: the BN-folded serving trunk (JAX ``CBR`` ``folded``),
  each CBR a conv and a ReLU, for state dicts from ``ops.fold_bn``;
* ``dropout_rate > 0``: the JAX package's two dropout sites (unet.py:600, 605,
  654, 660), ``drop_bottom`` after ``decoder_layer_4_1`` and ``drop3`` after
  ``decoder_layer_3_1``, in all three trunks. They are live in train mode
  and, for MC-dropout, in eval mode with ``forward(x, mc_dropout=True)``,
  and draw their masks from the ``generator`` the caller passes (a live
  dropout without one raises, as flax does without a 'dropout' key). They
  hold no parameters, so the state dict is the same at any rate.

Module names are the reference's torch names (``encoder_layer_1_1.0`` is the
conv of the first CBR, ``.1`` its BatchNorm; ``unpool3``; ``conv1x1``), so a
reference ``.pth`` loads with ``load_state_dict``. Inputs are NCHW, best in
``torch.channels_last`` memory, which is what ``eval_lib.device_preprocess``
makes from a uint8 NHWC batch without a copy. ``compute_dtype="bfloat16"``
runs the convs under ``torch.autocast`` with float32 parameters and BN
buffers; the heads are cast back to float32. On a card all heads run
together on their shared input as one hand-written kernel pair, forward
and backward (``ops.sel_heads``, K11), reading the ``Head`` modules'
parameters, where the kernels take them (up to 8 channels of all heads
together); elsewhere, and on the CPU, each ``Head`` runs its own conv.

Train mode follows flax, not ``nn.BatchNorm2d`` (``BatchNorm2d`` below):
the running variance is updated with the BIASED batch variance
var = max(E[y^2] - E[y]^2, 0), momentum 0.1 in torch's convention (flax's
0.9). ``fused=True`` runs the trunk on the fused-CBR dataflow of the JAX
package's ``_UNetTrunkFused``: within each CBR pair the first conv emits its
raw output and its BN affine, the second applies BN+ReLU as the prologue of
``ops.fused_cbr.fused_conv_stats`` (the CUDA kernel on the card) and takes
its own BN sums from the kernel's epilogue. Same modules and state dict as
the classic trunk, so checkpoints interchange. ``bn_stats="bfloat16"``
builds ``LowPrecStatsBN`` (bf16 batch statistics, the same state dict) in
the classic trunk; ``recomputing`` is the context of ``--remat``'s second
forward.

Several cards (``parallel/``): ``set_process_group`` hands the fleet's
process group to every BatchNorm and dropout site. Train-mode BatchNorm is
then global-batch BatchNorm (``global_batch_norm``), as the JAX package's
``nn.BatchNorm`` is under a batch-sharded jit: one all-reduce of the
per-rank moments, the global biased variance for the normalisation and the
running statistics, and one all-reduce in the backward, which makes the
gradient the global one; on the card PyTorch's native sync-BatchNorm
kernels, on the CPU a plain float32 version. A group of one rank holds the
whole batch, and BatchNorm stays local there.
``bn_mode="per_replica"`` builds ``GroupedBatchNorm`` (``--bn_mode
per_replica``, JAX unet.py:127-180): the reference's DataParallel
BatchNorm, per group of the global batch, on one card or across ranks.
"""

from __future__ import annotations

import contextlib
import functools
import math
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.fused_cbr import (bn_affine, eligible, fused_conv_stats,
                             fused_conv_stats_reference, moments_from_stats)
from ..ops import sel_heads
from ..ops.int8_conv import Int8STEConv, int8_conv
from ..parallel.mesh import all_reduce_, all_reduce_sum
from ..parallel.spatial import exchange_halo

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _fleet(pg):
    """``(pg, rank, world)`` for a group of several ranks; ``(None, 0, 1)``
    for one process or a group of one, whose batch is the global batch."""
    if pg is None or dist.get_world_size(pg) == 1:
        return None, 0, 1
    return pg, dist.get_rank(pg), dist.get_world_size(pg)


def _grid(pg, sp_group) -> Tuple[int, int, int, int]:
    """``(dp_index, dp, sp_index, sp)`` of this rank (``parallel.mesh.Grid``):
    the global batch's examples are split over the dp data-parallel groups,
    and each example's rows over the sp ranks of a group."""
    _, rank, world = _fleet(pg)
    sp = dist.get_world_size(sp_group) if sp_group is not None else 1
    return rank // sp, world // sp, rank % sp, sp


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode semantics (JAX
    models/unet.py:374-381, flax 0.12 ``use_fast_variance``).

    Eval mode is ``nn.BatchNorm2d``'s. In train mode the output is
    normalised with the biased batch variance (``torch.native_batch_norm``,
    which saves only its input and its float32 moments for the backward), and
    ``update_running`` moves the running statistics by the batch mean and
    the BIASED batch variance, recovered from the saved inverse std as
    invstd^-2 - eps. flax takes it as E[y^2] - E[y]^2 and PyTorch by
    Welford's method; in float32 the two agree to rounding.
    ``nn.BatchNorm2d``'s own update uses the unbiased variance, which
    differs by n/(n-1): at the bottleneck of a small batch that is several
    percent. eps 1e-5 and momentum 0.1 (torch's convention; flax's 0.9)
    are the defaults."""

    # set by ``recomputing`` while a rematerialised forward runs again in
    # the backward: the statistics move once a step, as in the JAX step
    frozen = False
    # the fleet's process group and this rank's sp group
    # (``set_process_group``); None: one process, or no row blocks
    pg = None
    sp_group = None

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self.frozen:
            return
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        pg = _fleet(self.pg)[0]
        if pg is not None:
            y, mean, var = global_batch_norm(x, self.weight, self.bias, self.eps, pg)
            self.update_running(mean, var)
            return y
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                  True, 0.0, self.eps)
        var = (invstd.detach().double() ** -2 - self.eps).clamp(min=0.0).float()
        self.update_running(mean.detach(), var)
        return y


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                      pg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm over the global batch of a fleet, whose rank
    holds ``x``: ``(y, mean, var)``, the biased variance, as flax's
    ``nn.BatchNorm`` computes them over a batch-sharded jit (JAX
    models/unet.py:374-381); y in x's dtype, ``mean`` and ``var`` float32
    and outside autograd. The gradient is the global batch's. On a CUDA
    tensor, PyTorch's native sync-BatchNorm kernels (``_GlobalBatchNorm``);
    on the CPU, which has none, the plain version."""
    if x.is_cuda:
        return _GlobalBatchNorm.apply(x, weight, bias, eps, pg)
    return global_batch_norm_reference(x, weight, bias, eps, pg)


class _GlobalBatchNorm(torch.autograd.Function):
    """``global_batch_norm`` from the kernels ``nn.SyncBatchNorm`` runs,
    with one ``all_reduce`` in each direction and the running statistics
    left to the caller (``nn.SyncBatchNorm`` moves the running variance by
    the unbiased variance, flax by the biased one):

    * forward: ``batch_norm_stats`` (this rank's mean and inverse std,
      Welford's), one ``all_reduce`` of ``n * [mean, E[x^2]]`` and ``n``,
      the global mean and var = E[x^2] - mean^2 (flax's fast variance,
      as the plain version), and ``batch_norm_elemt``;
    * backward: ``batch_norm_backward_reduce`` (this rank's sums of dy and
      dy * (x - mean), and the parameter gradients), one ``all_reduce`` of
      the two sums, and ``batch_norm_backward_elemt`` with the global
      count. As with ``all_reduce_sum``, each rank's gradients are then
      ``world`` times its share of the global ones until
      ``mean_gradients``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, pg):
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous()
        c, n = x.shape[1], x.numel() // x.shape[1]
        mean_r, invstd_r = torch.batch_norm_stats(x, eps)
        sq_r = torch.addcmul(invstd_r.pow(-2).sub_(eps), mean_r, mean_r)  # var + mean^2
        stats = torch.cat([mean_r, sq_r, mean_r.new_ones(1)]).mul_(n)
        all_reduce_(stats, pg)
        total = stats[2 * c:]
        mean = stats[:c] / total
        var = (stats[c:2 * c] / total - mean * mean).clamp_(min=0.0)
        invstd = (var + eps).rsqrt_()
        ctx.save_for_backward(x, weight, mean, invstd, total.round().to(torch.int32))
        ctx.pg = pg
        ctx.mark_non_differentiable(mean, var)
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, count = ctx.saved_tensors
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        dy = dy.contiguous(memory_format=fmt)
        sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
            dy, x, mean, invstd, weight, True, ctx.needs_input_grad[1],
            ctx.needs_input_grad[2])
        sums = torch.cat([sum_dy, sum_dy_xmu])
        all_reduce_(sums, ctx.pg)
        sum_dy, sum_dy_xmu = sums.split(x.shape[1])
        dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                                             count)
        return dx, dw, db, None, None


def global_batch_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                                eps: float, pg) -> Tuple[torch.Tensor, torch.Tensor,
                                                         torch.Tensor]:
    """The plain version of ``global_batch_norm``: one ``all_reduce_sum`` of
    ``[sum(x), sum(x^2), count]`` per channel in float32 (flax's fast
    variance, var = E[x^2] - E[x]^2), and y = x * a + b in float32, in x's
    dtype out; autograd sees through the all-reduce."""
    c = x.shape[1]
    with torch.autocast(device_type=x.device.type, enabled=False):
        x32 = x.float()
        count = torch.full((1,), float(x.numel() // c), device=x.device)
        sums = all_reduce_sum(torch.cat([x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3)),
                                         count]), pg)
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
        a = weight * torch.rsqrt(var + eps)
        b = bias - mean * a
        y = (x32 * a[None, :, None, None] + b[None, :, None, None]).to(x.dtype)
        return y, mean.detach(), var.detach()


class GroupedBatchNorm(BatchNorm2d):
    """Per-replica BatchNorm, ``--bn_mode per_replica`` (JAX
    ``GroupedBatchNorm``, models/unet.py:127-180): the reference's
    DataParallel BatchNorm (train.py:132-134), where each of the
    ``len(local_rank)`` replicas normalises its own sub-batch.

    * the GLOBAL batch is split into ``groups`` equal contiguous sub-batches
      (DataParallel's dim-0 scatter), each normalised with its own biased
      statistics;
    * the running statistics move from sub-batch 0 only, by its mean and
      its UNBIASED variance: only the replica on device 0 shares its buffers
      with the module DataParallel wraps;
    * parameters and buffers are ``nn.BatchNorm2d``'s, so checkpoints
      interchange with the global-BN path, and eval mode is the same.

    Where each rank's rows are whole groups (always on one process), each
    group is one ``torch.native_batch_norm`` call on its rows (Welford's
    variance, equal to the centred one to rounding), and group 0's
    statistics reach the other ranks by one all-reduce. Otherwise, on a
    fleet (``pg``) the rank of data-parallel group d holds global rows
    d*n .. (d+1)*n - 1 (with ``--sp_ways``, one row block of them): each
    rank sums its rows into the groups they belong to, and one all-reduce
    of a (groups, C) tensor a pass gives every group's statistics, in float32:
    the means, then the centred squares (JAX's two passes), as GSPMD
    computes them for the JAX module where the groups do not fall on rank
    boundaries. Either way every rank holds group 0's statistics, so the
    running statistics agree across ranks."""

    def __init__(self, num_features: int, groups: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)
        if groups < 1:
            raise ValueError(f"bn_groups must be >= 1, got {groups}")
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return nn.BatchNorm2d.forward(self, x)
        pg, rank, _ = _fleet(self.pg)
        d, dp, _, sp = _grid(self.pg, self.sp_group)
        n, c, h, w = x.shape
        total, g = n * dp, self.groups
        if total % g:
            raise ValueError(
                f"per-replica BatchNorm needs the batch size ({total}) divisible by the "
                f"replica count ({g}) — DataParallel scatters equal sub-batches "
                "(reference train.py:132-134)")
        count = (total // g) * h * sp * w  # elements per channel of one group
        if sp == 1 and n % (total // g) == 0:
            return self._forward_local_groups(x, total // g, count, pg, rank)
        with torch.autocast(device_type=x.device.type, enabled=False):
            x32 = x.float()
            rows = torch.arange(d * n, (d + 1) * n, device=x.device)
            gid = torch.div(rows, total // g, rounding_mode="floor")

            def group_sums(t):  # (n, C) row sums -> (G, C), summed over the ranks
                z = torch.zeros((g, c), dtype=torch.float32, device=x.device)
                return all_reduce_sum(z.index_add(0, gid, t), pg)

            gmean = group_sums(x32.sum((2, 3))) / count
            diff = x32 - gmean[gid][:, :, None, None]
            gvar = group_sums(diff.square().sum((2, 3))) / count
            self.update_running(gmean[0].detach(),
                                gvar[0].detach() * (count / max(count - 1, 1)))
            mul = self.weight[None, :] * torch.rsqrt(gvar + self.eps)
            return (diff * mul[gid][:, :, None, None]
                    + self.bias[None, :, None, None]).to(x.dtype)

    def _forward_local_groups(self, x: torch.Tensor, per: int, count: int, pg,
                              rank: int) -> torch.Tensor:
        """This rank's rows are whole groups of ``per`` rows: one native
        BatchNorm a group; group 0's mean and unbiased variance (rank 0's
        first group) move the running statistics on every rank."""
        ys, stats = [], None
        # split, not slices: the backward gathers the groups' gradients in one
        # cat, where each slice's backward would write a zero-filled whole
        for xg in x.split(per):
            y, mean, invstd = torch.native_batch_norm(xg, self.weight, self.bias,
                                                      None, None, True, 0.0, self.eps)
            ys.append(y)
            if stats is None:
                var = (invstd.detach().double() ** -2 - self.eps).clamp(min=0.0).float()
                stats = torch.stack([mean.detach(), var * (count / max(count - 1, 1))])
        if pg is not None:  # rank 0 holds group 0: the others add zeros
            stats = all_reduce_(stats if rank == 0 else torch.zeros_like(stats), pg)
        self.update_running(stats[0], stats[1])
        return torch.cat(ys)


def grouped_batch_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                                 running_mean: torch.Tensor, running_var: torch.Tensor,
                                 groups: int, momentum: float = 0.1, eps: float = 1e-5):
    """The plain version of ``GroupedBatchNorm``'s train mode on one whole
    batch, a loop over the groups: ``(y, new running mean, new running
    var)``."""
    xs = x.float().chunk(groups, 0)
    ys, stats = [], []
    for xg in xs:
        mean = xg.mean((0, 2, 3))
        var = (xg - mean[None, :, None, None]).square().mean((0, 2, 3))
        ys.append((xg - mean[None, :, None, None]) * torch.rsqrt(var + eps)[None, :, None, None]
                  * weight[None, :, None, None] + bias[None, :, None, None])
        stats.append((mean, var))
    count = xs[0].numel() // xs[0].shape[1]
    mean0, var0 = stats[0]
    new_mean = (1 - momentum) * running_mean + momentum * mean0
    new_var = (1 - momentum) * running_var + momentum * var0 * (count / max(count - 1, 1))
    return torch.cat(ys).to(x.dtype), new_mean, new_var


class LowPrecStatsBN(BatchNorm2d):
    """BatchNorm whose BATCH statistics are reduced in ``stats_dtype``
    (bfloat16), ``--bn_stats bfloat16`` (JAX ``LowPrecStatsBN``,
    models/unet.py:68-125).

    Parameters and buffers are ``nn.BatchNorm2d``'s (names, shapes, float32
    storage), so ``.pth`` files interchange and a JAX ``.ckpt`` trained with
    ``--bn_stats bfloat16`` loads; eval mode is the classic BN's. In train
    mode, x rounded to ``stats_dtype``:

    * mean = mean(x), and the TWO-PASS, centred, biased variance
      var = mean((x - mean)^2): the one-pass E[x^2] - E[x]^2 is exactly 0 in
      bf16 once |mean|/std >= ~16. Each mean sums in float32 and rounds to
      ``stats_dtype`` once, after the division, as ``jnp.mean`` of bf16
      does; x - mean and its square round to ``stats_dtype`` elementwise;
    * the normalisation (x - mean) * (gamma * rsqrt(var + eps)) + beta in
      x's dtype, the compute dtype (bf16 under autocast, where the conv
      output is bf16), eps rounded to it as JAX rounds it;
    * the running statistics in float32 from the rounded mean and variance,
      momentum 0.1 in torch's convention (flax's 0.9), eps 1e-5;
    * on a fleet, both sums are summed over the ranks (two all-reduces).

    The train-mode body runs with autocast off: CUDA's autocast would take
    ``rsqrt`` to float32 and the whole normalisation with it. The fused
    trunk has no such path and ``build_model`` refuses the combination, as
    the JAX package does."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 stats_dtype: torch.dtype = torch.bfloat16):
        super().__init__(num_features, eps=eps)
        self.stats_dtype = stats_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        d, sd = x.dtype, self.stats_dtype
        dims = (0, 2, 3)
        pg, _, world = _fleet(self.pg)
        n = x.numel() // x.shape[1] * world
        with torch.autocast(device_type=x.device.type, enabled=False):
            xs = x.to(sd)
            bmean = (all_reduce_sum(xs.sum(dims, dtype=torch.float32), pg) / n).to(sd)
            diff = xs - bmean[None, :, None, None]
            bvar = (all_reduce_sum((diff * diff).sum(dims, dtype=torch.float32), pg)
                    / n).to(sd)
            self.update_running(bmean.detach().float(), bvar.detach().float())
            eps = torch.full((), self.eps, dtype=d, device=x.device)
            mul = self.weight.to(d) * torch.rsqrt(bvar.to(d) + eps)
            return ((x - bmean.to(d)[None, :, None, None]) * mul[None, :, None, None]
                    + self.bias.to(d)[None, :, None, None])


Prologue = Optional[Tuple[torch.Tensor, torch.Tensor]]


def dropout(x: torch.Tensor, keep_mask: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout`` given its mask: ``x / keep`` where ``keep_mask``,
    else 0. The divisor is keep = 1 - rate rounded to x's dtype, as JAX
    rounds the weakly typed Python float: in bfloat16, 0.9 becomes
    0.8984375, and dividing by the float32 0.9 would round 1,338 of 4,096
    values differently."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    # a fill, not a copy from the host: no sync in a CUDA step
    keep = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep_mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """A dropout site (JAX ``nn.Dropout`` named ``drop_bottom`` or ``drop3``):
    with a ``generator`` it keeps each element with probability 1 - rate,
    the mask drawn as ``rand < 1 - rate`` in (N, H, W, C) order, the order
    of the JAX activation and of the fused trunk's NHWC views, so both
    trunks draw the same mask from the same generator state; without one
    it is the identity. On a fleet (``pg``) every rank draws the global
    batch's mask, (N * dp, H * sp, W, C), and keeps its own examples and,
    with ``--sp_ways`` (``sp_group``), its own rows of it: the masks of one
    process on the whole batch."""

    pg = None  # the fleet's process group (``set_process_group``)
    sp_group = None  # this rank's sp group; None: no row blocks

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                nhwc: bool = False) -> torch.Tensor:
        if generator is None:
            return x
        shape = tuple(x.shape if nhwc else x.permute(0, 2, 3, 1).shape)
        d, dp, s, sp = _grid(self.pg, self.sp_group)
        n, h = shape[:2]
        mask = torch.rand((n * dp, h * sp) + shape[2:], generator=generator,
                          device=x.device)[d * n:(d + 1) * n, s * h:(s + 1) * h] < 1.0 - self.rate
        return dropout(x, mask if nhwc else mask.permute(0, 3, 1, 2), self.rate)


class CBR(nn.Sequential):
    """Conv3x3 -> BatchNorm -> ReLU (reference model.py:9-15). BN constants
    are torch's defaults, which the JAX package matches (eps 1e-5).
    ``bn_stats="bfloat16"`` swaps in ``LowPrecStatsBN`` (the same state
    dict, bf16 batch statistics; JAX ``CBR``, unet.py:365-372), and
    ``bn_groups > 0`` ``GroupedBatchNorm`` (``--bn_mode per_replica``).

    With ``halo`` (set by ``set_process_group`` under ``--sp_ways``: the
    rank holds one row block of each image) the block first stitches its
    neighbours' edge rows on (``parallel.spatial.exchange_halo``) and runs
    ``haloed``."""

    halo: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __init__(self, in_ch: int, out_ch: int, bn_stats: str = "float32", bn_groups: int = 0):
        if bn_groups:
            bn = GroupedBatchNorm(out_ch, bn_groups, eps=1e-5)
        elif bn_stats == "float32":
            bn = BatchNorm2d(out_ch, eps=1e-5)
        else:
            bn = LowPrecStatsBN(out_ch, eps=1e-5, stats_dtype=_DTYPES[bn_stats])
        super().__init__(
            nn.Conv2d(in_ch, out_ch, kernel_size=3, stride=1, padding=1, bias=True),
            bn,
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.halo is None:
            return super().forward(x)
        return self.haloed(self.halo(x))

    def haloed(self, xh: torch.Tensor) -> torch.Tensor:
        """This block on a row block that carries one row of each neighbour
        (zeros at the image's edge): the conv pads W only, so the output
        has the block's own rows."""
        conv = self[0]
        return self[2](self[1](F.conv2d(xh, conv.weight, conv.bias, padding=(0, 1))))

    def fused(self, x: torch.Tensor, dtype: torch.dtype, prologue: Prologue = None,
              materialize: bool = True) -> Tuple[torch.Tensor, Prologue]:
        """This block on the fused dataflow (JAX ``FusedCBR``), NHWC in and out.

        x is the previous block's materialised output (``prologue`` None) or
        its raw conv output with its BN affine ``prologue = (a, b)``. The conv
        and its BN sums come from ``fused_conv_stats``; a conv the kernel does
        not take (the first, Cin = 3, and every float32 layer: ``eligible``)
        runs its plain version. In train mode
        the batch moments come from the sums and update the running
        statistics; in eval mode the running statistics are used and the
        sums are dropped. Returns relu(BN(y)) in ``dtype`` when
        ``materialize``, else the raw y and this block's affine."""
        conv, bn = self[0], self[1]
        n, h, w, cin = x.shape
        if prologue is None:
            a_in = torch.ones(cin, device=x.device)
            b_in = torch.zeros(cin, device=x.device)
        else:
            a_in, b_in = prologue
        op = (fused_conv_stats if eligible(cin, conv.out_channels, dtype)
              else fused_conv_stats_reference)
        y, stats = op(x.to(dtype).contiguous(), a_in, b_in,
                      conv.weight.to(dtype).permute(2, 3, 1, 0).contiguous(), conv.bias,
                      prologue is not None)
        if self.training:
            mean, var = moments_from_stats(stats, n * h * w)
            bn.update_running(mean.detach(), var.detach())
        else:
            mean, var = bn.running_mean, bn.running_var
        a, b = bn_affine(bn.weight, bn.bias, mean, var, bn.eps)
        if materialize:
            return torch.relu(y.float() * a + b).to(dtype), None
        return y, (a, b)


class QATCBR(CBR):
    """CBR with ``--train_quant int8`` (JAX ``CBR`` with ``train_quant``,
    unet.py:328-340): in train mode the conv is ``Int8STEConv`` (the
    dynamic-scale int8 forward, K10 on the card, and the bf16
    straight-through backward) plus the conv's bias, in the compute dtype;
    in eval mode (the valid and eval forwards) it is the plain float CBR.
    The parameters are the float conv's, so checkpoints interchange with
    every other path. On a fleet (``pg``) the activation scale is the
    global batch's absmax, as JAX's is over its batch-sharded jit. With a
    ``halo`` the int8 conv, which pads H itself, runs on the haloed block
    and its first and last output rows are dropped."""

    pg = None  # the fleet's process group (``set_process_group``)

    def __init__(self, in_ch: int, out_ch: int, compute_dtype: torch.dtype,
                 bn_stats: str = "float32", bn_groups: int = 0):
        super().__init__(in_ch, out_ch, bn_stats, bn_groups)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        conv = self[0]
        if self.halo is None:
            y = Int8STEConv.apply(x, conv.weight, _fleet(self.pg)[0])
        else:
            y = Int8STEConv.apply(self.halo(x), conv.weight, _fleet(self.pg)[0])[:, :, 1:-1]
        y = (y + conv.bias[None, :, None, None]).to(self.compute_dtype)
        return self[2](self[1](y))


class FoldedCBR(nn.Sequential):
    """The BN-folded serving block (JAX ``CBR`` with ``folded=True``,
    unet.py:281-382): Conv3x3 -> ReLU, the BN affine multiplied into the
    conv by ``ops.fold_bn.fold_batchnorm``. It keeps CBR's indices, ``.0``
    the conv and ``.2`` the ReLU, so a folded state dict loads by the
    unfolded model's names less the BN's.

    ``calibrating`` (``build_model(..., quant_calibrate=True)``) makes the
    block record its input's absmax in ``absmax`` (the JAX ``sow`` of
    ``in_absmax``, unet.py:310-314); ``calibration_absmax`` reads and clears
    it. ``haloed`` is ``CBR.haloed`` without the BN (``parallel.spatial``)."""

    calibrating = False
    absmax: Optional[torch.Tensor] = None

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(OrderedDict([
            ("0", nn.Conv2d(in_ch, out_ch, kernel_size=3, stride=1, padding=1, bias=True)),
            ("2", nn.ReLU(inplace=True)),
        ]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrating:
            # absmax from aminmax: exact, and no float32 copy of x
            lo, hi = torch.aminmax(x)
            v = torch.maximum(-lo, hi).float()
            self.absmax = v if self.absmax is None else torch.maximum(self.absmax, v)
        return super().forward(x)

    def haloed(self, xh: torch.Tensor) -> torch.Tensor:
        """The block on a row block that carries one row of each neighbour:
        the conv pads W only."""
        conv = self[0]
        return self._modules["2"](F.conv2d(xh, conv.weight, conv.bias, padding=(0, 1)))


class QuantConv(nn.Module):
    """The int8 conv's buffers under a quantized CBR's ``.0`` (JAX
    ``_QuantConvParams``, unet.py:202-218): ``kernel_q`` int8 (out, in, 3,
    3), held in channels_last memory so that its (out, 3, 3, in) view, the
    kernel's layout, is contiguous; ``kernel_scale`` (out,), ``act_scale``
    (a 0-dim float32) and ``bias`` (out,). The values come from
    ``ops.quant.quantize_folded``, never from an initialiser."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.register_buffer("kernel_q", torch.zeros(out_ch, in_ch, 3, 3, dtype=torch.int8)
                             .to(memory_format=torch.channels_last))
        self.register_buffer("kernel_scale", torch.ones(out_ch))
        self.register_buffer("act_scale", torch.ones(()))
        self.register_buffer("bias", torch.zeros(out_ch))


class QuantCBR(nn.Module):
    """The W8A8 serving block (JAX ``CBR`` with ``quantize=True``,
    unet.py:315-327): the input quantized with the static ``act_scale``, the
    int8 x int8 -> int32 conv, then dequant, bias and ReLU, in one call of
    ``ops.int8_conv.int8_conv`` (K10 on the card), its output in the
    compute dtype. Its buffers sit under FoldedCBR's index ``.0``. With a
    ``halo`` the int8 conv, which pads H itself, runs on the haloed block
    and its first and last output rows are dropped."""

    halo: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __init__(self, in_ch: int, out_ch: int, compute_dtype: torch.dtype):
        super().__init__()
        self.add_module("0", QuantConv(in_ch, out_ch))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.halo is not None:
            return self.haloed(self.halo(x))
        return self._conv(x)

    def haloed(self, xh: torch.Tensor) -> torch.Tensor:
        """The block on a row block that carries one row of each neighbour."""
        return self._conv(xh)[:, :, 1:-1]

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        q = self._modules["0"]
        y = int8_conv(x.permute(0, 2, 3, 1), q.kernel_q.permute(0, 2, 3, 1), q.act_scale,
                      q.kernel_scale, q.bias, out_dtype=self.compute_dtype)
        return y.permute(0, 3, 1, 2)


class UpConv(nn.ConvTranspose2d):
    """ConvTranspose(k=2, s=2, bias) upsampler (reference model.py:44-58)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, kernel_size=2, stride=2)


class Head(nn.Conv2d):
    """1x1 conv head (reference model.py:62-66, 150-154)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, kernel_size=1)


class _UNetBase(nn.Module):
    """The shared encoder/decoder trunk (reference model.py:29-61). Its
    layers are attributes of the model itself, as in the reference, so the
    state-dict keys carry no prefix."""

    def __init__(self, in_ch: int, compute_dtype: str, fused: bool = False,
                 folded: bool = False, dropout_rate: float = 0.0, bn_stats: str = "float32",
                 quantize: bool = False, train_quant: str = "none", bn_groups: int = 0):
        super().__init__()
        self.fused = fused
        self.folded = folded
        self.quantize = quantize
        self.dropout_rate = dropout_rate
        for name, value in (("compute_dtype", compute_dtype), ("bn_stats", bn_stats)):
            if value not in _DTYPES:
                raise ValueError(f"unknown {name} {value!r} (expected one of {sorted(_DTYPES)})")
        self.compute_dtype = _DTYPES[compute_dtype]
        if quantize:
            cbr = functools.partial(QuantCBR, compute_dtype=self.compute_dtype)
        elif folded:
            cbr = FoldedCBR
        elif train_quant == "int8":
            cbr = functools.partial(QATCBR, compute_dtype=self.compute_dtype, bn_stats=bn_stats,
                                    bn_groups=bn_groups)
        else:
            cbr = functools.partial(CBR, bn_stats=bn_stats, bn_groups=bn_groups)
        self.encoder_layer_1_1 = cbr(in_ch, 64)
        self.encoder_layer_1_2 = cbr(64, 64)
        self.encoder_layer_2_1 = cbr(64, 128)
        self.encoder_layer_2_2 = cbr(128, 128)
        self.encoder_layer_3_1 = cbr(128, 256)
        self.encoder_layer_3_2 = cbr(256, 256)
        self.decoder_layer_4_2 = cbr(256, 512)
        self.decoder_layer_4_1 = cbr(512, 512)
        self.unpool3 = UpConv(512, 256)
        self.decoder_layer_3_2 = cbr(512, 256)
        self.decoder_layer_3_1 = cbr(256, 256)
        self.unpool2 = UpConv(256, 128)
        self.decoder_layer_2_2 = cbr(256, 128)
        self.decoder_layer_2_1 = cbr(128, 128)
        self.unpool1 = UpConv(128, 64)
        self.decoder_layer_1_2 = cbr(128, 64)
        self.decoder_layer_1_1 = cbr(64, 64)
        self.pool = nn.MaxPool2d(2)
        self.drop_bottom = Dropout(dropout_rate)
        self.drop3 = Dropout(dropout_rate)

    def _autocast(self, device_type: str):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type=device_type, dtype=self.compute_dtype)

    def _dropout_generator(self, mc_dropout: bool,
                           generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
        """The generator the dropout sites draw from, or None where they are
        off (rate 0, or eval mode without ``mc_dropout``)."""
        if not (self.dropout_rate > 0 and (self.training or mc_dropout)):
            return None
        if generator is None:
            raise ValueError(f"dropout_rate {self.dropout_rate} is live here (train mode or "
                             "mc_dropout=True): pass forward(..., generator=) to draw its masks")
        return generator

    def _trunk(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        e1 = self.encoder_layer_1_2(self.encoder_layer_1_1(x))
        e2 = self.encoder_layer_2_2(self.encoder_layer_2_1(self.pool(e1)))
        e3 = self.encoder_layer_3_2(self.encoder_layer_3_1(self.pool(e2)))
        b = self.drop_bottom(self.decoder_layer_4_1(self.decoder_layer_4_2(self.pool(e3))), gen)
        d3 = self.drop3(self.decoder_layer_3_1(
            self.decoder_layer_3_2(torch.cat([self.unpool3(b), e3], dim=1))), gen)
        d2 = self.decoder_layer_2_1(
            self.decoder_layer_2_2(torch.cat([self.unpool2(d3), e2], dim=1)))
        return self.decoder_layer_1_1(
            self.decoder_layer_1_2(torch.cat([self.unpool1(d2), e1], dim=1)))

    def _trunk_fused(self, x: torch.Tensor, gen: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """The trunk on the fused-CBR dataflow (JAX ``_UNetTrunkFused``,
        unet.py:575-612), in NHWC views of the channels_last activations:
        activations materialise only at level boundaries (pool, skip
        concatenation, heads)."""
        d = self.compute_dtype

        def pair(first: CBR, second: CBR, xin):
            y, ab = first.fused(xin, d, None, materialize=False)
            return second.fused(y, d, ab)[0]

        def nchw(f, t):
            return f(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        e1 = pair(self.encoder_layer_1_1, self.encoder_layer_1_2, x.permute(0, 2, 3, 1))
        e2 = pair(self.encoder_layer_2_1, self.encoder_layer_2_2, nchw(self.pool, e1))
        e3 = pair(self.encoder_layer_3_1, self.encoder_layer_3_2, nchw(self.pool, e2))
        b = self.drop_bottom(pair(self.decoder_layer_4_2, self.decoder_layer_4_1,
                                  nchw(self.pool, e3)), gen, nhwc=True)
        d3 = self.drop3(pair(self.decoder_layer_3_2, self.decoder_layer_3_1,
                             torch.cat([nchw(self.unpool3, b), e3], dim=-1)), gen, nhwc=True)
        d2 = pair(self.decoder_layer_2_2, self.decoder_layer_2_1,
                  torch.cat([nchw(self.unpool2, d3), e2], dim=-1))
        d1 = pair(self.decoder_layer_1_2, self.decoder_layer_1_1,
                  torch.cat([nchw(self.unpool1, d2), e1], dim=-1))
        return d1.permute(0, 3, 1, 2)

    def _features(self, x: torch.Tensor, mc_dropout: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gen = self._dropout_generator(mc_dropout, generator)
        return self._trunk_fused(x, gen) if self.fused else self._trunk(x, gen)


class UNetB(_UNetBase):
    """Binary-head U-Net (reference model.py:18-103).

    forward(x (N, C, H, W), mc_dropout=False, generator=None) ->
        non-selective: (N, H, W) float32 logits
        selective:     (output, select, aux), each (N, H, W) float32
    """

    def __init__(self, selective: bool = False, in_ch: int = 3,
                 compute_dtype: str = "float32", fused: bool = False, folded: bool = False,
                 dropout_rate: float = 0.0, bn_stats: str = "float32", quantize: bool = False,
                 train_quant: str = "none", bn_groups: int = 0):
        super().__init__(in_ch, compute_dtype, fused, folded, dropout_rate, bn_stats, quantize,
                         train_quant, bn_groups)
        self.selective = selective
        self.conv1x1 = Head(64, 1)
        if selective:
            self.conv_select = Head(64, 1)
            self.conv_aux = Head(64, 1)

    def forward(self, x: torch.Tensor, mc_dropout: bool = False,
                generator: Optional[torch.Generator] = None):
        with self._autocast(x.device.type):
            return self._heads(self._features(x, mc_dropout, generator))

    def _heads(self, feat: torch.Tensor):
        heads = (self.conv1x1, self.conv_select, self.conv_aux) if self.selective else (
            self.conv1x1,)
        out = [y.squeeze(-1) for y in sel_heads.apply_heads(feat, heads)]
        return tuple(out) if self.selective else out[0]


class UNet(_UNetBase):
    """n_cls-head U-Net (reference model.py:106-191).

    forward(x (N, C, H, W), mc_dropout=False, generator=None) ->
        non-selective: (N, H, W, n_cls) float32 logits
        selective:     (output (N, H, W, n_cls), select (N, H, W, 2),
                        aux (N, H, W, n_cls))
    """

    def __init__(self, n_cls: int = 2, selective: bool = False, in_ch: int = 3,
                 compute_dtype: str = "float32", fused: bool = False, folded: bool = False,
                 dropout_rate: float = 0.0, bn_stats: str = "float32", quantize: bool = False,
                 train_quant: str = "none", bn_groups: int = 0):
        super().__init__(in_ch, compute_dtype, fused, folded, dropout_rate, bn_stats, quantize,
                         train_quant, bn_groups)
        self.selective = selective
        self.conv1x1 = Head(64, n_cls)
        if selective:
            self.conv_select = Head(64, 2)
            self.conv_aux = Head(64, n_cls)

    def forward(self, x: torch.Tensor, mc_dropout: bool = False,
                generator: Optional[torch.Generator] = None):
        with self._autocast(x.device.type):
            return self._heads(self._features(x, mc_dropout, generator))

    def _heads(self, feat: torch.Tensor):
        heads = (self.conv1x1, self.conv_select, self.conv_aux) if self.selective else (
            self.conv1x1,)
        out = sel_heads.apply_heads(feat, heads)
        return tuple(out) if self.selective else out[0]


def build_model(model_arch: str, n_cls: int = 2, selective: bool = False,
                compute_dtype: str = "float32", fused: bool = False,
                folded: bool = False, dropout_rate: float = 0.0,
                in_ch: int = 3, bn_stats: str = "float32", quantize: str = "none",
                quant_calibrate: bool = False, train_quant: str = "none",
                bn_mode: str = "global", bn_groups: int = 1, img_size: int = 256,
                dims: Optional[dict] = None) -> nn.Module:
    """The reference's arch selection (train.py:71-74), in eval mode and
    channels_last memory. ``fused`` selects the fused-CBR trunk (same
    modules and state dict); ``folded`` the BN-folded serving trunk, which
    takes a state dict from ``ops.fold_bn.fold_batchnorm``; ``dropout_rate``
    the rate of the two dropout sites (JAX ``build_model``,
    unet.py:760-864); ``in_ch`` the input channels, 2 for the GH input and 3
    otherwise (``config.input_channels``, reference model.py:24-27; flax
    infers it from the first input). On the fused trunk a first layer of
    2 or 3 channels fails the kernel's Cin gate (``ops.fused_cbr.eligible``)
    and runs the plain dataflow; the 13 layers after it run the kernel.
    ``bn_stats="bfloat16"`` builds ``LowPrecStatsBN`` in the classic trunk;
    the fused trunk has no such path and refuses it (JAX unet.py:818-823).

    ``quantize="int8"`` builds the W8A8 serving trunk (``QuantCBR``, on a
    state dict from ``ops.quant.quantize_folded``; requires ``folded``);
    ``quant_calibrate`` the folded float graph whose CBRs record their
    input's absmax (``calibration_absmax``). ``train_quant="int8"`` (QAT)
    builds ``QATCBR``: the int8 forward in train mode, the float
    parameters. ``bn_mode="per_replica"`` builds ``GroupedBatchNorm`` with
    ``bn_groups`` groups (``train_lib.resolve_bn_groups``). The combinations
    that would run something other than the flags say are refused, as JAX
    refuses them (unet.py:800-848).

    ``"TransUNet"`` builds ``models.transunet.TransUNet`` for ``img_size``
    inputs at the published sizes (or ``dims``), binary heads as UNet_B's;
    the U-Nets' trunk variants are refused for it (``build_transunet``)."""
    if model_arch == "TransUNet":
        from .transunet import build_transunet

        return build_transunet(n_cls, selective, compute_dtype, fused, folded, dropout_rate,
                               in_ch, bn_stats, quantize, quant_calibrate, train_quant, bn_mode,
                               img_size, dims).to(memory_format=torch.channels_last).eval()
    if folded and fused:
        raise ValueError("folded serving graph and fused training trunk are exclusive")
    if quantize not in ("none", "int8"):
        raise ValueError(f"unknown quantize {quantize!r} (expected 'none' or 'int8')")
    if quantize == "int8" or quant_calibrate:
        if not folded:
            raise ValueError("quantize/quant_calibrate require the BN-folded serving graph "
                             "(folded=True, ops/fold_bn.py)")
        if dropout_rate > 0:
            raise ValueError("quantize/quant_calibrate and dropout_rate > 0 are exclusive "
                             "(MC-dropout uncertainty runs the bf16 folded graph)")
    if quantize == "int8" and quant_calibrate:
        raise ValueError("quantize='int8' and quant_calibrate are exclusive "
                         "(calibration runs the float folded graph)")
    if fused and bn_stats != "float32":
        raise ValueError("bn_stats is not implemented by the fused trunk; "
                         "use bn_stats='float32' or fused=False")
    if train_quant not in ("none", "int8"):
        raise ValueError(f"unknown train_quant {train_quant!r} (expected 'none' or 'int8')")
    if train_quant == "int8":
        if folded or quantize == "int8" or quant_calibrate:
            raise ValueError("train_quant='int8' is a TRAINING-trunk variant; it is exclusive "
                             "with the folded/serving graphs (folded/quantize/quant_calibrate)")
        if fused:
            raise ValueError("train_quant='int8' is not implemented by the fused trunk; "
                             "use the default trunk (fused=False)")
    if bn_mode not in ("global", "per_replica"):
        raise ValueError(f"unknown bn_mode {bn_mode!r} (expected 'global' or 'per_replica')")
    if bn_mode == "per_replica":
        if fused:
            raise ValueError("bn_mode='per_replica' is not implemented by the fused trunk; "
                             "use the default trunk (fused=False)")
        if bn_stats != "float32":
            raise ValueError("bn_mode='per_replica' and bn_stats != 'float32' are exclusive "
                             "(GroupedBatchNorm reduces in f32)")
        if bn_groups < 1:
            raise ValueError(f"bn_groups must be >= 1, got {bn_groups}")
    kw = dict(selective=selective, in_ch=in_ch, compute_dtype=compute_dtype, fused=fused,
              folded=folded, dropout_rate=dropout_rate, bn_stats=bn_stats,
              quantize=quantize == "int8", train_quant=train_quant,
              bn_groups=bn_groups if bn_mode == "per_replica" else 0)
    if model_arch == "UNet_B":
        model = UNetB(**kw)
    elif model_arch == "UNet":
        model = UNet(n_cls=n_cls, **kw)
    else:
        raise ValueError(f"unknown model_arch {model_arch!r} "
                         "(expected 'UNet', 'UNet_B' or 'TransUNet')")
    if quant_calibrate:
        for m in model.modules():
            if isinstance(m, FoldedCBR):
                m.calibrating = True
    return model.to(memory_format=torch.channels_last).eval()


def calibration_absmax(model: nn.Module, x: torch.Tensor) -> Dict[str, float]:
    """One forward of a ``quant_calibrate`` model over the normalised batch
    x (N, C, H, W): {CBR name: the absmax of its float32 input}. The pass
    runs under ``inference_mode`` with TF32 off (cuDNN would otherwise run
    the float32 convs in TF32 on the card); the blocks hold nothing after
    it."""
    blocks = {n: m for n, m in model.named_modules()
              if isinstance(m, FoldedCBR) and m.calibrating}
    if not blocks:
        raise ValueError("calibration_absmax needs build_model(..., quant_calibrate=True)")
    try:
        with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True,
                                                                allow_tf32=False):
            model(x)
            values = torch.stack([m.absmax for m in blocks.values()]).tolist()
    finally:
        for m in blocks.values():
            m.absmax = None
    return dict(zip(blocks, values))


def set_process_group(model: nn.Module, pg, sp_group=None) -> nn.Module:
    """Hand the fleet's process group to every BatchNorm, dropout site and
    QAT block of ``model`` (None: one process again), and with ``sp_group``
    (``parallel.mesh.Grid.sp_group``, ``--sp_ways``: this rank holds one row
    block of each image) the halo exchange within it to every 3x3 block."""
    halo = None
    if sp_group is not None and dist.get_world_size(sp_group) > 1:
        halo = functools.partial(exchange_halo, group=sp_group)
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, Dropout)):
            m.pg, m.sp_group = pg, sp_group
        if isinstance(m, QATCBR):
            m.pg = pg
        if isinstance(m, (CBR, QuantCBR)):
            m.halo = halo
    return model


@contextlib.contextmanager
def recomputing(model: nn.Module):
    """The context of a rematerialised forward run again in the backward
    (``train_lib``'s ``--remat``): the BatchNorms' running statistics stay
    as the step's first forward left them, and the fused-CBR kernel's
    launches are also counted in ``ops.fused_cbr.launches_recompute``."""
    from ..ops import fused_cbr

    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.frozen = True
    fused_cbr.recomputing = True
    try:
        yield
    finally:
        fused_cbr.recomputing = False
        for m in bns:
            m.frozen = False


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch's default initialisation, which the JAX package mirrors
    (models/unet.py:49-65, 402-406), drawn from ``generator``: conv and
    transposed-conv weights and biases U(+-1/sqrt(fan_in)), fan_in =
    weight.size(1) * kh * kw (out_ch * 4 for a transposed conv); BN scale 1,
    shift 0, running mean 0 and variance 1. ``generator`` lives on the
    parameters' device. A model with its own ``reset_weights`` (TransUNet)
    draws through it."""
    if hasattr(model, "reset_weights"):
        return model.reset_weights(generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                bound = 1.0 / math.sqrt(m.weight.size(1) * m.weight[0, 0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def load_weights(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> nn.Module:
    """``load_state_dict`` that accepts what the JAX package accepts: BN
    ``num_batches_tracked`` counters may be missing (the JAX export has none;
    they do not enter the eval forward), and the select/aux heads of a
    selective checkpoint are ignored by a non-selective model. A folded
    model (``folded=True``) has no BN, and takes only a folded state dict
    (``ops.fold_bn.fold_batchnorm``): no BN keys."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    unexpected = [k for k in unexpected
                  if not (k.startswith(("conv_select.", "conv_aux."))
                          and not getattr(model, "selective", True))]
    if missing or unexpected:
        hint = ""
        if getattr(model, "quantize", False):
            hint = "; an int8 model takes the state dict of ops.quant.quantize_folded"
        elif getattr(model, "folded", False):
            hint = "; a folded model takes the state dict of ops.fold_bn.fold_batchnorm"
        elif missing and all(".1." in k for k in missing):
            hint = "; a BN-folded state dict loads into build_model(..., folded=True)"
        raise KeyError(f"checkpoint does not fit {type(model).__name__}: "
                       f"missing {missing}, unexpected {unexpected}{hint}")
    return model
