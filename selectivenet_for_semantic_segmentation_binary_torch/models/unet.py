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
buffers; the heads are cast back to float32.

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
"""

from __future__ import annotations

import contextlib
import functools
import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..ops.fused_cbr import (bn_affine, eligible, fused_conv_stats,
                             fused_conv_stats_reference, moments_from_stats)
from ..ops.int8_conv import Int8STEConv, int8_conv

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                  True, 0.0, self.eps)
        var = (invstd.detach().double() ** -2 - self.eps).clamp(min=0.0).float()
        self.update_running(mean.detach(), var)
        return y


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
      momentum 0.1 in torch's convention (flax's 0.9), eps 1e-5.

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
        n = x.numel() // x.shape[1]
        with torch.autocast(device_type=x.device.type, enabled=False):
            xs = x.to(sd)
            bmean = (xs.sum(dims, dtype=torch.float32) / n).to(sd)
            diff = xs - bmean[None, :, None, None]
            bvar = ((diff * diff).sum(dims, dtype=torch.float32) / n).to(sd)
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
    it is the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                nhwc: bool = False) -> torch.Tensor:
        if generator is None:
            return x
        shape = x.shape if nhwc else x.permute(0, 2, 3, 1).shape
        mask = torch.rand(shape, generator=generator, device=x.device) < 1.0 - self.rate
        return dropout(x, mask if nhwc else mask.permute(0, 3, 1, 2), self.rate)


class CBR(nn.Sequential):
    """Conv3x3 -> BatchNorm -> ReLU (reference model.py:9-15). BN constants
    are torch's defaults, which the JAX package matches (eps 1e-5).
    ``bn_stats="bfloat16"`` swaps in ``LowPrecStatsBN`` (the same state
    dict, bf16 batch statistics; JAX ``CBR``, unet.py:365-372)."""

    def __init__(self, in_ch: int, out_ch: int, bn_stats: str = "float32"):
        bn = (BatchNorm2d(out_ch, eps=1e-5) if bn_stats == "float32"
              else LowPrecStatsBN(out_ch, eps=1e-5, stats_dtype=_DTYPES[bn_stats]))
        super().__init__(
            nn.Conv2d(in_ch, out_ch, kernel_size=3, stride=1, padding=1, bias=True),
            bn,
            nn.ReLU(inplace=True),
        )

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
    every other path."""

    def __init__(self, in_ch: int, out_ch: int, compute_dtype: torch.dtype,
                 bn_stats: str = "float32"):
        super().__init__(in_ch, out_ch, bn_stats)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        conv = self[0]
        y = Int8STEConv.apply(x, conv.weight)
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
    it."""

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
    compute dtype. Its buffers sit under FoldedCBR's index ``.0``."""

    def __init__(self, in_ch: int, out_ch: int, compute_dtype: torch.dtype):
        super().__init__()
        self.add_module("0", QuantConv(in_ch, out_ch))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
                 quantize: bool = False, train_quant: str = "none"):
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
            cbr = functools.partial(QATCBR, compute_dtype=self.compute_dtype, bn_stats=bn_stats)
        else:
            cbr = functools.partial(CBR, bn_stats=bn_stats)
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

    def _autocast(self, x: torch.Tensor):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type=x.device.type, dtype=self.compute_dtype)

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
                 train_quant: str = "none"):
        super().__init__(in_ch, compute_dtype, fused, folded, dropout_rate, bn_stats, quantize,
                         train_quant)
        self.selective = selective
        self.conv1x1 = Head(64, 1)
        if selective:
            self.conv_select = Head(64, 1)
            self.conv_aux = Head(64, 1)

    def forward(self, x: torch.Tensor, mc_dropout: bool = False,
                generator: Optional[torch.Generator] = None):
        with self._autocast(x):
            feat = self._features(x, mc_dropout, generator)
            out = self.conv1x1(feat)
            if self.selective:
                heads = (out, self.conv_select(feat), self.conv_aux(feat))
        if not self.selective:
            return out.squeeze(1).float()
        return tuple(h.squeeze(1).float() for h in heads)


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
                 train_quant: str = "none"):
        super().__init__(in_ch, compute_dtype, fused, folded, dropout_rate, bn_stats, quantize,
                         train_quant)
        self.selective = selective
        self.conv1x1 = Head(64, n_cls)
        if selective:
            self.conv_select = Head(64, 2)
            self.conv_aux = Head(64, n_cls)

    def forward(self, x: torch.Tensor, mc_dropout: bool = False,
                generator: Optional[torch.Generator] = None):
        with self._autocast(x):
            feat = self._features(x, mc_dropout, generator)
            heads = [self.conv1x1(feat)]
            if self.selective:
                heads += [self.conv_select(feat), self.conv_aux(feat)]
        heads = [h.permute(0, 2, 3, 1).float() for h in heads]
        return tuple(heads) if self.selective else heads[0]


def build_model(model_arch: str, n_cls: int = 2, selective: bool = False,
                compute_dtype: str = "float32", fused: bool = False,
                folded: bool = False, dropout_rate: float = 0.0,
                in_ch: int = 3, bn_stats: str = "float32", quantize: str = "none",
                quant_calibrate: bool = False, train_quant: str = "none") -> Union[UNetB, UNet]:
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
    parameters. The combinations that would run something other than the
    flags say are refused, as JAX refuses them (unet.py:800-835)."""
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
    kw = dict(selective=selective, in_ch=in_ch, compute_dtype=compute_dtype, fused=fused,
              folded=folded, dropout_rate=dropout_rate, bn_stats=bn_stats,
              quantize=quantize == "int8", train_quant=train_quant)
    if model_arch == "UNet_B":
        model = UNetB(**kw)
    elif model_arch == "UNet":
        model = UNet(n_cls=n_cls, **kw)
    else:
        raise ValueError(f"unknown model_arch {model_arch!r} (expected 'UNet' or 'UNet_B')")
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
    parameters' device."""
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
