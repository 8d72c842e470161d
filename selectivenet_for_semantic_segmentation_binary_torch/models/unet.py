"""U-Net / U-Net_B with optional SelectiveNet heads, inference mode.

Counterpart of the JAX package's ``models/unet.py`` (CBR :281-382, UpConv
:385-418, Head :421-439, trunk :615-669, UNetB :672-713, UNet :716-757,
build_model :760-864), which follows reference model.py:

* ``CBR`` = Conv3x3(pad 1, bias) -> BatchNorm -> ReLU; channel schedule
  64/128/256 encoder, 512 bottleneck, k2s2 transposed-conv upsampling, skip
  concatenation in the order (upsampled, skip);
* ``UNetB``: 1-channel 1x1 head squeezed to (N, H, W); selective mode adds
  the 1-channel ``conv_select`` and ``conv_aux`` heads;
* ``UNet``: n_cls-channel head, selective heads with 2 and n_cls channels,
  returned channels-last (N, H, W, C) as the JAX package returns them.

Module names are the reference's torch names (``encoder_layer_1_1.0`` is the
conv of the first CBR, ``.1`` its BatchNorm; ``unpool3``; ``conv1x1``), so a
reference ``.pth`` loads with ``load_state_dict``. Inputs are NCHW, best in
``torch.channels_last`` memory, which is what ``eval_lib.device_preprocess``
makes from a uint8 NHWC batch without a copy. ``compute_dtype="bfloat16"``
runs the convs under ``torch.autocast`` with float32 parameters and BN
buffers; the heads are cast back to float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Union

import torch
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class CBR(nn.Sequential):
    """Conv3x3 -> BatchNorm -> ReLU (reference model.py:9-15). BN constants
    are torch's defaults, which the JAX package matches (eps 1e-5)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(
            nn.Conv2d(in_ch, out_ch, kernel_size=3, stride=1, padding=1, bias=True),
            nn.BatchNorm2d(out_ch, eps=1e-5),
            nn.ReLU(inplace=True),
        )


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

    def __init__(self, in_ch: int, compute_dtype: str):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r} "
                             f"(expected one of {sorted(_DTYPES)})")
        self.compute_dtype = _DTYPES[compute_dtype]
        self.encoder_layer_1_1 = CBR(in_ch, 64)
        self.encoder_layer_1_2 = CBR(64, 64)
        self.encoder_layer_2_1 = CBR(64, 128)
        self.encoder_layer_2_2 = CBR(128, 128)
        self.encoder_layer_3_1 = CBR(128, 256)
        self.encoder_layer_3_2 = CBR(256, 256)
        self.decoder_layer_4_2 = CBR(256, 512)
        self.decoder_layer_4_1 = CBR(512, 512)
        self.unpool3 = UpConv(512, 256)
        self.decoder_layer_3_2 = CBR(512, 256)
        self.decoder_layer_3_1 = CBR(256, 256)
        self.unpool2 = UpConv(256, 128)
        self.decoder_layer_2_2 = CBR(256, 128)
        self.decoder_layer_2_1 = CBR(128, 128)
        self.unpool1 = UpConv(128, 64)
        self.decoder_layer_1_2 = CBR(128, 64)
        self.decoder_layer_1_1 = CBR(64, 64)
        self.pool = nn.MaxPool2d(2)

    def _autocast(self, x: torch.Tensor):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type=x.device.type, dtype=self.compute_dtype)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.encoder_layer_1_2(self.encoder_layer_1_1(x))
        e2 = self.encoder_layer_2_2(self.encoder_layer_2_1(self.pool(e1)))
        e3 = self.encoder_layer_3_2(self.encoder_layer_3_1(self.pool(e2)))
        b = self.decoder_layer_4_1(self.decoder_layer_4_2(self.pool(e3)))
        d3 = self.decoder_layer_3_1(
            self.decoder_layer_3_2(torch.cat([self.unpool3(b), e3], dim=1)))
        d2 = self.decoder_layer_2_1(
            self.decoder_layer_2_2(torch.cat([self.unpool2(d3), e2], dim=1)))
        return self.decoder_layer_1_1(
            self.decoder_layer_1_2(torch.cat([self.unpool1(d2), e1], dim=1)))


class UNetB(_UNetBase):
    """Binary-head U-Net (reference model.py:18-103).

    forward(x (N, C, H, W)) ->
        non-selective: (N, H, W) float32 logits
        selective:     (output, select, aux), each (N, H, W) float32
    """

    def __init__(self, selective: bool = False, in_ch: int = 3,
                 compute_dtype: str = "float32"):
        super().__init__(in_ch, compute_dtype)
        self.selective = selective
        self.conv1x1 = Head(64, 1)
        if selective:
            self.conv_select = Head(64, 1)
            self.conv_aux = Head(64, 1)

    def forward(self, x: torch.Tensor):
        with self._autocast(x):
            feat = self._trunk(x)
            out = self.conv1x1(feat)
            if self.selective:
                heads = (out, self.conv_select(feat), self.conv_aux(feat))
        if not self.selective:
            return out.squeeze(1).float()
        return tuple(h.squeeze(1).float() for h in heads)


class UNet(_UNetBase):
    """n_cls-head U-Net (reference model.py:106-191).

    forward(x (N, C, H, W)) ->
        non-selective: (N, H, W, n_cls) float32 logits
        selective:     (output (N, H, W, n_cls), select (N, H, W, 2),
                        aux (N, H, W, n_cls))
    """

    def __init__(self, n_cls: int = 2, selective: bool = False, in_ch: int = 3,
                 compute_dtype: str = "float32"):
        super().__init__(in_ch, compute_dtype)
        self.selective = selective
        self.conv1x1 = Head(64, n_cls)
        if selective:
            self.conv_select = Head(64, 2)
            self.conv_aux = Head(64, n_cls)

    def forward(self, x: torch.Tensor):
        with self._autocast(x):
            feat = self._trunk(x)
            heads = [self.conv1x1(feat)]
            if self.selective:
                heads += [self.conv_select(feat), self.conv_aux(feat)]
        heads = [h.permute(0, 2, 3, 1).float() for h in heads]
        return tuple(heads) if self.selective else heads[0]


def build_model(model_arch: str, n_cls: int = 2, selective: bool = False,
                compute_dtype: str = "float32") -> Union[UNetB, UNet]:
    """The reference's arch selection (train.py:71-74), in eval mode and
    channels_last memory."""
    if model_arch == "UNet_B":
        model = UNetB(selective=selective, compute_dtype=compute_dtype)
    elif model_arch == "UNet":
        model = UNet(n_cls=n_cls, selective=selective, compute_dtype=compute_dtype)
    else:
        raise ValueError(f"unknown model_arch {model_arch!r} (expected 'UNet' or 'UNet_B')")
    return model.to(memory_format=torch.channels_last).eval()


def load_weights(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> nn.Module:
    """``load_state_dict`` that accepts what the JAX package accepts: BN
    ``num_batches_tracked`` counters may be missing (the JAX export has none;
    they do not enter the eval forward), and the select/aux heads of a
    selective checkpoint are ignored by a non-selective model."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    unexpected = [k for k in unexpected
                  if not (k.startswith(("conv_select.", "conv_aux."))
                          and not getattr(model, "selective", True))]
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit {type(model).__name__}: "
                       f"missing {missing}, unexpected {unexpected}")
    return model
