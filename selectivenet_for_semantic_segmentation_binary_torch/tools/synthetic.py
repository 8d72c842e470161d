"""Seeded synthetic patches and a seeded random UNet_B, for runs on the card
that need no data tree and no trained checkpoint (``chip_smoke.py``,
``tools/profile_eval_step.py`` and the serving tests)."""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..models import build_model


class InMemoryPatches:
    """``n`` uint8 RGB patches of ``size`` x ``size`` with structured uint8
    labels, made from a seeded numpy generator: a coarse random field,
    upsampled and thresholded into lesion blobs, with lesion and benign
    colours plus noise. It has the ``get_raw``/``__len__`` interface that
    ``data.loader.PatchLoader`` reads."""

    def __init__(self, n: int, size: int, seed: int):
        rng = np.random.default_rng(seed)
        cell = size // 8
        field = rng.standard_normal((n, 8, 8)).astype(np.float32)
        field = np.repeat(np.repeat(field, cell, axis=1), cell, axis=2)
        self.labels = (field > 0.3).astype(np.uint8)
        benign = np.array([222, 192, 205], np.int16)
        lesion = np.array([158, 92, 148], np.int16)
        img = np.where(self.labels[..., None] == 1, lesion, benign)
        img = img + rng.integers(-24, 25, img.shape, dtype=np.int16)
        self.inputs = np.clip(img, 0, 255).astype(np.uint8)

    def __len__(self) -> int:
        return len(self.labels)

    def get_raw(self, index: int):
        return self.inputs[index], self.labels[index]


def seeded_model(seed: int, compute_dtype: str, selective: bool = True,
                 model_arch: str = "UNet_B", n_cls: int = 2) -> nn.Module:
    """The full-width UNet_B (or ``model_arch``) with He-normal conv weights
    and randomised BN statistics from a seeded ``torch.Generator``:
    activations keep their scale through the 14 CBR blocks, so the heads see
    real signal."""
    model = build_model(model_arch, n_cls, selective=selective, compute_dtype=compute_dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose2d):
                m.weight.normal_(0.0, math.sqrt(2.0 / m.in_channels), generator=g)
                m.bias.uniform_(-0.05, 0.05, generator=g)
            elif isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=g)
                m.bias.uniform_(-0.05, 0.05, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.9, 1.1, generator=g)
                m.bias.uniform_(-0.05, 0.05, generator=g)
                m.running_mean.uniform_(-0.05, 0.05, generator=g)
                m.running_var.uniform_(0.9, 1.1, generator=g)
    return model


def conv_macs(model: nn.Module, height: int, width: int) -> List[Tuple[str, str, int]]:
    """Multiply-accumulates of every conv layer for one ``height`` x ``width``
    patch: ``(name, kind, macs)`` with kind ``conv3x3``, ``convT2x2`` or
    ``conv1x1``. A conv costs out_pixels * Cin * kh * kw * Cout; a k2s2
    transposed conv costs in_pixels * Cin * 4 * Cout (one tap per output)."""
    rows: List[Tuple[str, str, int]] = []
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            def hook(mod, args, out, name=name):
                kh, kw = mod.kernel_size
                if isinstance(mod, nn.ConvTranspose2d):
                    pix = args[0].shape[-2] * args[0].shape[-1]
                    kind = f"convT{kh}x{kw}"
                else:
                    pix = out.shape[-2] * out.shape[-1]
                    kind = f"conv{kh}x{kw}"
                rows.append((name, kind, pix * mod.in_channels * kh * kw * mod.out_channels))
            hooks.append(m.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            model(torch.zeros((1, 3, height, width), device=next(model.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    return rows
