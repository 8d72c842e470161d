"""Seeded synthetic patches and a seeded random UNet_B, for runs on the card
that need no data tree and no trained checkpoint (``chip_smoke.py``,
``tools/profile_eval_step.py`` and the serving tests), and the seeded
on-disk patch trees of the JAX package's ``data/dataset.py:153-320``
(``write_synthetic_patch_tree``, and ``write_hard_synthetic_patch_tree``
with its irreducible ambiguous zones) for the tools that read one
(``snet-wsi``, ``snet-calibrate``, ``snet-sweep``)."""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..models import Head, build_model


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
                 model_arch: str = "UNet_B", n_cls: int = 2, in_ch: int = 3) -> nn.Module:
    """The full-width UNet_B (or ``model_arch``, with ``in_ch`` input
    channels: 2 for GH) with He-normal conv weights and randomised BN
    statistics from a seeded ``torch.Generator``: activations keep their
    scale through the 14 CBR blocks, so the heads see real signal."""
    model = build_model(model_arch, n_cls, selective=selective, compute_dtype=compute_dtype,
                        in_ch=in_ch)
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
    transposed conv costs in_pixels * Cin * 4 * Cout (one tap per output).
    The 1x1 heads come last, from their shapes: on a card they run as one
    kernel pair (``ops.sel_heads``), not through their modules' calls."""
    rows: List[Tuple[str, str, int]] = []
    hooks = []
    heads = [(name, m) for name, m in model.named_modules() if isinstance(m, Head)]
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and not isinstance(m, Head):
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
    return rows + [(name, "conv1x1", height * width * m.in_channels * m.out_channels)
                   for name, m in heads]


def write_synthetic_patch_tree(
    data_dir: str,
    n_slides: int = 2,
    patches_per_slide: int = 8,
    patch_mag: int = 200,
    patch_size: int = 64,
    tumor_fraction: float = 0.5,
    seed: int = 0,
    n_folds: int = 5,
) -> None:
    """A reference-layout synthetic dataset with its fold lists, the same
    files for the same arguments as the JAX package's writer.

    Creates ``{data_dir}/{patch_mag}x_{patch_size}/`` with JPEG inputs whose
    tumor regions are reddish tissue on a pale background, PNG labels
    (0/255), and the ``{i}-fold_{non_}tumorable_data.npy`` pair lists of
    every fold, dealt round-robin (``_write_fold_npys``). Pillow is
    imported on use."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    patch_dir = os.path.join(data_dir, f"{patch_mag}x_{patch_size}")
    os.makedirs(patch_dir, exist_ok=True)

    tumorable, non_tumorable = [], []
    for s in range(n_slides):
        for p in range(patches_per_slide):
            x, y = 256 * p, 512 * p
            stem = f"slide{s:02d}_{x}_{y}"
            is_tumor = rng.random() < tumor_fraction

            # pale tissue-like background with stain-colored texture
            img = np.clip(
                220 + 20 * rng.standard_normal((patch_size, patch_size, 3)), 0, 255
            )
            label = np.zeros((patch_size, patch_size), np.uint8)
            if is_tumor:
                h = patch_size // 2
                cy, cx = rng.integers(0, patch_size - h, 2)
                label[cy : cy + h, cx : cx + h] = 255
                img[cy : cy + h, cx : cx + h] = np.clip(
                    np.array([150.0, 60.0, 120.0])
                    + 25 * rng.standard_normal((h, h, 3)),
                    0,
                    255,
                )

            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(patch_dir, f"{stem}_input.jpg"), quality=92
            )
            Image.fromarray(label).save(os.path.join(patch_dir, f"{stem}_label.png"))

            pair = (f"{stem}_input.jpg", f"{stem}_label.png")
            (tumorable if is_tumor else non_tumorable).append(pair)

    _write_fold_npys(data_dir, tumorable, non_tumorable, n_folds)


def _smooth_field(rng, patch_size: int, coarse: int = 8) -> np.ndarray:
    """Low-frequency random field in roughly [-1, 1]: coarse Gaussian noise
    bilinearly upsampled to (patch_size, patch_size) (JAX
    ``data/dataset.py::_smooth_field``)."""
    from PIL import Image

    grid = rng.standard_normal((coarse, coarse)).astype(np.float32)
    img = Image.fromarray(grid).resize((patch_size, patch_size), Image.BILINEAR)
    return np.asarray(img)


def write_hard_synthetic_patch_tree(
    data_dir: str,
    n_slides: int = 4,
    patches_per_slide: int = 100,
    patch_mag: int = 200,
    patch_size: int = 256,
    ambiguous_level: float = 0.17,
    camo_level: float = 0.035,
    seed: int = 0,
    n_folds: int = 5,
) -> None:
    """A reference-layout synthetic dataset with IRREDUCIBLE localized error,
    the same files for the same arguments as the JAX package's writer
    (``data/dataset.py:153-255``): the same zones, hidden fields, defaults
    and rng draws in the same order.

    Each patch is partitioned by smooth random fields into benign tissue
    (label 0), lesion (label 1) and an ambiguous zone of its own appearance
    whose label follows a HIDDEN field with no trace in the pixels (~50%
    error wherever it occurs, ~20% of pixels at the default level), so a
    selective model can learn to reject exactly those pixels.
    ``camo_level`` plants camouflaged ambiguity (~4% of pixels): labels
    from another hidden field under the host zone's appearance, which even
    a perfect selection head accepts. Fold lists are dealt round-robin by
    the reference's 10%-of-pixels tumorable rule (``_write_fold_npys``).
    Pillow is imported on use."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    patch_dir = os.path.join(data_dir, f"{patch_mag}x_{patch_size}")
    os.makedirs(patch_dir, exist_ok=True)

    benign_rgb = np.array([222.0, 192.0, 205.0])
    lesion_rgb = np.array([158.0, 92.0, 148.0])
    ambig_rgb = np.array([190.0, 142.0, 176.0])

    tumorable, non_tumorable = [], []
    for s in range(n_slides):
        for p in range(patches_per_slide):
            x, y = 256 * p, 512 * p
            stem = f"slide{s:02d}_{x}_{y}"

            lesion_zone = _smooth_field(rng, patch_size) > rng.uniform(-0.2, 0.8)
            ambiguous = np.abs(_smooth_field(rng, patch_size)) < ambiguous_level
            hidden = _smooth_field(rng, patch_size) > 0.0  # invisible to the image
            # camouflaged ambiguity: the label flips with no appearance change
            camo = ((~ambiguous)
                    & (np.abs(_smooth_field(rng, patch_size)) < camo_level))
            hidden2 = _smooth_field(rng, patch_size) > 0.0

            label01 = np.where(ambiguous, hidden,
                               np.where(camo, hidden2, lesion_zone))

            img = np.empty((patch_size, patch_size, 3), np.float32)
            for zone, color in (
                (~lesion_zone & ~ambiguous, benign_rgb),
                (lesion_zone & ~ambiguous, lesion_rgb),
                (ambiguous, ambig_rgb),  # appearance independent of `hidden`
            ):
                img[zone] = color + 12.0 * rng.standard_normal((int(zone.sum()), 3))
            img = np.clip(img, 0, 255)

            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(patch_dir, f"{stem}_input.jpg"), quality=92
            )
            Image.fromarray((label01 * 255).astype(np.uint8)).save(
                os.path.join(patch_dir, f"{stem}_label.png")
            )

            pair = (f"{stem}_input.jpg", f"{stem}_label.png")
            is_tumorable = label01.mean() > 0.1  # the reference's 10% rule
            (tumorable if is_tumorable else non_tumorable).append(pair)

    _write_fold_npys(data_dir, tumorable, non_tumorable, n_folds)


def _write_fold_npys(data_dir: str, tumorable, non_tumorable, n_folds: int) -> None:
    """Deal each class's pairs round-robin over the folds (pair j to fold
    j % n_folds + 1)."""
    for class_name, pairs in (("tumorable", tumorable), ("non_tumorable", non_tumorable)):
        for i in range(n_folds):
            fold_pairs = pairs[i::n_folds]
            if not fold_pairs:  # keep npy 2-D even when a fold is empty
                arr = np.empty((0, 2), dtype="<U64")
            else:
                arr = np.array(fold_pairs)
            np.save(os.path.join(data_dir, f"{i + 1}-fold_{class_name}_data.npy"), arr)
