"""Patch dataset: (input JPEG, label PNG) pairs on disk, decoded raw.

Counterpart of the JAX package's ``data/dataset.py:29-103`` for the
evaluation path: the on-disk contract is the same
(``{data_dir}/{patch_mag}x_{patch_size}/{stem}_input.jpg`` and
``{stem}_label.png``), and ``get_raw`` returns the input as uint8 RGB and the
label as uint8 {0, 1}, for normalisation on the device. Only the RGB input
type is covered (stain conversion is ROADMAP A5). PIL is imported inside
``get_raw``, so the package imports where Pillow is missing.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np


class PatchDataset:
    """Map-style dataset of (input JPEG, label PNG) patch pairs."""

    def __init__(self, data_dir: str, data_list: Sequence, patch_mag: int = 200,
                 patch_size: int = 256, input_type: str = "RGB"):
        if input_type != "RGB":
            raise NotImplementedError(
                f"input_type {input_type!r}: the port decodes RGB only "
                "(stain inputs are ROADMAP A5)")
        self.data_dir = data_dir
        self.patch_mag = patch_mag
        self.patch_size = patch_size
        self.input_list, self.label_list = [], []
        for inp, lab in data_list:
            if inp.split("_input")[0] != lab.split("_label")[0]:
                raise ValueError(f"input/label filename stems differ: {inp} vs {lab}")
            self.input_list.append(inp)
            self.label_list.append(lab)

    def __len__(self) -> int:
        return len(self.input_list)

    @property
    def patch_dir(self) -> str:
        return os.path.join(self.data_dir, f"{self.patch_mag}x_{self.patch_size}")

    def get_raw(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(input (H, W, 3) uint8 RGB, label (H, W) uint8 in {0, 1})."""
        from PIL import Image

        inp_path = os.path.join(self.patch_dir, self.input_list[index])
        lab_path = os.path.join(self.patch_dir, self.label_list[index])
        inp = np.asarray(Image.open(inp_path).convert("RGB"), dtype=np.uint8)
        lab = (np.asarray(Image.open(lab_path).convert("L")) / 255.0).astype(np.uint8)
        return inp, lab
