"""Patch dataset: (input JPEG, label PNG) pairs on disk.

Counterpart of the JAX package's ``data/dataset.py:29-150``, with the same
on-disk contract (``{data_dir}/{patch_mag}x_{patch_size}/{stem}_input.jpg``
and ``{stem}_label.png``, pairs matched by filename stem) and the same two
reads:

* ``get_raw(i)``: the raw feed's decode, input uint8 RGB and label uint8
  {0, 1}, normalised later on the device; no stain conversion, no
  transform;
* ``__getitem__(i, rng)``: the float feed's, input float32 RGB in [0, 1],
  then the stain conversion of ``input_type`` (``RGB2GH`` gives 2
  channels, ``H_RGB`` 3), then ``transform(data, rng)``; returns ``{"id",
  "input" (H, W, C) float32, "label" (H, W)}``.

``decoder``: ``"pil"``, the default, decodes with PIL; ``"auto"`` with
the native libjpeg/libpng decoder (``data/native_decoder.py``) where it
builds and loads, and with PIL where it does not, as JAX's ``"auto"``
(JAX's default) does; ``"native"`` raises without it. The default is
PIL because the native decoder is not PIL: JPEG inputs may differ by IDCT
rounding (JAX's own test allows 2.5/255), so ``"auto"`` would change what
a model sees by whether the host has libjpeg's and libpng's headers, and
its speed-up is unmeasured on an H100 host (PERF.md §7). A pair the
native decoder cannot decode exactly (another size, CMYK, an interlaced
PNG) is decoded with PIL.
PIL is imported on use, so the package imports where Pillow is missing.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .stain import H_RGB, RGB2GH

INPUT_TYPES = ("RGB", "GH", "H_RGB")


class PatchDataset:
    """Map-style dataset of (input JPEG, label PNG) patch pairs."""

    def __init__(self, data_dir: str, data_list: Sequence, patch_mag: int = 200,
                 patch_size: int = 256, input_type: str = "RGB", transform=None,
                 decoder: str = "pil"):
        if input_type not in INPUT_TYPES:
            raise ValueError(f"unknown input_type {input_type!r} (expected one of "
                             f"{', '.join(INPUT_TYPES)})")
        if decoder not in ("auto", "native", "pil"):
            raise ValueError(f"unknown decoder {decoder!r} (expected auto, native or pil)")
        self.data_dir = data_dir
        self.patch_mag = patch_mag
        self.patch_size = patch_size
        self.input_type = input_type
        self.transform = transform
        self.use_native = False
        if decoder != "pil":
            from . import native_decoder

            self.use_native = native_decoder.available()
            if decoder == "native" and not self.use_native:
                raise RuntimeError("native decoder requested but unavailable: "
                                   f"{native_decoder.build_error()}")
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

    def _paths(self, index: int) -> Tuple[str, str]:
        return (os.path.join(self.patch_dir, self.input_list[index]),
                os.path.join(self.patch_dir, self.label_list[index]))

    def _native(self, fn_name: str, index: int):
        """The native decoder's pair, or None where it is off or punts."""
        if not self.use_native:
            return None
        from . import native_decoder

        try:
            return getattr(native_decoder, fn_name)(*self._paths(index), self.patch_size)
        except RuntimeError:
            return None  # an odd file: PIL below

    def _pil(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(input (H, W, 3) uint8 RGB, label (H, W) uint8 {0, 1}) by PIL;
        ``convert("RGB")`` so grayscale, CMYK and palette files come back
        with 3 channels."""
        from PIL import Image

        inp_path, lab_path = self._paths(index)
        inp = np.asarray(Image.open(inp_path).convert("RGB"), dtype=np.uint8)
        lab = (np.asarray(Image.open(lab_path).convert("L")) / 255.0).astype(np.uint8)
        return inp, lab

    def get_raw(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(input (H, W, 3) uint8 RGB, label (H, W) uint8 in {0, 1})."""
        pair = self._native("decode_patch_pair_u8", index)
        return pair if pair is not None else self._pil(index)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        pair = self._native("decode_patch_pair", index)
        if pair is None:
            u8, lab = self._pil(index)
            inp = u8.astype(np.float32) / 255.0  # JAX: asarray(float32) / 255.0
        else:
            inp, lab = pair
        if self.input_type == "GH":
            inp = RGB2GH(inp)
        elif self.input_type == "H_RGB":
            inp = H_RGB(inp)
        data = {"id": self.input_list[index].split("_input")[0], "input": inp, "label": lab}
        if self.transform:
            data = self.transform(data, rng if rng is not None else np.random.default_rng())
        return data
