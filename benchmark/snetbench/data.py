"""Inputs and weights made from the run's seed, on the device, in a few
large calls.

``patch_pool`` is a frozen copy of the port's synthetic patch generator
(``tools/synthetic.py::InMemoryPatches``): a coarse 8x8 random field a
patch, upsampled and thresholded at 0.3 into lesion blobs (label 1), lesion
and benign colours plus uniform integer noise in [-24, 24], clipped to uint8.
It is drawn with a ``torch.Generator`` on the device, so a seed gives the same
pool on the same kind of card.

``make_weights`` gives the state dict of the selective UNet_B under the
reference's names, by one of two schemes named in a configuration file:
``torch_default`` (what ``train.sh`` starts from: conv weights and biases
U(+-1/sqrt(fan_in)), BatchNorm 1/0, running statistics 0/1) or
``he_normal`` (a network with signal in every layer for serving: conv weights
N(0, 2/fan_in), biases U(+-0.05), BN scale U(0.9, 1.1), shift and running
mean U(+-0.05), running variance U(0.9, 1.1)).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

BENIGN = (222, 192, 205)
LESION = (158, 92, 148)
CHUNK = 256  # patches drawn a call


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for one named stream of the run's seed."""
    words = [int(seed) % (1 << 64), sum(ord(c) << (8 * (i % 7)) for i, c in enumerate(stream))]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, stream: str) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, stream))
    return g


def patch_pool(n: int, size: int, seed: int, device, stream: str = "pool"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """n uint8 RGB patches (n, size, size, 3) and their {0, 1} labels (n, size,
    size), made on ``device`` and returned in host memory."""
    g = generator(device, seed, stream)
    cell = size // 8
    benign = torch.tensor(BENIGN, dtype=torch.int16, device=device)
    lesion = torch.tensor(LESION, dtype=torch.int16, device=device)
    inputs = np.empty((n, size, size, 3), np.uint8)
    labels = np.empty((n, size, size), np.uint8)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        field = torch.randn((m, 8, 8), generator=g, device=device)
        field = field.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
        lab = (field > 0.3).to(torch.uint8)
        img = torch.where(lab[..., None] == 1, lesion, benign)
        img = img + torch.randint(-24, 25, (m, size, size, 3), generator=g, device=device,
                                  dtype=torch.int16)
        inputs[lo:lo + m] = img.clamp_(0, 255).to(torch.uint8).cpu().numpy()
        labels[lo:lo + m] = lab.cpu().numpy()
    return inputs, labels


def make_weights(leaves, init: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's tensors (``reference.leaves()``), float32 on ``device``."""
    if init not in ("torch_default", "he_normal"):
        raise ValueError(f"unknown init {init!r}")
    g = generator(device, seed, "weights")
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    # one uniform draw in [-1, 1) for every tensor, one normal draw for the
    # He-normal conv weights
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    z = torch.randn(total, generator=g, device=device) if init == "he_normal" else None
    out, off = {}, 0
    for name, shape, role, fan in leaves:
        n = math.prod(shape)
        uu = u[off:off + n].view(shape)
        if init == "torch_default":
            t = {"weight": lambda: uu / math.sqrt(fan), "bias": lambda: uu / math.sqrt(fan),
                 "bn_weight": lambda: torch.ones_like(uu), "bn_bias": lambda: torch.zeros_like(uu),
                 "running_mean": lambda: torch.zeros_like(uu),
                 "running_var": lambda: torch.ones_like(uu)}[role]()
        else:
            t = {"weight": lambda: z[off:off + n].view(shape) * math.sqrt(2.0 / fan),
                 "bias": lambda: uu * 0.05, "bn_weight": lambda: 1.0 + 0.1 * uu,
                 "bn_bias": lambda: uu * 0.05, "running_mean": lambda: uu * 0.05,
                 "running_var": lambda: 1.0 + 0.1 * uu}[role]()
        out[name] = t.contiguous()
        off += n
    return out


class PoolDataset:
    """The pool as the dataset ``PatchLoader`` reads in its raw mode:
    ``get_raw(i)`` -> (input (H, W, 3) uint8, label (H, W) uint8)."""

    input_type = "RGB"

    def __init__(self, inputs: np.ndarray, labels: np.ndarray):
        self.inputs, self.labels = inputs, labels
        self.patch_size = inputs.shape[1]

    def __len__(self) -> int:
        return len(self.inputs)

    def get_raw(self, index: int):
        return self.inputs[index], self.labels[index]


def loader_plan(seed: int, epoch: int, step: int, batch: int, n: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The rows and flips of step ``step`` (from 0) of an epoch of a shuffled
    raw feed with random flips: the epoch's order is ``default_rng([seed,
    epoch])``'s permutation of the pool, and sample i's flip bits
    (left-right, up-down) are ``default_rng([seed, epoch, i]).random(2) >
    0.5``. Worked out here again, not read from the program."""
    order = np.arange(n)
    np.random.default_rng([seed, epoch]).shuffle(order)
    rows = order[step * batch:(step + 1) * batch]
    flips = np.stack([np.random.default_rng([seed, epoch, int(i)]).random(2) > 0.5
                      for i in rows])
    return rows, flips


def flipped(images: np.ndarray, labels: np.ndarray, flips: np.ndarray):
    """Each sample flipped left-right (width) and up-down (height) as its
    bits say."""
    x, y = images.copy(), labels.copy()
    for k, (lr, ud) in enumerate(flips):
        if lr:
            x[k], y[k] = x[k][:, ::-1], y[k][:, ::-1]
        if ud:
            x[k], y[k] = x[k][::-1], y[k][::-1]
    return x, y
