"""Raw-uint8 serving ingest: ship bytes, normalise on the device.

Counterpart of the JAX package's ``ops/ingest.py`` (``normalize_raw`` :36,
``device_ingest`` :50, ``to_unit_float`` :64), shared by the ``Predictor``,
``tools/tiled_inference``, ``tools/serve`` and the eval and train steps
(``train_lib.device_preprocess``):

* :func:`device_ingest`: a host array becomes a tensor on the serving
  device, uint8 kept as uint8 so the host-to-device copy is 1 byte a pixel,
  copied from pinned memory as ``data/loader.py`` copies its batches;
* :func:`normalize_raw`: uint8 [0, 255] or float [0, 1] becomes float32
  ``(x - 0.5) / 0.5`` on the device.

``x.float() * (1/255)`` is the JAX expression, so the two packages agree
bit for bit on all 256 byte values (``tests/test_torch_ingest.py``); it
differs from the host's true division ``x / 255`` by at most one ulp.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize_raw(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] pixels -> normalised float32, in the
    JAX op order. Float inputs are taken to be in [0, 1] already (the host
    decode convention, reference data_utils.py:220-221)."""
    if x.dtype == torch.uint8:
        x = x.float() * (1.0 / 255.0)
    else:
        x = x.float()
    return (x - 0.5) / 0.5


def device_ingest(images, device) -> torch.Tensor:
    """Host array (or tensor) -> tensor on ``device`` for the serving forward.

    uint8 stays uint8 (1 byte a pixel, 4x less than float32: the forward's
    :func:`normalize_raw` expands it on the device); anything else lands as
    float32. To a card the copy goes from pinned memory, asynchronously on
    the current stream."""
    device = torch.device(device)
    t = images if torch.is_tensor(images) else torch.from_numpy(
        np.ascontiguousarray(images))
    if t.dtype != torch.uint8:
        t = t.float()
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_unit_float(images) -> np.ndarray:
    """Host uint8 [0, 255] or float -> float32 [0, 1] (numpy), with the
    same ``* (1/255)`` as :func:`normalize_raw`, for the host-side consumers
    of raw images (heatmap overlays)."""
    a = np.asarray(images)
    if a.dtype == np.uint8:
        return a.astype(np.float32) * np.float32(1.0 / 255.0)
    return np.asarray(a, np.float32)
