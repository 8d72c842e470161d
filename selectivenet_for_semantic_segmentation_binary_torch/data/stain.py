"""Stain-space colour transforms: the Gray + Hematoxylin (GH) and H_RGB inputs.

The port's own copy of the JAX package's ``data/stain.py:1-76`` (numpy
only, float64 as there; ``tests/test_torch_stain.py`` holds the two bit for
bit). The classic Ruifrok-Johnston colour deconvolution that the reference
takes from skimage (reference utils/data_utils.py:13-41):

* ``separate_stains(rgb, M)``: optical density ``od = log(max(rgb, 1e-6)) /
  log(1e-6)`` projected through the stain matrix ``M`` (unclamped). The
  reference's Hematoxylin rescaling constants h_min=-0.66781543 /
  h_max=1.87798274 (data_utils.py:23) are the extrema of this unclamped
  projection over the RGB cube (``H_MIN``, ``H_MAX``).
* ``combine_stains``: the inverse rendering used by H_RGB.

``RGB2GH`` builds the 2-channel Gray+Hematoxylin input of the GH model
(``input_channels`` 2, reference model.py:24-27); ``H_RGB`` re-renders the
H plane as an RGB image (data_utils.py:29-41). Both run on the host, on
float32 RGB in [0, 1], before any transform (``data/dataset.py``).
"""

from __future__ import annotations

import numpy as np

# Ruifrok-Johnston H&E-DAB stain matrix (rows: Hematoxylin, Eosin, DAB in RGB).
rgb_from_hed = np.array(
    [
        [0.65, 0.70, 0.29],
        [0.07, 0.99, 0.11],
        [0.27, 0.57, 0.78],
    ]
)
hed_from_rgb = np.linalg.inv(rgb_from_hed)

# Extrema of the unclamped H projection over the RGB cube; equal to the
# reference's mined constants (data_utils.py:23-24).
H_MIN = float(np.sum(np.minimum(hed_from_rgb[:, 0], 0.0)))  # -0.66781543
H_MAX = float(np.sum(np.maximum(hed_from_rgb[:, 0], 0.0)))  # +1.87798274

_LOG_ADJUST = np.log(1e-6)


def separate_stains(rgb: np.ndarray, conv_matrix: np.ndarray = hed_from_rgb) -> np.ndarray:
    """(H, W, 3) float RGB in [0, 1] -> (H, W, 3) stain concentrations."""
    rgb = np.maximum(np.asarray(rgb, dtype=np.float64), 1e-6)
    od = np.log(rgb) / _LOG_ADJUST
    return od @ conv_matrix


def combine_stains(stains: np.ndarray, conv_matrix: np.ndarray = rgb_from_hed) -> np.ndarray:
    """(H, W, 3) stain concentrations -> (H, W, 3) float RGB in [0, 1]."""
    log_rgb = (np.asarray(stains, dtype=np.float64) * _LOG_ADJUST) @ conv_matrix
    return np.clip(np.exp(log_rgb), 0.0, 1.0)


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma, the convention cv2.cvtColor(RGB2GRAY) uses
    (reference data_utils.py:21)."""
    return (
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    ).astype(np.float32)


def RGB2GH(rgb_image: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1] -> (H, W, 2) float32 [gray, hematoxylin]
    with H min-max rescaled by the fixed cube extrema (data_utils.py:13-27)."""
    g = _rgb_to_gray(rgb_image)
    h = separate_stains(rgb_image)[..., 0]
    h = (h - H_MIN) / (H_MAX - H_MIN)
    return np.stack([g, h.astype(np.float32)], axis=-1).astype(np.float32)


def H_RGB(rgb_image: np.ndarray) -> np.ndarray:
    """Re-render the Hematoxylin plane back to RGB (data_utils.py:29-41)."""
    h = separate_stains(rgb_image)[..., 0]
    null = np.zeros_like(h)
    return combine_stains(np.stack([h, null, null], axis=-1)).astype(np.float32)
