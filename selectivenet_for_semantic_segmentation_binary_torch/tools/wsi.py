"""Whole-slide rendering: the jet heatmap that ``snet-predict`` writes.

Counterpart of the JAX package's ``tools/wsi.py::make_heatmap`` (:49,
reference u-net_testing.ipynb cell 7). The stitched test-fold scoring of
that module (``stitch_patches``, ``wsi_inference``,
``save_performance_as_csv``) is ROADMAP A7b.
"""

from __future__ import annotations

import numpy as np


def make_heatmap(output: np.ndarray) -> np.ndarray:
    """Probability map -> jet RGB float32 (matplotlib, imported on use)."""
    from matplotlib import cm

    return cm.jet(np.asarray(output))[..., :3].astype(np.float32)
