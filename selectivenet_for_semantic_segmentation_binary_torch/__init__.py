"""PyTorch port of the SelectiveNet U-Net framework, for NVIDIA Hopper.

The JAX package ``selectivenet_for_semantic_segmentation_binary_tpu`` is the
reference; each module here names its counterpart there. This package
imports ``torch`` and never ``jax``. Its kernels are hand-written CUDA in
``kernels/``, built with ``nvcc`` at first use.

Layout (mirrors the JAX package):
  kernels/   CUDA sources and their build (nvcc -> ctypes)
  ops/       the kernels' wrappers beside their plain versions; confusion counts
  models/    U-Net / U-Net_B in inference mode, reference state-dict names
  data/      test-fold lists, raw patch dataset, pinned-memory device feed
  utils/     checkpoint loading (.pth and JAX .ckpt), numpy Evaluator
  eval_lib   the evaluation loop; cli: its command line
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: importing the package loads no torch modules."""
    if name in ("UNet", "UNetB", "build_model"):
        from . import models

        return getattr(models, name)
    if name == "evaluate":
        from .eval_lib import evaluate

        return evaluate
    if name == "EvalConfig":
        from .config import EvalConfig

        return EvalConfig
    raise AttributeError(name)
