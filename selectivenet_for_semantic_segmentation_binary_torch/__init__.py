"""PyTorch port of the SelectiveNet U-Net framework, for NVIDIA Hopper.

The JAX package ``selectivenet_for_semantic_segmentation_binary_tpu`` is the
reference; each module here names its counterpart there. This package
imports ``torch`` and never ``jax``. Its kernels are hand-written CUDA in
``kernels/``, built with ``nvcc`` at first use.

Layout (mirrors the JAX package):
  kernels/   CUDA sources and their build (nvcc -> ctypes)
  ops/       the kernels' wrappers beside their plain versions; losses;
             confusion counts; uint8 serving ingest; BatchNorm folding
  models/    U-Net / U-Net_B in eval and train mode (classic or fused-CBR
             trunk, or the BN-folded serving trunk), reference state-dict
             names
  data/      fold lists, raw patch dataset, pinned-memory device feed
  utils/     checkpoints (.pth written; .pth and JAX .ckpt read), numpy
             Evaluator, TensorBoard event writer and reader
  tools/     tiled whole-slide inference, the predict CLI, the HTTP server,
             whole-slide scoring, calibration, fold lists, the sweep
             harness, checkpoint inspection, the torch.export artifact,
             synthetic inputs, the step profilers
  train_lib  the train and valid steps and the epoch loop; optim: optimizers
             and schedulers; eval_lib: the evaluation loop; predictor: the
             serving Predictor; bench: the benchmark; cli: the sub-commands
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
    if name == "train":
        from .train_lib import train

        return train
    if name == "Predictor":
        from .predictor import Predictor

        return Predictor
    if name in ("EvalConfig", "TrainConfig"):
        from . import config

        return getattr(config, name)
    raise AttributeError(name)
