"""U-Net models of the port (JAX counterpart: ``models/``) and TransUNet
(``transunet.py``, which the JAX package does not have)."""

from .unet import (CBR, QATCBR, BatchNorm2d, Dropout, FoldedCBR,  # noqa: F401
                   GroupedBatchNorm, Head, LowPrecStatsBN, QuantCBR, UNet, UNetB, UpConv,
                   build_model, calibration_absmax, dropout, grouped_batch_norm_reference,
                   init_weights, load_weights, recomputing, set_process_group)
from .transunet import TransUNet  # noqa: F401
