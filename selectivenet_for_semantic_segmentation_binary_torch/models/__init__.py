"""U-Net models of the port (JAX counterpart: ``models/``)."""

from .unet import (CBR, QATCBR, BatchNorm2d, Dropout, FoldedCBR, Head,  # noqa: F401
                   LowPrecStatsBN, QuantCBR, UNet, UNetB, UpConv, build_model,
                   calibration_absmax, dropout, init_weights, load_weights, recomputing)
