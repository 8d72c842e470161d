"""U-Net models of the port (JAX counterpart: ``models/``)."""

from .unet import (CBR, BatchNorm2d, Dropout, FoldedCBR, Head, LowPrecStatsBN,  # noqa: F401
                   UNet, UNetB, UpConv, build_model, dropout, init_weights, load_weights,
                   recomputing)
