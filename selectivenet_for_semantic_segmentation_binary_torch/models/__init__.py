"""U-Net models of the port (JAX counterpart: ``models/``)."""

from .unet import (CBR, BatchNorm2d, Dropout, FoldedCBR, Head, UNet, UNetB,  # noqa: F401
                   UpConv, build_model, dropout, init_weights, load_weights)
