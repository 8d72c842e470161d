"""U-Net models of the port (JAX counterpart: ``models/``)."""

from .unet import (CBR, BatchNorm2d, FoldedCBR, Head, UNet, UNetB, UpConv,  # noqa: F401
                   build_model, init_weights, load_weights)
