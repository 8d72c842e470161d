"""U-Net models of the port (JAX counterpart: ``models/``)."""

from .unet import (CBR, BatchNorm2d, Head, UNet, UNetB, UpConv, build_model,  # noqa: F401
                   init_weights, load_weights)
