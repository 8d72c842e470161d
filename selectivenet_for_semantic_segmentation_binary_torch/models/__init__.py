"""U-Net models of the port (JAX counterpart: ``models/``)."""

from .unet import CBR, Head, UNet, UNetB, UpConv, build_model, load_weights  # noqa: F401
