"""Mean device ms of TransUNet's ViT blocks and final LayerNorm a forward
(the port's ``transunet.transformer`` span, between its CUDA events), from
the port's own spans."""

from snetbench import program


def read(r):
    return program.mean_device_ms(program.spans(), "transunet.transformer")
