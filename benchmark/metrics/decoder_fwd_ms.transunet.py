"""Mean device ms of TransUNet's decoder a forward, from the tokens'
reshape to the heads' input (the port's ``transunet.decoder`` span, between
its CUDA events), from the port's own spans."""

from snetbench import program


def read(r):
    return program.mean_device_ms(program.spans(), "transunet.decoder")
