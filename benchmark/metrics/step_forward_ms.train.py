"""Mean device ms a train step spends in its forward (preprocessing,
forward and loss: the port's ``step.forward`` span, between its CUDA
events), from the port's own spans."""

from snetbench import program


def read(r):
    return program.mean_device_ms(program.spans(), "step.forward")
