"""Mean device ms a train step spends in its backward (the port's
``step.backward`` span, between its CUDA events), from the port's own
spans."""

from snetbench import program


def read(r):
    return program.mean_device_ms(program.spans(), "step.backward")
