"""Mean host ms the loader's decode thread takes to assemble one batch
(the port's ``loader.assemble`` span), from the port's own spans."""

from snetbench import program


def read(r):
    return program.mean_host_ms(program.spans(), "loader.assemble")
