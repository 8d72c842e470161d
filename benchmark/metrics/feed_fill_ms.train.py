"""Mean host ms from an epoch's start in the loader to its first batch
handed over (the port's ``loader.fill`` span), over the epochs that start
in the window, from the port's own spans in the reporting process."""

from snetbench import program


def read(r):
    return program.mean_host_ms(program.spans(), "loader.fill")
