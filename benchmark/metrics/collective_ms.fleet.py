"""Device ms a step in NCCL kernels on rank 0's card, from the device
trace."""

from snetbench import counts

PATTERNS = ("nccl",)


def read(r):
    us = counts.matching_us(r.kernels, PATTERNS)
    if not r.steps or not us:
        return None
    return us / 1e3 / r.steps
