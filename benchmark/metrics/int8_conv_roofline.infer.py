"""K10's share of its roofline: the frozen bound of the 14 int8 conv layers
a batch (per layer the larger of bytes at 3.35 TB/s and operations at 1,979
TOP/s), over the device time a batch in the kernels whose names match."""

from snetbench import counts

PATTERNS = ("int8_conv",)


def read(r):
    us = counts.matching_us(r.kernels, PATTERNS)
    if not r.batches or not us:
        return None
    return 100.0 * counts.int8_conv_bound_ms(r.batch) * r.batches / (us / 1e3)
