"""The W8A8 forward's least time at the configuration's own peaks (the 14
int8 convs at 1,979 TOP/s, the bf16 transposed convs and heads at 989
TFLOP/s), times the batches in the window, over the window."""

from snetbench import counts


def read(r):
    if not r.batches or not r.window_s:
        return None
    return 100.0 * counts.int8_forward_least_ms(r.batch) * r.batches / (r.window_s * 1e3)
