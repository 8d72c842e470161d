"""The train step's model FLOPs (forward plus backward, 3x the forward's
3x3 convs, transposed convs and heads, nothing for recompute) over the
window, as a share of the bf16 peak of the cell's cards."""

from snetbench import counts


def read(r):
    if not r.steps or not r.window_s:
        return None
    flops = r.steps * counts.train_step_flops(r.batch)
    return 100.0 * flops / (r.window_s * counts.PEAK_BF16_FLOPS * r.chips)
