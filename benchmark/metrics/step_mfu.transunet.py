"""TransUNet's train-step model FLOPs (forward plus backward, 3x the
forward's convs, linears and attention products, nothing for recompute;
``snetbench/counts_transunet.py``) over the window, as a share of the bf16
peak of the cell's cards."""

from snetbench import counts, counts_transunet


def read(r):
    if not r.steps or not r.window_s:
        return None
    flops = r.steps * counts_transunet.train_step_flops(r.batch)
    return 100.0 * flops / (r.window_s * counts.PEAK_BF16_FLOPS * r.chips)
