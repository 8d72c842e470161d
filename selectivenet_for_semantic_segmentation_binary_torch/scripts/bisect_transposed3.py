"""The K9 feature-flag bisection kernel on the card: each case's CUDA kernel
(``ops/transposed_bisect.py``, ``kernels/transposed_bisect.cu``) against
its plain version.

Counterpart of the JAX package's ``scripts/bisect_transposed3.py``
(``__main__`` :144-152)::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed3 [case ...]

Each of the 14 ``CASES`` runs on ones and on a seeded bf16 input (and
weights) at the script's size, prints ``name: OK (sum of y)`` with its
device times (each run with a cold L2), and raises at the first disagreement: y within one bf16 ulp
(``bisect_transposed.hold``), and where the case has stats, the stats within
1e-5 of the largest per-channel sum of |y| (y may round to a neighbouring
bf16 value at a few elements, and the stats sum y with cancellation); zero
where it has none.
"""

from __future__ import annotations

import sys

from ..ops import transposed_bisect as tb
from .bisect_transposed import INPUTS, make_input, run_case, window_bytes
from .timing import card, require_cuda


def hold_stats(name: str, got, want) -> None:
    """K9's stats: within 1e-5 of the largest per-channel sum of |y| where
    the case has stats, zero where it has none; raises past that."""
    (_, s), (y, sw) = got, want
    scale = float(y.float().abs().sum((0, 2, 3)).max()) if bool(sw.any()) else 0.0
    err = float((s - sw).abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{name}: the kernel's stats disagree with the plain version's: "
                             f"max |diff| {err:.4g}")


def taps(flags) -> tuple:
    """The taps (dys, dxs) of a case: it reads src[h+dy, :, w+dx]
    (k9_reference)."""
    return ((0, 1, 2) if flags["merge_dot"] else (1,), (0, 1, 2) if flags["shift"] else (0,))


def run(names=None, device=None, n=tb.N, h=tb.H, w=tb.W, c=tb.C, timed=False) -> list:
    device = device or require_cuda("bisect_transposed3")
    rows, w_blk = (tb.ROWS, tb.WBLK) if (h % tb.ROWS, w % tb.WBLK) == (0, 0) else (h, w)
    results = []
    for name in names or list(tb.K9_CASES):
        flags = tb.K9_CASES[name]
        for which in INPUTS:
            xp = make_input(which, (h + 2, c, w + 2, n), device, 5)
            wm = make_input(which, (3, c, 3 * c), device, 6)
            def kernel():
                return tb.bisect_transposed3(xp, wm, **flags, rows=rows, w_blk=w_blk)

            def plain():
                return tb.k9_reference(xp, wm, **flags)

            hold_stats(f"{name}/{which}", kernel(), plain())
            # the taps' window of xp (less the ring zero_ring zeroes), the
            # slice of w[0] the dot reads, y and the stats written
            dys, dxs = taps(flags)
            stats_bytes = 4 * (8 * 128 if flags["stats"] == "pad" else 2 * c)
            nbytes = (window_bytes(xp, dys, dxs, h, w, skip_zeroed=flags["zero_ring"])
                      + 2 * c * len(dys) * c + 2 * h * c * w * n
                      + (stats_bytes if flags["stats"] else 0))
            flops = 2 * len(dys) * len(dxs) * c * h * c * w * n
            results.append(run_case(f"{name}/{which}", lambda: kernel()[0], lambda: plain()[0],
                                    False, nbytes, flops, timed))
    return results


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda("bisect_transposed3")
    print(card())
    return run(argv or None, device, timed=True)


if __name__ == "__main__":
    main()
