"""The K8 bisection kernels on the card: each body's CUDA kernel
(``ops/transposed_bisect.py``, ``kernels/transposed_bisect.cu``) against
its plain version.

Counterpart of the JAX package's ``scripts/bisect_transposed2.py`` (``run``
:37-42, ``__main__`` :75-77)::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed2 [a ... e]

Each body runs on ones and on a seeded bf16 input (and weights) at the
script's size, prints ``name: OK (sum)`` with its device times and those
of the one PyTorch call that computes the same function (a: one reduction;
c, d, e: one batched GEMM; none for b, whose every add rounds to bf16), all
with a cold L2, and raises at the first disagreement
(``bisect_transposed.hold``: the sums a and b equal to the plain version,
the dots within one ulp).
"""

from __future__ import annotations

import sys

from ..ops import transposed_bisect as tb
from .bisect_transposed import (INPUTS, make_input, one_call_dot, one_call_sum, run_case,
                                window_bytes)
from .timing import card, require_cuda

# each body's taps (dys, dxs): it reads xp[h+dy, :, w+dx] (k8_reference)
TAPS = {"a": ((0, 1, 2), (1,)), "b": ((0, 1, 2), (1,)), "c": ((0, 1, 2), (1,)),
        "d": ((1,), (1,)), "e": ((0, 1, 2), (1,))}
DOTS = ("c", "d", "e")


def case(name: str, which: str, device, n=tb.N, h=tb.H, w=tb.W, c=tb.C) -> dict:
    """Body ``name`` on input ``which``, as ``bisect_transposed.case``."""
    dys, dxs = TAPS[name]
    k = len(dys) * c if name in DOTS else 0
    xp = make_input(which, (h + 2, c, w + 2, n), device, 3)
    wm = make_input(which, (c, 3 * c), device, 4)
    library = None
    if k:
        library = (lambda: one_call_dot(xp, wm, dys, dxs[0], h, w))
    elif name == "a":
        library = (lambda: one_call_sum(xp, dys, dxs, h, w))
    return {"xp": xp, "wm": wm, "library": library, "exact": not k, "library_exact": False,
            "flops": 2 * k * h * c * w * n,
            "nbytes": window_bytes(xp, dys, dxs, h, w) + 2 * c * k + 2 * h * c * w * n}


def run(names=None, device=None, n=tb.N, h=tb.H, w=tb.W, c=tb.C, timed=False) -> list:
    device = device or require_cuda("bisect_transposed2")
    results = []
    for name in names or tb.K8_BODIES:
        for which in INPUTS:
            cs = case(name, which, device, n, h, w, c)
            xp, wm = cs["xp"], cs["wm"]
            results.append(run_case(
                f"{name}/{which}", lambda: tb.bisect_transposed2(name, xp, wm),
                lambda: tb.k8_reference(name, xp, wm), cs["exact"], cs["nbytes"], cs["flops"],
                timed, cs["library"], path=tb.kernel_path(xp, wm if name in DOTS else None)))
    return results


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda("bisect_transposed2")
    print(card())
    return run(argv or None, device, timed=True)


if __name__ == "__main__":
    main()
