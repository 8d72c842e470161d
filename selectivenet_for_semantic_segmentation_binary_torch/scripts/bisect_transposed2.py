"""The K8 bisection kernels on the card: each body's CUDA kernel
(``ops/transposed_bisect.py``, ``kernels/transposed_bisect.cu``) against
its plain version.

Counterpart of the JAX package's ``scripts/bisect_transposed2.py`` (``run``
:37-42, ``__main__`` :75-77)::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed2 [a ... e]

Each body runs on ones and on a seeded bf16 input (and weights) at the
script's size, prints ``name: OK (sum)`` with its device times and those
of the one PyTorch call that computes the same function (a: one reduction;
c, d, e: one batched GEMM; none for b, whose every add rounds to bf16), and
raises at the first disagreement (``bisect_transposed.hold``: body b within
one ulp like the others).
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


def run(names=None, device=None, n=tb.N, h=tb.H, w=tb.W, c=tb.C, timed=False) -> list:
    device = device or require_cuda("bisect_transposed2")
    results = []
    for name in names or tb.K8_BODIES:
        dys, dxs = TAPS[name]
        k = len(dys) * c if name in ("c", "d", "e") else 0
        for which in INPUTS:
            xp = make_input(which, (h + 2, c, w + 2, n), device, 3)
            wm = make_input(which, (c, 3 * c), device, 4)
            nbytes = window_bytes(xp, dys, dxs, h, w) + 2 * c * k + 2 * h * c * w * n
            library = None
            if k:
                library = (lambda: one_call_dot(xp, wm, dys, dxs[0], h, w))
            elif name == "a":
                library = (lambda: one_call_sum(xp, dys, dxs, h, w))
            results.append(run_case(
                f"{name}/{which}", lambda: tb.bisect_transposed2(name, xp, wm),
                lambda: tb.k8_reference(name, xp, wm), False, nbytes, 2 * k * h * c * w * n,
                timed, library))
    return results


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda("bisect_transposed2")
    print(card())
    return run(argv or None, device, timed=True)


if __name__ == "__main__":
    main()
