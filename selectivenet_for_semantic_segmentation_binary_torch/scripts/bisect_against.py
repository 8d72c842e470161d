"""K7's and K8's kernels of this checkout against another build of
``kernels/transposed_bisect.cu``, on the card::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_against OTHER.cu

OTHER.cu is another commit's source, for example unpacked with ``git
archive <commit> selectivenet_for_semantic_segmentation_binary_torch/kernels
| tar -x -C DIR``. It is compiled with this checkout's nvcc flags into
``kernels/_build/`` and called through the same C interface
(``bisect_k7_launch``, ``bisect_k8_launch``). For every K7 variant and K8
body on the scripts' seeded input at their size, both kernels are held to
the plain version (``bisect_transposed.hold``), and the script prints the
device times of the other kernel and of this one, timed in turns (other,
this, this, other), of the one PyTorch call where there is one, and the
bound; every run with a cold L2.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from .. import kernels
from ..ops import transposed_bisect as tb
from . import bisect_transposed as k7
from . import bisect_transposed2 as k8
from .timing import bound_ms, card, median_ms_device, require_cuda


def build_other(src: str) -> ctypes.CDLL:
    """OTHER.cu compiled as kernels.build compiles this checkout's sources."""
    lib = kernels.build_other(src, "transposed_bisect")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("bisect_k7_launch", "bisect_k8_launch"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr]
    return lib


def run(src: str) -> list:
    """Every K7 variant and K8 body on the scripts' seeded input, the other
    build against this checkout's kernel."""
    other = build_other(src)
    device = torch.device("cuda", 0)
    cases = [("K7", name, tb.K7_VARIANTS.index(name) + 1, k7.case(name, "seeded", device))
             for name in tb.K7_VARIANTS]
    cases += [("K8", name, tb.K8_BODIES.index(name), k8.case(name, "seeded", device))
              for name in tb.K8_BODIES]
    results = []
    for kernel, name, index, cs in cases:
        xp, wm = cs["xp"], cs["wm"]
        v5 = (kernel, name) == ("K7", "v5")

        def other_kernel(kernel=kernel, name=name, index=index, xp=xp, wm=wm, v5=v5):
            y = tb._out(xp, 8 if v5 else 2)
            launch = other.bisect_k7_launch if kernel == "K7" else other.bisect_k8_launch
            rc = launch(index, xp.data_ptr(), 0 if wm is None else wm.data_ptr(), *xp.shape,
                        y.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{kernel} {name}: the other build's launch failed ({rc})")
            return y

        def this_kernel(kernel=kernel, name=name, xp=xp, wm=wm):
            if kernel == "K7":
                return tb.bisect_transposed(name, xp, wm)
            return tb.bisect_transposed2(name, xp, wm)

        want = (tb.k7_reference(name, xp, wm) if kernel == "K7"
                else tb.k8_reference(name, xp, wm))
        k7.hold(f"{kernel} {name} (other build)", other_kernel(), want, cs["exact"])
        k7.hold(f"{kernel} {name}", this_kernel(), want, cs["exact"])
        o1 = median_ms_device(other_kernel, flush_l2=True)
        t1 = median_ms_device(this_kernel, flush_l2=True)
        t2 = median_ms_device(this_kernel, flush_l2=True)
        o2 = median_ms_device(other_kernel, flush_l2=True)
        library = cs["library"]
        out = {"name": f"{kernel} {name}", "other_ms": (o1 + o2) / 2, "ms": (t1 + t2) / 2,
               "library_ms": (median_ms_device(library, flush_l2=True) if library is not None
                              else None), **bound_ms(cs["nbytes"], cs["flops"])}
        one = (f", one PyTorch call {out['library_ms'] * 1e3:.2f} us"
               if library is not None else ", no one call")
        print(f"{out['name']}: other build {out['other_ms'] * 1e3:.2f} us, this checkout "
              f"{out['ms'] * 1e3:.2f} us ({out['other_ms'] / out['ms']:.2f}x){one}, bound "
              f"{out['bound_ms'] * 1e3:.2f} us ({out['bound_by']})", flush=True)
        results.append(out)
    return results


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda("bisect_against")
    if len(argv) != 1:
        raise SystemExit("usage: python -m ...scripts.bisect_against OTHER_transposed_bisect.cu")
    print(card())
    return run(argv[0])


if __name__ == "__main__":
    main()
