"""K7's, K8's and K9's kernels of this checkout against another build of
``kernels/transposed_bisect.cu``, on the card::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_against OTHER.cu [K7] [K8] [K9]

OTHER.cu is another commit's source, for example unpacked with ``git
archive <commit> selectivenet_for_semantic_segmentation_binary_torch/kernels
| tar -x -C DIR``. It is compiled with this checkout's nvcc flags into
``kernels/_build/`` and called through the same C interface
(``bisect_k7_launch``, ``bisect_k8_launch``, ``bisect_k9_launch``). For
every K7 variant, K8 body and K9 case (default all three kernels) on the
scripts' seeded input at their size (K9 on ones too: its script's 28
runs), both kernels are held to the plain version
(``bisect_transposed.hold``; K9's stats to a float64 sum of each build's
own y, ``bisect_transposed3.hold_stats``), and the script prints the device
times of the other kernel and of this one, timed in turns (other, this,
this, other), of the one PyTorch call where there is one, and the bound;
every run with a cold L2.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from .. import kernels
from ..ops import transposed_bisect as tb
from . import bisect_transposed as k7
from . import bisect_transposed2 as k8
from . import bisect_transposed3 as k9
from .timing import bound_ms, card, median_ms_device, require_cuda


def build_other(src: str) -> ctypes.CDLL:
    """OTHER.cu compiled as kernels.build compiles this checkout's sources."""
    lib = kernels.build_other(src, "transposed_bisect")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("bisect_k7_launch", "bisect_k8_launch"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr]
    lib.bisect_k9_partials.restype = ctypes.c_int64
    lib.bisect_k9_partials.argtypes = [i32] * 4
    lib.bisect_k9_launch.restype = i32
    # builds from the wgmma K9 on (they export bisect_vector_path) write the
    # whole stats output, whose size they take; earlier ones the (c,) sums
    whole = getattr(lib, "bisect_vector_path", None) is not None
    lib.bisect_k9_launch.argtypes = ([i32] * 6 + [ptr, ptr, i32, i32, i32, i32] + [ptr] * 3
                                     + ([i32] if whole else []) + [ptr])
    lib.k9_stats_whole = whole
    return lib


def other_k9(other: ctypes.CDLL, cs: dict):
    """The other build's K9 on the case's input: (y, stats) as the wrapper
    returns them, through either generation of its interface."""
    xp, wm, flags = cs["xp"], cs["wm"], cs["flags"]
    c = xp.shape[1]
    y = tb._out(xp, 2)
    partials = torch.empty((c, other.bisect_k9_partials(*xp.shape)) if flags["stats"] else (1,),
                           dtype=torch.float32, device=xp.device)
    if other.k9_stats_whole:
        out = torch.empty((8, 128) if flags["stats"] == "pad" else (2, c), dtype=torch.float32,
                          device=xp.device)
        tail = (out.data_ptr(), out.numel())
    else:
        out = torch.empty((c,), dtype=torch.float32, device=xp.device)
        tail = (out.data_ptr(),)
    rc = other.bisect_k9_launch(*(int(bool(flags[k])) for k in tb.K9_FLAGS), xp.data_ptr(),
                                wm.data_ptr(), *xp.shape, y.data_ptr(), partials.data_ptr(),
                                *tail, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K9: the other build's launch failed ({rc})")
    return y, out if other.k9_stats_whole else tb._stats_out(out, flags["stats"], c)


def run(src: str, which=("K7", "K8", "K9")) -> list:
    """Every K7 variant, K8 body and K9 case of the kernels ``which`` on the
    scripts' seeded input (K9's on both of its inputs), the other build against
    this checkout's kernel."""
    other = build_other(src)
    device = torch.device("cuda", 0)
    cases = []
    if "K7" in which:
        cases += [("K7", name, tb.K7_VARIANTS.index(name) + 1, k7.case(name, "seeded", device))
                  for name in tb.K7_VARIANTS]
    if "K8" in which:
        cases += [("K8", name, tb.K8_BODIES.index(name), k8.case(name, "seeded", device))
                  for name in tb.K8_BODIES]
    if "K9" in which:
        # both of the script's inputs: the 28 runs its own timing sums
        cases += [("K9", f"{name}/{inp}", 0, {**k9.case(name, inp, device), "exact": False})
                  for name in tb.K9_CASES for inp in k7.INPUTS]
    results = []
    for kernel, name, index, cs in cases:
        xp, wm = cs["xp"], cs["wm"]
        v5 = (kernel, name) == ("K7", "v5")

        def other_kernel(kernel=kernel, name=name, index=index, xp=xp, wm=wm, v5=v5, cs=cs):
            if kernel == "K9":
                return other_k9(other, cs)[0]
            y = tb._out(xp, 8 if v5 else 2)
            launch = other.bisect_k7_launch if kernel == "K7" else other.bisect_k8_launch
            rc = launch(index, xp.data_ptr(), 0 if wm is None else wm.data_ptr(), *xp.shape,
                        y.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{kernel} {name}: the other build's launch failed ({rc})")
            return y

        def this_kernel(kernel=kernel, name=name, xp=xp, wm=wm, cs=cs):
            if kernel == "K7":
                return tb.bisect_transposed(name, xp, wm)
            if kernel == "K8":
                return tb.bisect_transposed2(name, xp, wm)
            return tb.bisect_transposed3(xp, wm, **cs["flags"])[0]

        if kernel == "K7":
            want = tb.k7_reference(name, xp, wm)
        elif kernel == "K8":
            want = tb.k8_reference(name, xp, wm)
        else:
            want = tb.k9_reference(xp, wm, **cs["flags"])[0]
            k9.hold_stats(f"K9 {name} (other build)", other_k9(other, cs), cs["flags"])
            k9.hold_stats(f"K9 {name}", tb.bisect_transposed3(xp, wm, **cs["flags"]),
                          cs["flags"])
        k7.hold(f"{kernel} {name} (other build)", other_kernel(), want, cs["exact"])
        k7.hold(f"{kernel} {name}", this_kernel(), want, cs["exact"])
        o1 = median_ms_device(other_kernel, flush_l2=True)
        t1 = median_ms_device(this_kernel, flush_l2=True)
        t2 = median_ms_device(this_kernel, flush_l2=True)
        o2 = median_ms_device(other_kernel, flush_l2=True)
        library = cs["library"]
        out = {"name": f"{kernel} {name}", "kernel": kernel, "other_ms": (o1 + o2) / 2,
               "ms": (t1 + t2) / 2,
               "library_ms": (median_ms_device(library, flush_l2=True) if library is not None
                              else None), **bound_ms(cs["nbytes"], cs["flops"])}
        one = (f", one PyTorch call {out['library_ms'] * 1e3:.2f} us"
               if library is not None else ", no one call")
        print(f"{out['name']}: other build {out['other_ms'] * 1e3:.2f} us, this checkout "
              f"{out['ms'] * 1e3:.2f} us ({out['other_ms'] / out['ms']:.2f}x){one}, bound "
              f"{out['bound_ms'] * 1e3:.2f} us ({out['bound_by']})", flush=True)
        results.append(out)
    for kernel in which:
        rs = [r for r in results if r["kernel"] == kernel]
        print(f"{kernel}, {len(rs)} cases: other build {sum(r['other_ms'] for r in rs):.4f} ms, "
              f"this checkout {sum(r['ms'] for r in rs):.4f} ms", flush=True)
    return results


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda("bisect_against")
    if not argv or any(a not in ("K7", "K8", "K9") for a in argv[1:]):
        raise SystemExit("usage: python -m ...scripts.bisect_against OTHER_transposed_bisect.cu "
                         "[K7] [K8] [K9]")
    print(card())
    return run(argv[0], tuple(argv[1:]) or ("K7", "K8", "K9"))


if __name__ == "__main__":
    main()
