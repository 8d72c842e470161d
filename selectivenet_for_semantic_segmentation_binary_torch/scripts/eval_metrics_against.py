"""K1 (``kernels/eval_metrics.cu``) of this checkout against another build of
its source, on the card::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.eval_metrics_against OTHER_DIR

OTHER_DIR holds another commit's ``kernels/`` directory (unpacked with ``git
archive``, as for ``conv_against``). Its ``eval_metrics.cu`` is compiled with
this checkout's nvcc flags into ``kernels/_build/`` and called through its
own C interface (``other_k1``: the one-launch interface of this checkout, or
the earlier one whose int32 per-block rows the caller summed). At the eval
step's shape (128, 256, 256), selective, sigmoid, uint8 labels, on seeded
logits: both builds' counts equal the plain version's, integer for integer,
and the two are timed in turns (other, this, this, other), device medians of
20 after warm-up, beside the bound (the bytes read over 3.35 TB/s).
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch

from .. import kernels
from ..ops import eval_metrics as em
from .conv_against import turns
from .timing import bound_ms, card, require_cuda

SHAPE = (128, 256, 256)
# the earlier interface's pixels per block (its wrapper's PER_BLOCK)
OLD_PER_BLOCK = 4096


def other_k1(other_dir: str):
    """Another build's K1 as a function of (output, label, selection,
    apply_sigmoid, cut_off, s_cut_off) -> the six int64 counts (cm00 cm01 cm10
    cm11 reject valid), selective where selection is given:
    ``OTHER_DIR/eval_metrics.cu`` compiled with this checkout's flags. Raises
    FileNotFoundError where it is missing."""
    lib = kernels.build_other(os.path.join(other_dir, "eval_metrics.cu"), "eval_metrics")
    if getattr(lib, "eval_metrics_grid", None) is not None:
        em.bind(lib)
        return lambda *args: em.run_kernel(lib, *args)
    # the earlier interface: int32 rows of six counts per block, summed here
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.eval_metrics_launch.restype = i32
    lib.eval_metrics_launch.argtypes = [ptr, ptr, ptr, i32, i64, i32, i32, ctypes.c_float,
                                        ctypes.c_float, i64, i32, ptr, ptr]

    def run(output, label, selection, apply_sigmoid, cut_off, s_cut_off):
        n = output.numel()
        blocks = max(1, -(-n // OLD_PER_BLOCK))
        partials = torch.empty((blocks, 6), dtype=torch.int32, device=output.device)
        sel = output if selection is None else selection
        rc = lib.eval_metrics_launch(output.data_ptr(), sel.data_ptr(), label.data_ptr(),
                                     label.element_size(), n, int(apply_sigmoid),
                                     int(selection is not None), cut_off, s_cut_off,
                                     OLD_PER_BLOCK, blocks, partials.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other eval_metrics failed to launch ({rc})")
        return partials.sum(0, dtype=torch.int64)
    return run


def compare(other, output, label, selection, cut_off: float = 0.5,
            s_cut_off: float = 0.5) -> dict:
    """Both builds' counts against the plain version's (raises at a
    difference), then the two timed in turns; the bound from the bytes read."""
    kw = dict(apply_sigmoid=True, selective=True, cut_off=cut_off, s_cut_off=s_cut_off)
    want = em.eval_metrics_reference(output, label, selection, **kw)
    want = torch.cat([want["cm"].reshape(4), want["n_reject"].reshape(1),
                      want["n_pix"].reshape(1)])
    got = em.fused_eval_metrics(output, label, selection, **kw)
    this = torch.cat([got["cm"].reshape(4), got["n_reject"].reshape(1), got["n_pix"].reshape(1)])
    theirs = other(output, label, selection, True, cut_off, s_cut_off)
    for which, counts in (("this", this), ("the other", theirs)):
        if not torch.equal(counts.cpu(), want.cpu()):
            raise AssertionError(f"{which} build's counts {counts.tolist()} != the plain "
                                 f"version's {want.tolist()}")
    other_ms, ms = turns(lambda: other(output, label, selection, True, cut_off, s_cut_off),
                         lambda: em.fused_eval_metrics(output, label, selection, **kw))
    nbytes = output.numel() * (output.element_size() + selection.element_size()
                               + label.element_size())
    return {"other_ms": other_ms, "ms": ms, **bound_ms(nbytes + 6 * 8, 0)}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda("eval_metrics_against")
    if len(argv) != 1:
        raise SystemExit("usage: python -m ...scripts.eval_metrics_against OTHER_KERNELS_DIR")
    print(card())
    g = torch.Generator(device=device).manual_seed(0)
    output = torch.randn(SHAPE, generator=g, device=device)
    selection = torch.randn(SHAPE, generator=g, device=device)
    label = torch.randint(0, 2, SHAPE, generator=g, device=device, dtype=torch.uint8)
    r = compare(other_k1(argv[0]), output, label, selection)
    print(f"k1 at {SHAPE}: other {r['other_ms'] * 1e3:.2f} us, this {r['ms'] * 1e3:.2f} us "
          f"({r['other_ms'] / r['ms']:.2f}x), bound {r['bound_ms'] * 1e3:.2f} us", flush=True)
    return r


if __name__ == "__main__":
    main()
