"""Fused CBR with a staged, normalised halo band on the card (K3): the
wrapper ``ops/fused_cbr_rows.py``, whose kernel is the trunk's band kernel
``kernels/fused_conv_stats.cu``, against its plain version and cuDNN, and
with ``--against`` against another build of K3.

Counterpart of the JAX package's ``scripts/proto_fused_cbr.py`` ``main()``
:237-255, over its twelve shapes (batch 128, bf16) or the ones named:

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_fused_cbr [--against OTHER_DIR] [shapes...]

Each shape prints, as the JAX script's A/B/C lines (:228-234) do, with
err = max |y - y_B| and stats_rel = max |stats - stats_B| / max(max |stats_B|, 1):

  A. cuDNN conv alone (conv + bias, no prologue, no stats: the lower bound)
  B. the plain chain (prologue, cuDNN conv, bias, stats: what the net does)
  C. the kernel (the band staged once a chunk by TMA, the prologue once an
     element, the nine taps on wgmma), timed in turns with B
  O. with ``--against OTHER_DIR``: the K3 of another commit's ``kernels/``
     directory, its ``fused_cbr_rows.cu`` (the staged-tile kernel K3 had
     before it ran on the band kernel), held to the same bar and timed in
     turns with C (other, this, this, other)

in device ms (median of 20 after warm-up) and TFLOP/s.
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch

from .. import kernels
from ..ops import fused_cbr_rows as fr
from .conv_against import turns
from .timing import card, in_turns, median_ms_device, require_cuda

N = 128
# name: (N, H, W, Cin, Cout, rows); local to main() in the JAX script
# (scripts/proto_fused_cbr.py:239-252)
SHAPES = {
    "bottleneck": (N, 32, 32, 512, 512, 32),      # dec4_1
    "dec4_2": (N, 32, 32, 256, 512, 32),
    "level3": (N, 64, 64, 256, 256, 64),           # enc3_2 / dec3_1
    "level3b": (N, 64, 64, 256, 256, 16),
    "enc3_1": (N, 64, 64, 128, 256, 64),
    "dec3_2": (N, 64, 64, 512, 256, 32),           # concat input
    "level2": (N, 128, 128, 128, 128, 16),         # enc2_2 / dec2_1
    "enc2_1": (N, 128, 128, 64, 128, 16),
    "dec2_2": (N, 128, 128, 256, 128, 16),         # concat input
    "level1": (N, 256, 256, 64, 64, 16),           # enc1_2 / dec1_1
    "level1b": (N, 256, 256, 64, 64, 32),
    "dec1_2": (N, 256, 256, 128, 64, 16),          # concat input
}


def make_inputs(n, h, w, cin, cout, device, seed: int = 0):
    """The JAX script's inputs (bench_shape :212-217), from a torch
    generator on the card: x bf16 N(0, 1), a = 1 + 0.1 N, b = 0.1 N,
    w bf16 0.02 N, bias 0.1 N."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=g, device=device).to(torch.bfloat16)
    a = torch.randn((cin,), generator=g, device=device) * 0.1 + 1.0
    b = torch.randn((cin,), generator=g, device=device) * 0.1
    wt = (torch.randn((3, 3, cin, cout), generator=g, device=device) * 0.02).to(torch.bfloat16)
    bias = torch.randn((cout,), generator=g, device=device) * 0.1
    return x, a, b, wt, bias


def errors(got, want, bias, what: str) -> tuple:
    """(max |y - y_want|, max |stats - stats_want| / max(max |stats_want|, 1));
    raises past the kernel's bar against the plain version: y within
    2^-6 (|y_want| + |bias|) + 2^-16 max |y_want| (the plain version rounds
    the conv output to bf16 before the bias), stats_rel within 1e-2 (cuDNN's
    bf16 conv output carries an offset of a few 1e-3 in sum y^2)."""
    (y, s), (yw, sw) = got, want
    yf, ywf = y.float(), yw.float()
    diff = (yf - ywf).abs()
    bound = 2.0 ** -6 * (ywf.abs() + bias.abs()) + 2.0 ** -16 * float(ywf.abs().max())
    err = float(diff.max())
    serr = float((s - sw).abs().max()) / max(float(sw.abs().max()), 1.0)
    if not (bool((diff <= bound).all()) and serr <= 1e-2):
        raise AssertionError(f"{what} disagrees with the plain version: max |y diff| "
                             f"{err:.4g}, stats_rel {serr:.3g}")
    return err, serr


def other_k3(other_dir: str):
    """Another build's K3 as a function of (x, a, b, w, bias, prologue) ->
    (y, stats): ``OTHER_DIR/fused_cbr_rows.cu`` compiled with this
    checkout's flags."""
    lib = kernels.build_other(os.path.join(other_dir, "fused_cbr_rows.cu"), "fused_cbr_rows")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_cbr_rows_tiles_m.restype = ctypes.c_int64
    lib.fused_cbr_rows_tiles_m.argtypes = [i32] * 3
    lib.fused_cbr_rows_launch.restype = i32
    lib.fused_cbr_rows_launch.argtypes = [ptr] * 5 + [i32] * 6 + [ptr] * 4

    def run(x, a, b, w, bias, prologue):
        n, h, wd, cin = x.shape
        cout = w.shape[-1]
        y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
        partials = torch.empty((2, cout, lib.fused_cbr_rows_tiles_m(n, h, wd)),
                               dtype=torch.float32, device=x.device)
        stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
        rc = lib.fused_cbr_rows_launch(x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
                                       bias.data_ptr(), int(prologue), n, h, wd, cin, cout,
                                       y.data_ptr(), partials.data_ptr(), stats.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other fused_cbr_rows failed to launch ({rc})")
        return y, stats
    return run


def bench_shape(name, n, h, w, cin, cout, rows, other=None) -> dict:
    device = require_cuda("proto_fused_cbr")
    x, a, b, wt, bias = make_inputs(n, h, w, cin, cout, device)
    args = (x, a, b, wt, bias)
    with torch.no_grad():
        want = fr.fused_cbr_reference(*args)
        err_c, serr_c = errors(fr.fused_cbr(*args, rows=rows), want, bias, "fused_cbr_rows")
        if other is not None:
            err_o, serr_o = errors(other(*args, True), want, bias, "the other build's K3")
        del want
        flops = 2 * 9 * cin * cout * h * w * n
        t_a = median_ms_device(lambda: fr.conv_only(x, wt, bias))
        t = in_turns(lambda: fr.fused_cbr_reference(*args), lambda: fr.fused_cbr(*args, rows=rows))
        if other is not None:
            t_o, t_this = turns(lambda: other(*args, True), lambda: fr.fused_cbr(*args, rows=rows))

    def tf(ms):
        return f"{ms:8.3f} ms ({flops / ms / 1e9:6.1f} TF/s)"

    t_b, t_c = t["plain_ms"], t["ms"]
    print(f"[{name}] N{n} {h}x{w} {cin}->{cout} rows={rows}  err={err_c:.4f} "
          f"stats_rel={serr_c:.1e}")
    print(f"  A. cuDNN conv only:         {tf(t_a)}   err, stats_rel: none (no prologue, "
          f"no stats: another function)")
    print(f"  B. plain chain:             {tf(t_b)}   err=0 stats_rel=0 (the reference)")
    print(f"  C. fused_cbr_rows kernel:   {tf(t_c)}   err={err_c:.4f} stats_rel={serr_c:.1e}"
          f"   C vs B: {t_b / t_c:.2f}x  C vs A: {t_a / t_c:.2f}x", flush=True)
    out = {"name": name, "shape": (n, h, w, cin, cout), "rows": rows, "flops": flops,
           "err": err_c, "stats_rel": serr_c, "conv_ms": t_a, "chain_ms": t_b, **t}
    if other is not None:
        print(f"  O. the other build's K3:    {tf(t_o)}   err={err_o:.4f} stats_rel={serr_o:.1e}"
              f"   in turns with C ({tf(t_this)}): O / C {t_o / t_this:.2f}x", flush=True)
        out.update(other_ms=t_o, this_ms=t_this)
    return out


def bench(names=None, other_dir=None) -> list:
    """Every shape of ``names`` (default all); with ``other_dir`` (another
    commit's ``kernels/``) its K3 too, in turns with this one."""
    other = other_k3(other_dir) if other_dir else None
    results = [bench_shape(name, *SHAPES[name], other=other) for name in names or list(SHAPES)]
    total = {k: sum(r[k] for r in results) for k in ("conv_ms", "chain_ms", "ms")}
    line = (f"the {len(results)} shapes: A {total['conv_ms']:.3f} ms, B {total['chain_ms']:.3f} "
            f"ms, C {total['ms']:.3f} ms")
    if other is not None:
        line += (f"; in turns O {sum(r['other_ms'] for r in results):.3f} ms, C "
                 f"{sum(r['this_ms'] for r in results):.3f} ms")
    print(line, flush=True)
    return results


def main(argv=None) -> list:
    require_cuda("proto_fused_cbr")
    argv = list(sys.argv[1:] if argv is None else argv)
    other_dir = None
    if "--against" in argv:
        i = argv.index("--against")
        if i + 1 >= len(argv):
            raise SystemExit("usage: ...proto_fused_cbr [--against OTHER_KERNELS_DIR] [shapes...]")
        other_dir = argv[i + 1]
        del argv[i:i + 2]
    print(card())
    return bench(argv or None, other_dir)


if __name__ == "__main__":
    main()
