"""Fused CBR with a staged halo tile on the card: the CUDA kernel
(``ops/fused_cbr_rows.py``, ``kernels/fused_cbr_rows.cu``) against cuDNN and
against the per-tap fused kernel of the training trunk.

Counterpart of the JAX package's ``scripts/proto_fused_cbr.py`` ``main()``
:237-255, over its twelve shapes (batch 128, bf16) or the ones named:

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_fused_cbr [shapes...]

Each shape prints, as the JAX script's A/B/C lines (:228-234) do, with
err = max |y - y_B| and stats_rel = max |stats - stats_B| / max(max |stats_B|, 1):

  A. cuDNN conv alone (conv + bias, no prologue, no stats: the lower bound)
  B. the plain chain (prologue, cuDNN conv, bias, stats: what the net does)
  C. this kernel (staged, normalised halo tile: the prologue about twice an
     element)
  D. ``ops/fused_cbr.py``'s kernel (``kernels/fused_conv_stats.cu``: the
     prologue on each of the nine taps' loads), at the same shape, so that
     the two designs are compared within one run

in device ms (median of 20 after warm-up) and TFLOP/s.
"""

from __future__ import annotations

import sys

import torch

from ..ops import fused_cbr as fc
from ..ops import fused_cbr_rows as fr
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


def bench_shape(name, n, h, w, cin, cout, rows) -> dict:
    device = require_cuda("proto_fused_cbr")
    x, a, b, wt, bias = make_inputs(n, h, w, cin, cout, device)
    args = (x, a, b, wt, bias)
    with torch.no_grad():
        want = fr.fused_cbr_reference(*args)
        err_c, serr_c = errors(fr.fused_cbr(*args, rows=rows), want, bias, "fused_cbr_rows")
        err_d, serr_d = errors(fc.fused_conv_stats(*args), want, bias, "fused_conv_stats")
        del want
        flops = 2 * 9 * cin * cout * h * w * n
        t_a = median_ms_device(lambda: fr.conv_only(x, wt, bias))
        t = in_turns(lambda: fr.fused_cbr_reference(*args), lambda: fr.fused_cbr(*args, rows=rows))
        t_d = median_ms_device(lambda: fc.fused_conv_stats(*args))

    def tf(ms):
        return f"{ms:8.3f} ms ({flops / ms / 1e9:6.1f} TF/s)"

    t_b, t_c = t["plain_ms"], t["ms"]
    print(f"[{name}] N{n} {h}x{w} {cin}->{cout} rows={rows}  err={err_c:.4f} "
          f"stats_rel={serr_c:.1e}")
    print(f"  A. cuDNN conv only:         {tf(t_a)}   err, stats_rel: none (no prologue, "
          f"no stats: another function)")
    print(f"  B. plain chain:             {tf(t_b)}   err=0 stats_rel=0 (the reference)")
    print(f"  C. fused_cbr_rows kernel:   {tf(t_c)}   err={err_c:.4f} stats_rel={serr_c:.1e}"
          f"   C vs B: {t_b / t_c:.2f}x  C vs A: {t_a / t_c:.2f}x")
    print(f"  D. fused_conv_stats kernel: {tf(t_d)}   err={err_d:.4f} stats_rel={serr_d:.1e}"
          f"   C vs D: {t_d / t_c:.2f}x", flush=True)
    return {"name": name, "shape": (n, h, w, cin, cout), "rows": rows, "flops": flops,
            "err": err_c, "stats_rel": serr_c, "err_d": err_d, "stats_rel_d": serr_d,
            "conv_ms": t_a, "chain_ms": t_b, "fused_conv_stats_ms": t_d, **t}


def bench(names=None) -> list:
    return [bench_shape(name, *SHAPES[name]) for name in names or list(SHAPES)]


def main(argv=None) -> None:
    require_cuda("proto_fused_cbr")
    print(card())
    bench((sys.argv[1:] if argv is None else argv) or None)


if __name__ == "__main__":
    main()
