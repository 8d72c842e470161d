"""Fused CBR in the transposed (H, C, W, N) layout on the card: the CUDA
kernel's two designs (``ops/transposed_cbr.py``,
``kernels/transposed_cbr.cu``) against cuDNN, the plain chain and the NHWC
staged-band kernel (K3).

Counterpart of the JAX package's ``scripts/proto_transposed_cbr.py``
``check_numerics`` (:324-343) and ``bench`` (:346-378)::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_transposed_cbr [check|bench|all] [--against OTHER_DIR]

``check`` holds v1 and v2 against the plain chain at N=8, 32x32, 64->64.
``bench`` runs at the level-1 shape (N=128, 256x256, 64->64, bf16; x is 1
GiB) and prints, in device ms (median of 20 after warm-up) and TFLOP/s:

  A. cuDNN conv alone on NHWC (no prologue, no stats: another function)
  B. the plain chain on NHWC (prologue, cuDNN conv, bias, stats)
  C. v1 and v2 at (rows, w_blk) = (4, 16), in turns; the JAX script's
     eight v2 (rows, w_blk, vmem_mb) (:366-368) are checked as the wrapper
     checks them and not timed one by one: the CUDA tile is its own and
     ``vmem_mb`` a TPU knob, so the eight launch one kernel
  D. ``fused_cbr_rows`` (K3, the staged-band kernel) on NHWC at the same shape
  E. the NHWC -> (H, C, W, N) permute copy: what a trunk in this layout
     would pay at each boundary with an NHWC one
  O. with ``--against OTHER_DIR`` (another commit's ``kernels/``): that
     build's ``transposed_cbr.cu`` (``other_k6``), v1 and v2 each held to the
     same bar and timed in turns with this one (other, this, this, other)

and the plain version of the transposed function (the permutes around B).
Unlike the JAX script, no failure is caught: the script raises.
"""

from __future__ import annotations

import os
import sys

import torch

from .. import kernels
from ..ops import fused_cbr_rows as fr
from ..ops import transposed_cbr as tc
from .conv_against import turns
from .proto_fused_cbr import errors
from .timing import card, in_turns, median_ms_device, require_cuda

# (N, H, W, Cin, Cout): check_numerics' and bench's defaults (:324, :346)
CHECK_SHAPE = (8, 32, 32, 64, 64)
BENCH_SHAPE = (128, 256, 256, 64, 64)
CHECK_BLOCKS = (4, 16)  # check_numerics' (rows, w_blk), :338
V1_BLOCKS = (4, 16)     # bench's v1 (rows, w_blk), :363
# bench's v2 (rows, w_blk, vmem_mb), :366-368
V2_BLOCKS = ((4, 16, None), (8, 16, None), (4, 32, None), (8, 16, 64), (4, 32, 64),
             (8, 32, 96), (16, 32, 110), (4, 64, 96))


def make_inputs(n, h, w, cin, cout, device, seed: int = 0):
    """The JAX script's inputs (bench :347-355), from a torch generator on
    the card: x bf16 N(0, 1) as NHWC, a = 1 + 0.1 N, b = 0.1 N, w bf16
    0.05 N, bias 0.1 N."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=g, device=device).to(torch.bfloat16)
    a = torch.randn((cin,), generator=g, device=device) * 0.1 + 1.0
    b = torch.randn((cin,), generator=g, device=device) * 0.1
    wt = (torch.randn((3, 3, cin, cout), generator=g, device=device) * 0.05).to(torch.bfloat16)
    bias = torch.randn((cout,), generator=g, device=device) * 0.1
    return x, a, b, wt, bias


def _errors(got, want, bias, what):
    """``proto_fused_cbr.errors`` on the NHWC views (the bias on the last
    dimension)."""
    return errors((tc.to_nhwc(got[0]), got[1]), (tc.to_nhwc(want[0]), want[1]), bias, what)


def _versions(rows, w_blk):
    return (("v1", lambda *args: tc.transposed_fused_cbr(*args, rows=rows, w_blk=w_blk)),
            ("v2", lambda *args: tc.transposed_fused_cbr_v2(*args, rows=rows, w_blk=w_blk)))


def other_k6(other_dir: str):
    """Another build's K6 as a function of (x, a, b, w, bias, prologue,
    stacked_m) -> (y, stats): ``OTHER_DIR/transposed_cbr.cu`` compiled with
    this checkout's flags and launched through the C interface both share
    (``tc.run_kernel``). Raises FileNotFoundError where it is missing."""
    lib = tc.bind(kernels.build_other(os.path.join(other_dir, "transposed_cbr.cu"),
                                      "transposed_cbr"))

    def run(x, a, b, w, bias, prologue, stacked_m):
        return tc.run_kernel(lib, x, a, b, w, bias, prologue, stacked_m)
    return run


def check(shape=CHECK_SHAPE) -> dict:
    """v1 and v2 against the plain chain (``proto_fused_cbr.errors``' bars);
    raises past them."""
    device = require_cuda("proto_transposed_cbr")
    x, a, b, wt, bias = make_inputs(*shape, device)
    xt = tc.from_nhwc(x).contiguous()
    out = {}
    with torch.no_grad():
        want = tc.transposed_fused_cbr_reference(xt, a, b, wt, bias)
        for tag, fn in _versions(*CHECK_BLOCKS):
            err, serr = _errors(fn(xt, a, b, wt, bias), want, bias, f"transposed_fused_cbr {tag}")
            print(f"numerics {tag}: max|dy|={err:.3e} stats_rel={serr:.3e}", flush=True)
            out[tag] = {"err": err, "stats_rel": serr}
    return out


def bench(shape=BENCH_SHAPE, other_dir=None) -> dict:
    """A-E (and O with ``other_dir``) at ``shape``; raises past the bars."""
    device = require_cuda("proto_transposed_cbr")
    other = other_k6(other_dir) if other_dir else None
    n, h, w, cin, cout = shape
    flops = 2 * n * h * w * 9 * cin * cout
    x, a, b, wt, bias = make_inputs(*shape, device)
    out = {"shape": shape, "flops": flops}

    def tf(ms):
        return f"{ms:8.3f} ms ({flops / ms / 1e9:6.1f} TF/s)"

    with torch.no_grad():
        xt = tc.from_nhwc(x).contiguous()
        xn = torch.relu(x.float() * a + b).to(x.dtype)
        args = (xt, a, b, wt, bias)
        out["conv_ms"] = median_ms_device(lambda: tc.conv_only(xn, wt, bias))
        print(f"A cuDNN conv only (NHWC, isolated): {tf(out['conv_ms'])}")
        del xn
        out["chain_ms"] = median_ms_device(lambda: tc.chain(x, a, b, wt, bias))
        print(f"B plain chain conv+BNstats+relu (NHWC): {tf(out['chain_ms'])}")
        want = tc.transposed_fused_cbr_reference(*args)
        for tag, fn in _versions(*V1_BLOCKS):
            err, serr = _errors(fn(*args), want, bias, f"transposed_fused_cbr {tag}")
            out[f"{tag}_err"], out[f"{tag}_stats_rel"] = err, serr
        del want
        t = in_turns(lambda: tc.transposed_fused_cbr_reference(*args),
                     lambda: tc.transposed_fused_cbr(*args, rows=V1_BLOCKS[0],
                                                     w_blk=V1_BLOCKS[1]))
        out["v1"] = t
        out["plain_ms"] = t["plain_ms"]
        print(f"C v1 rows={V1_BLOCKS[0]} w_blk={V1_BLOCKS[1]}: {tf(t['ms'])}   "
              f"err={out['v1_err']:.4f} stats_rel={out['v1_stats_rel']:.1e}; the plain "
              f"version on (H, C, W, N) (permutes + B): {tf(t['plain_ms'])}", flush=True)
        for rows, w_blk, _ in V2_BLOCKS:
            tc.check_blocks(xt, rows, w_blk)
        print(f"C v2's {len(V2_BLOCKS)} (rows, w_blk, vmem_mb) of the JAX bench accepted; "
              f"they do not set the CUDA tile, so v2 is timed once")
        # the two designs in turns (v1, v2, v2, v1): both see the same clocks
        rows, w_blk, _ = V2_BLOCKS[0]
        t = in_turns(lambda: tc.transposed_fused_cbr(*args, rows=V1_BLOCKS[0],
                                                     w_blk=V1_BLOCKS[1]),
                     lambda: tc.transposed_fused_cbr_v2(*args, rows=rows, w_blk=w_blk))
        out["v2"] = {"rows": rows, "w_blk": w_blk, "ms": t["ms"]}
        out["v1_vs_v2"] = {"v1_ms": t["plain_ms"], "v2_ms": t["ms"]}
        print(f"C v2 rows={rows} w_blk={w_blk}: {tf(t['ms'])}; v1 in turns {tf(t['plain_ms'])}: "
              f"v2/v1 {t['ms'] / t['plain_ms']:.3f}", flush=True)
        if other is not None:
            want = tc.transposed_fused_cbr_reference(*args)
            for tag in ("v1", "v2"):
                _errors(other(*args, True, tag == "v2"), want, bias, f"the other build's {tag}")
            del want
            for tag, fn in _versions(*V1_BLOCKS):
                stacked = tag == "v2"
                o_ms, t_ms = turns(lambda: other(*args, True, stacked), lambda: fn(*args))
                out[f"{tag}_against"] = {"other_ms": o_ms, "ms": t_ms}
                print(f"O {tag} of the other build {tf(o_ms)}, this one in turns {tf(t_ms)}: "
                      f"other / this {o_ms / t_ms:.2f}x", flush=True)
        out["rows_ms"] = median_ms_device(lambda: fr.fused_cbr(x, a, b, wt, bias, rows=16))
        print(f"D fused_cbr_rows (NHWC, staged halo band): {tf(out['rows_ms'])}")
        out["permute_ms"] = median_ms_device(lambda: tc.from_nhwc(x).contiguous())
        print(f"E NHWC -> (H, C, W, N) permute copy of x ({x.numel() * 2 / 2 ** 30:.2f} GiB): "
              f"{out['permute_ms']:8.3f} ms ({2 * x.numel() * 2 / out['permute_ms'] / 1e6:.1f} "
              f"GB/s read + written)", flush=True)
    return out


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    other_dir = None
    if "--against" in argv:
        i = argv.index("--against")
        if i + 1 >= len(argv):
            raise SystemExit("usage: proto_transposed_cbr [check|bench|all] "
                             "[--against OTHER_KERNELS_DIR]")
        other_dir = argv[i + 1]
        del argv[i:i + 2]
    which = argv[0] if argv else "all"
    if which not in ("check", "bench", "all"):
        raise SystemExit(f"usage: proto_transposed_cbr [check|bench|all], got {which!r}")
    require_cuda("proto_transposed_cbr")
    print(card())
    out = {}
    if which in ("check", "all"):
        out["check"] = check()
    if which in ("bench", "all"):
        out["bench"] = bench(other_dir=other_dir)
    return out


if __name__ == "__main__":
    main()
