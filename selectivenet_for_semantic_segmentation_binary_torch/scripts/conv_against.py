"""K2 (``kernels/fused_conv_stats.cu``) and K5 (``kernels/conv_dw.cu``) of
this checkout against another build of the same sources, on the card::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.conv_against OTHER_DIR [k2] [k5]

OTHER_DIR holds another commit's ``kernels/`` directory, for example
unpacked with ``git archive <commit>
selectivenet_for_semantic_segmentation_binary_torch/kernels | tar -x -C
DIR`` (then OTHER_DIR is DIR/selectivenet_for_semantic_segmentation_binary_torch/kernels).
Its ``fused_conv_stats.cu`` and ``conv_dw.cu`` are compiled with this
checkout's nvcc flags into ``kernels/_build/`` and called through the same C
interface. Then, at batch 128 in bf16:

* k2: each of the 13 kernel layers of the fused trunk at 256x256
  (``timing.CBR_LAYERS``): the other build and this one, timed in turns (other, this,
  this, other), the cuDNN conv alone at that shape (conv + bias, no
  prologue, no stats: a yardstick, not the same function), and the bound;
  both builds' y held to each other within two bf16 ulps and their stats
  within 1e-3 of [sum |y|, sum y^2];
* k5: each shape of ``proto_pallas_dw.SHAPES``: the other build, this one
  and cuDNN's NHWC weight gradient, timed in turns, the bound; both held to
  the plain version within its bar (2e-2 of max |dW|).

Device medians of 20 runs after warm-up; raises at the first disagreement.
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch
import torch.nn.functional as F

from .. import kernels
from ..ops import conv_dw as cd
from ..ops import fused_cbr as fc
from . import proto_pallas_dw
from .timing import CBR_LAYERS, bound_ms, card, cbr_bytes, median_ms_device, require_cuda

N = 128


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def other_k2(lib: ctypes.CDLL):
    """The other build's fused_conv_stats as a function of (x, a, b, w,
    bias, prologue) -> (y, stats)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_conv_stats_launch.restype = i32
    lib.fused_conv_stats_launch.argtypes = [ptr] * 5 + [i32] * 6 + [ptr] * 4
    tiles_m = getattr(lib, "fused_conv_stats_tiles_m", None)
    if tiles_m is not None:
        tiles_m.restype = ctypes.c_int64
        tiles_m.argtypes = [i32] * 4
    else:  # builds before the TMA redesign: one partial per 128-pixel tile
        lib.fused_conv_stats_tile_m.restype = i32

    def run(x, a, b, w, bias, prologue):
        n, h, wd, cin = x.shape
        cout = w.shape[-1]
        tiles = (tiles_m(n, h, wd, cout) if tiles_m is not None
                 else -(-(n * h * wd) // lib.fused_conv_stats_tile_m()))
        y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
        partials = torch.empty((2, cout, tiles), dtype=torch.float32, device=x.device)
        stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
        rc = lib.fused_conv_stats_launch(x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
                                         bias.data_ptr(), int(prologue), n, h, wd, cin, cout,
                                         y.data_ptr(), partials.data_ptr(), stats.data_ptr(),
                                         _stream())
        if rc != 0:
            raise RuntimeError(f"the other fused_conv_stats failed to launch ({rc})")
        return y, stats
    return run


def other_k5(lib: ctypes.CDLL):
    """The other build's conv_dw as a function of (x, g) -> dW."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv_dw_splits.restype = i32
    lib.conv_dw_splits.argtypes = [i32] * 6
    lib.conv_dw_launch.restype = i32
    lib.conv_dw_launch.argtypes = [ptr, ptr] + [i32] * 6 + [ptr] * 3

    def run(x, g):
        h, w, n, ci = x.shape
        co = g.shape[-1]
        splits = lib.conv_dw_splits(h, w, n, ci, co, 1)
        partials = torch.empty((splits, 3, 3, ci, co), dtype=torch.float32, device=x.device)
        dw = torch.empty((3, 3, ci, co), dtype=torch.float32, device=x.device)
        rc = lib.conv_dw_launch(x.data_ptr(), g.data_ptr(), 1, h, w, n, ci, co,
                                partials.data_ptr(), dw.data_ptr(), _stream())
        if rc != 0:
            raise RuntimeError(f"the other conv_dw failed to launch ({rc})")
        return dw
    return run


def turns(other, this) -> tuple:
    """Device medians of the other build and this one, in turns."""
    o1, t1 = median_ms_device(other), median_ms_device(this)
    t2, o2 = median_ms_device(this), median_ms_device(other)
    return (o1 + o2) / 2, (t1 + t2) / 2


def run_k2(other_dir: str, device) -> list:
    other = other_k2(kernels.build_other(os.path.join(other_dir, "fused_conv_stats.cu"),
                                         "fused_conv_stats"))
    results = []
    g = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        for name, cin, cout, size, prologue in CBR_LAYERS:
            x = (torch.randn((N, size, size, cin), generator=g, device=device) * 2 + 0.3
                 ).to(torch.bfloat16)
            a = torch.rand((cin,), generator=g, device=device) + 0.5
            b = torch.randn((cin,), generator=g, device=device) * 0.5
            w = (torch.randn((3, 3, cin, cout), generator=g, device=device)
                 * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
            bias = torch.randn((cout,), generator=g, device=device) * 0.1
            args = (x, a, b, w, bias, prologue)
            yo, so = other(*args)
            yt, st = fc.fused_conv_stats(*args)
            yof, ytf = yo.float(), yt.float()
            scale = torch.stack([yof.abs().sum((0, 1, 2)), (yof * yof).sum((0, 1, 2))])
            if not bool(((ytf - yof).abs() <= 2.0 ** -6 * yof.abs()
                         + 2.0 ** -16 * yof.abs().max()).all()):
                raise AssertionError(f"{name}: this build's y disagrees with the other's")
            if not float(((st - so).abs() / scale.clamp_min(1e-30)).max()) <= 1e-3:
                raise AssertionError(f"{name}: this build's stats disagree with the other's")
            del yo, so, yt, st, yof, ytf
            other_ms, ms = turns(lambda: other(*args), lambda: fc.fused_conv_stats(*args))
            xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view
            wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            conv_ms = median_ms_device(lambda: F.conv2d(xc, wc, bias.to(torch.bfloat16),
                                                        padding=1))
            flops = 2 * N * size * size * 9 * cin * cout
            out = {"name": name, "cin": cin, "cout": cout, "size": size, "prologue": prologue,
                   "other_ms": other_ms, "ms": ms, "conv_ms": conv_ms, "flops": flops,
                   **bound_ms(cbr_bytes(N, size, size, cin, cout), flops)}
            print(f"k2 {name} {cin}->{cout} at {size}x{size} prologue {'on' if prologue else 'off'}"
                  f": other {other_ms:.3f} ms, this {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{other_ms / ms:.2f}x), cuDNN conv alone {conv_ms:.3f} ms, bound "
                  f"{out['bound_ms']:.3f} ms", flush=True)
            results.append(out)
            del x, w, args
    print(f"k2 the {len(results)} layers: other {sum(r['other_ms'] for r in results):.3f} ms, "
          f"this {sum(r['ms'] for r in results):.3f} ms, cuDNN conv alone "
          f"{sum(r['conv_ms'] for r in results):.3f} ms, bound "
          f"{sum(r['bound_ms'] for r in results):.3f} ms", flush=True)
    return results


def run_k5(other_dir: str, device) -> list:
    other = other_k5(kernels.build_other(os.path.join(other_dir, "conv_dw.cu"), "conv_dw"))
    results = []
    for key, (h, ci, co, _th, _tw, _s) in proto_pallas_dw.SHAPES.items():
        g = torch.Generator(device=device).manual_seed(1)
        x = torch.randn((h, h, N, ci), generator=g, device=device).to(torch.bfloat16)
        gy = torch.randn((h, h, N, co), generator=g, device=device).to(torch.bfloat16)
        x_nhwc = x.permute(2, 0, 1, 3).contiguous()
        g_nhwc = gy.permute(2, 0, 1, 3).contiguous()
        plain = cd.conv3x3_dw_reference(x, gy)
        for which, fn in (("other", other), ("this", cd.conv3x3_dw)):
            err = proto_pallas_dw.rel_err(fn(x, gy), plain)
            if not err < proto_pallas_dw.TOL[torch.bfloat16]:
                raise AssertionError(f"k5 {key}: the {which} build is {err:.2e} from the plain "
                                     f"version")
        del plain

        def nhwc():
            return cd.conv3x3_dw_reference(x_nhwc.permute(1, 2, 0, 3), g_nhwc.permute(1, 2, 0, 3))

        other_ms, ms = turns(lambda: other(x, gy), lambda: cd.conv3x3_dw(x, gy))
        nhwc_ms = median_ms_device(nhwc)
        flops = 2 * N * h * h * 9 * ci * co
        out = {"key": key, "ci": ci, "co": co, "h": h, "other_ms": other_ms, "ms": ms,
               "nhwc_ms": nhwc_ms, "flops": flops,
               **bound_ms(2 * h * h * N * (ci + co) + 4 * 9 * ci * co, flops)}
        print(f"k5 {key} {ci}->{co} at {h}x{h}: other {other_ms:.3f} ms, this {ms:.3f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {other_ms / ms:.2f}x), cuDNN NHWC {nhwc_ms:.3f} "
              f"ms ({nhwc_ms / ms:.2f}x), bound {out['bound_ms']:.3f} ms", flush=True)
        results.append(out)
        del x, gy, x_nhwc, g_nhwc
    print(f"k5 the {len(results)} shapes: other {sum(r['other_ms'] for r in results):.3f} ms, "
          f"this {sum(r['ms'] for r in results):.3f} ms, cuDNN NHWC "
          f"{sum(r['nhwc_ms'] for r in results):.3f} ms, bound "
          f"{sum(r['bound_ms'] for r in results):.3f} ms", flush=True)
    return results


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda("conv_against")
    if not argv or any(a not in ("k2", "k5") for a in argv[1:]):
        raise SystemExit("usage: python -m ...scripts.conv_against OTHER_KERNELS_DIR [k2] [k5]")
    print(card())
    which = argv[1:] or ["k2", "k5"]
    out = {}
    if "k5" in which:
        out["k5"] = run_k5(argv[0], device)
    if "k2" in which:
        out["k2"] = run_k2(argv[0], device)
    return out


if __name__ == "__main__":
    main()
