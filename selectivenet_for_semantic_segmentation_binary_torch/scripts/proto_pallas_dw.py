"""conv3x3 filter gradient (dW) on the card: the CUDA kernel
(``ops/conv_dw.py``, ``kernels/conv_dw.cu``) against cuDNN.

Counterpart of the JAX package's ``scripts/proto_pallas_dw.py``, with its
modes and flags:

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_pallas_dw check
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_pallas_dw bench [shapes...]
        [--variant taps9|x3g3] [--th TH] [--tw TW]

``check`` holds the kernel, at the JAX script's four check shapes in float32
and bf16, to a float64 computation of the same operands with the script's
bars (2e-6 and 2e-2 of max |dW|), and prints how far the plain version
(cuDNN's weight gradient) is from the same float64: cuDNN's float32 weight
gradient itself misses the 2e-6 bar on the H100. ``bench`` times, at each of
the JAX script's shapes (batch 128, bf16), the kernel, cuDNN's weight gradient on the
[H, W, N, C] operands as given (their permuted NCHW views: the JAX script's
``xla-hwnc`` column) and on channels_last NHWC copies (``xla-nhwc``), in
device ms and TFLOP/s with the share of the H100's 989 TFLOP/s bf16 dense
peak. The JAX script's scan depth S only amortised the TPU's dispatch; the
device timing here needs none. ``--variant``, ``--th`` and ``--tw`` are
checked as the TPU kernel checks them; the CUDA kernel picks its own tiles.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import conv_dw as cd
from .timing import card, median_ms_device, require_cuda

# (key, H(=W), Ci, Co, TH, TW, S): batch fixed at 128 to match the flagship
# (scripts/proto_pallas_dw.py:229-238)
SHAPES = {
    "lvl1": (256, 64, 64, 8, 8, 4),
    "dec1_2": (256, 128, 64, 8, 8, 4),
    "lvl2": (128, 128, 128, 4, 4, 4),
    "lvl2w": (128, 128, 128, 4, 8, 4),
    "dec2_2": (128, 256, 128, 4, 4, 4),
    "lvl3": (64, 256, 256, 4, 4, 6),
    "dec3_2": (64, 512, 256, 2, 4, 6),
    "btl": (32, 512, 512, 2, 4, 6),
}
N = 128
# (H, W, N, Ci, Co, TH, TW): scripts/proto_pallas_dw.py:195-200
CHECK_SHAPES = [
    (16, 16, 8, 64, 64, 8, 8),
    (16, 24, 8, 128, 64, 8, 8),
    (8, 8, 16, 64, 128, 4, 4),
    (32, 16, 4, 128, 128, 8, 16),
]
TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}  # :207 and :217
PEAK_TFLOPS = 989.0  # H100 SXM bf16 dense, NVIDIA's data sheet


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, the JAX script's measure."""
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-9)


def check(variant: str = "taps9", seed: int = 0) -> float:
    """The kernel against float64 at the check shapes; returns the largest
    relative error, raises past the bar."""
    device = require_cuda("proto_pallas_dw check")
    print(f"variant={variant}", flush=True)
    g = torch.Generator(device=device).manual_seed(seed)
    worst = 0.0
    for h, w, n, ci, co, th, tw in CHECK_SHAPES:
        x = torch.randn((h, w, n, ci), generator=g, device=device)
        gy = torch.randn((h, w, n, co), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to(dtype), gy.to(dtype)
            exact = cd.conv3x3_dw_reference(xd.double(), gd.double())
            err = rel_err(cd.conv3x3_dw(xd, gd, TH=th, TW=tw, variant=variant), exact)
            plain = rel_err(cd.conv3x3_dw_reference(xd, gd), exact)
            ok = err < TOL[dtype]
            print(f"{str(dtype)[6:]} {h}x{w} N{n} {ci}->{co} T({th},{tw}): rel {err:.2e} "
                  f"{'ok' if ok else 'FAIL'} (plain version rel {plain:.2e})", flush=True)
            if not ok:
                raise AssertionError(f"conv3x3_dw {dtype} at {(h, w, n, ci, co)}: rel {err:.2e}")
            worst = max(worst, err)
    print("ALL DW CHECKS PASSED", flush=True)
    return worst


def bench(keys=None, variant: str = "taps9", th: int = 0, tw: int = 0, seed: int = 1) -> list:
    """Device ms of the kernel, cuDNN on the operands as given, and cuDNN on
    channels_last NHWC, at each shape; the kernel's error against the
    plain version. Returns one dict a shape."""
    device = require_cuda("proto_pallas_dw bench")
    print(f"variant={variant} th_ovr={th} tw_ovr={tw}", flush=True)
    results = []
    for key in keys or list(SHAPES):
        h, ci, co, th_k, tw_k, _s = SHAPES[key]
        th_k, tw_k = th or th_k, tw or tw_k
        g = torch.Generator(device=device).manual_seed(seed)
        x = torch.randn((h, h, N, ci), generator=g, device=device).to(torch.bfloat16)
        gy = torch.randn((h, h, N, co), generator=g, device=device).to(torch.bfloat16)
        # NHWC copies, made outside the timing (the JAX script transposes
        # outside its jit too)
        x_nhwc = x.permute(2, 0, 1, 3).contiguous()
        g_nhwc = gy.permute(2, 0, 1, 3).contiguous()

        def kernel():
            return cd.conv3x3_dw(x, gy, TH=th_k, TW=tw_k, variant=variant)

        def hwnc():
            return cd.conv3x3_dw_reference(x, gy)

        def nhwc():
            # the reference on [H, W, N, C] views of the NHWC copies: cuDNN
            # sees channels_last NCHW tensors
            return cd.conv3x3_dw_reference(x_nhwc.permute(1, 2, 0, 3), g_nhwc.permute(1, 2, 0, 3))

        err = rel_err(kernel(), hwnc())
        if not err < TOL[torch.bfloat16]:
            raise AssertionError(f"conv3x3_dw at {key}: rel {err:.2e} against cuDNN")
        # in turns: hwnc, nhwc, kernel, kernel, nhwc, hwnc
        t_h1, t_n1 = median_ms_device(hwnc), median_ms_device(nhwc)
        t_k1, t_k2 = median_ms_device(kernel), median_ms_device(kernel)
        t_n2, t_h2 = median_ms_device(nhwc), median_ms_device(hwnc)
        t_k, t_h, t_n = (t_k1 + t_k2) / 2, (t_h1 + t_h2) / 2, (t_n1 + t_n2) / 2
        flops = 2 * N * h * h * 9 * ci * co
        ideal = flops / (PEAK_TFLOPS * 1e12) * 1e3

        def col(ms):
            return f"{ms:7.3f} ms ({flops / ms / 1e9:6.1f} TF/s, {ideal / ms * 100:5.1f}%)"

        print(f"{key:8s} {ci:3d}->{co:3d} @{h:3d} T({th_k},{tw_k}) rel {err:.1e}  "
              f"kernel {col(t_k)}  cudnn-hwnc {col(t_h)}  cudnn-nhwc {col(t_n)}  "
              f"speedup {t_h / t_k:4.2f}x/{t_n / t_k:4.2f}x", flush=True)
        results.append({"key": key, "ci": ci, "co": co, "h": h, "flops": flops, "rel_err": err,
                        "ms": t_k, "plain_ms": t_h, "nhwc_ms": t_n,
                        "kernel_runs": (t_k1, t_k2), "plain_runs": (t_h1, t_h2)})
        del x, gy, x_nhwc, g_nhwc
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["check", "bench"])
    ap.add_argument("shapes", nargs="*", default=None, help=f"of {list(SHAPES)}")
    ap.add_argument("--variant", default="taps9", choices=list(cd.VARIANTS))
    ap.add_argument("--th", type=int, default=0)
    ap.add_argument("--tw", type=int, default=0)
    a = ap.parse_args(argv)
    require_cuda("proto_pallas_dw")
    print(card())
    if a.mode == "check":
        check(a.variant)
    else:
        bench(a.shapes or None, a.variant, a.th, a.tw)


if __name__ == "__main__":
    main()
