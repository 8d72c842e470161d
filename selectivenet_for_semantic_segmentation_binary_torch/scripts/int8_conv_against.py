"""K10 (``kernels/int8_conv.cu``) of this checkout against another build of
the same source, on the card::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.int8_conv_against OTHER_DIR

OTHER_DIR holds another commit's ``kernels/`` directory, for example
unpacked with ``git archive <commit>
selectivenet_for_semantic_segmentation_binary_torch/kernels | tar -x -C
DIR`` (then OTHER_DIR is DIR/selectivenet_for_semantic_segmentation_binary_torch/kernels).
Its ``int8_conv.cu`` is compiled with this checkout's nvcc flags into
``kernels/_build/`` and called through the same C interface
(``int8_conv_launch``). Then, at batch 128, for each of the 14 trunk convs
of a UNet_B forward (``timing.INT8_LAYERS``; float32 x at the first layer,
bf16 elsewhere, the static epilogue into bf16, as the W8A8 serving CBR
runs them): the other build and this one timed in turns (other, this,
this, other), both held equal to each other bit for bit (each is bit-equal
to the plain version), this build's path (``kernel_path``), cuDNN's bf16
conv of the same layer alone (no bias, no ReLU: a yardstick, not the same
function) and the bound (int8 operations at 1,979 TOP/s, the bytes at 3.35
TB/s).

Device medians of 20 runs after warm-up; raises at the first disagreement.
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch
import torch.nn.functional as F

from .. import kernels
from ..ops import int8_conv as ic
from .conv_against import turns
from .timing import INT8_LAYERS, PEAK_INT8_OPS, bound_ms, card, median_ms_device, require_cuda

N = 128


def operands(g, device, n, s, cin, cout, x_dtype):
    """x (n, s, s, cin) in x_dtype, int8 weights, the activation scale, the
    weight scales and a bias, from the generator g."""
    x = torch.randn(n, s, s, cin, device=device, generator=g).to(x_dtype)
    wq = torch.randint(-127, 128, (cout, 3, 3, cin), device=device, generator=g,
                       dtype=torch.int8)
    a = torch.rand((), device=device, generator=g) * 0.02 + 0.01
    ks = torch.rand(cout, device=device, generator=g) * 1e-3 + 1e-4
    bias = torch.randn(cout, device=device, generator=g) * 0.1
    return x, wq, a, ks, bias


def layer_bytes(n, s, cin, cout, x_bytes, y_bytes) -> int:
    """x read, y written, the int8 weights and the float32 scales and bias."""
    return n * s * s * (cin * x_bytes + cout * y_bytes) + 9 * cin * cout + 8 * cout + 4


def other_k10(lib: ctypes.CDLL):
    """The other build's int8_conv as a function of (x, wq, a, ks, bias,
    out_dtype) -> y, the static epilogue."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.int8_conv_launch.restype = i32
    lib.int8_conv_launch.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, i32] + [i32] * 6 + [ptr]

    def run(x, wq, a, ks, bias, out_dtype):
        n, h, w, cin = x.shape
        cout = wq.shape[0]
        y = torch.empty((n, h, w, cout), dtype=out_dtype, device=x.device)
        rc = lib.int8_conv_launch(x.data_ptr(), int(x.dtype == torch.bfloat16), wq.data_ptr(),
                                  a.data_ptr(), ks.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                  int(out_dtype == torch.bfloat16), n, h, w, cin, cout, 0,
                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other int8_conv failed to launch ({rc})")
        return y
    return run


def run(other_dir: str, device) -> list:
    other = other_k10(kernels.build_other(os.path.join(other_dir, "int8_conv.cu"), "int8_conv"))
    g = torch.Generator(device=device).manual_seed(14)
    results = []
    with torch.no_grad():
        for name, cin, cout, s in INT8_LAYERS:
            xd = torch.float32 if cin == 3 else torch.bfloat16
            x, wq, a, ks, bias = operands(g, device, N, s, cin, cout, xd)
            args = (x, wq, a, ks, bias, torch.bfloat16)
            if not torch.equal(other(*args), ic.int8_conv(*args)):
                raise AssertionError(f"{name}: this build's y differs from the other's")
            other_ms, ms = turns(lambda: other(*args), lambda: ic.int8_conv(*args))
            xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)
            wc = wq.to(torch.bfloat16).permute(0, 3, 1, 2)
            cudnn_ms = median_ms_device(lambda: F.conv2d(xc, wc, padding=1))
            ops = 2 * N * s * s * 9 * cin * cout
            out = {"name": name, "cin": cin, "cout": cout, "size": s,
                   "path": ic.kernel_path(N, s, s, cin, cout, xd), "other_ms": other_ms,
                   "ms": ms, "cudnn_bf16_ms": cudnn_ms, "ops": ops,
                   **bound_ms(layer_bytes(N, s, cin, cout, x.element_size(), 2), ops,
                              PEAK_INT8_OPS)}
            print(f"k10 {name} {cin}->{cout} at {s}x{s} [{out['path']}]: other {other_ms:.3f} ms, "
                  f"this {ms:.3f} ms ({ops / ms / 1e9:.1f} TOP/s, {other_ms / ms:.2f}x), cuDNN "
                  f"bf16 conv alone {cudnn_ms:.3f} ms, bound {out['bound_ms']:.3f} ms "
                  f"({out['bound_by']})", flush=True)
            results.append(out)
            del x, wq, xc, wc, args
    total = {k: sum(r[k] for r in results) for k in ("other_ms", "ms", "cudnn_bf16_ms",
                                                      "bound_ms", "ops")}
    print(f"k10 the {len(results)} layers: other {total['other_ms']:.3f} ms, this "
          f"{total['ms']:.3f} ms ({total['ops'] / total['ms'] / 1e9:.1f} TOP/s, "
          f"{total['other_ms'] / total['ms']:.2f}x), cuDNN bf16 conv alone "
          f"{total['cudnn_bf16_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms", flush=True)
    return results


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda("int8_conv_against")
    if len(argv) != 1:
        raise SystemExit("usage: python -m ...scripts.int8_conv_against OTHER_KERNELS_DIR")
    print(card())
    return run(argv[0], device)


if __name__ == "__main__":
    main()
