"""The int8 (W8A8) 3x3 conv of the int8 paths: the CUDA kernel's wrapper,
its plain version, and the QAT conv (``Int8STEConv``).

K10 has no Pallas original: it stands where the JAX package runs an XLA
int8 convolution (``lax.conv_general_dilated`` with
``preferred_element_type=int32``) in ``models/unet.py``: the W8A8 serving
CBR (:315-327, static activation scale) and ``_qat_fwd_math`` (:221-240,
dynamic scales, the forward of ``int8_ste_conv`` :243-278). For x (N, H, W,
Cin) NHWC in bf16 or float32, w_q (Cout, 3, 3, Cin) int8, the activation
scale ``a`` (a one-element float32 tensor on x's device) and the weight
scales ``ks`` (Cout,)::

    q   = clamp(round(float(x) * (1 / a)), -127, 127)      (half to even)
    acc = conv3x3(q, w_q)  (SAME, int32, exact)
    static:  y = relu(float(acc) * (a * ks) + bias)  in ``out_dtype``
    dynamic: y = float(acc) * (a * ks)                float32

every product and sum rounded once, in that order. ``int8_conv``
dispatches on the device of x: CUDA tensors go to the hand-written kernel
(``kernels/int8_conv.cu``), CPU tensors to ``int8_conv_reference``. A CUDA
call launches the kernel or raises; it never falls back. The source holds
three kernels, and the shape alone chooses among them (``kernel_path``):
the ``wgmma`` kernel (TMA, each staged input element quantized once a CTA,
``wgmma`` s8) wherever Cin % 32 == 0 and its window fits the shared
memory, the ``wgmma_im2col`` kernel for the first layer (Cin <= 3: RGB's 3,
GH's 2), the first design's ``mma_sync`` kernel for the rest.

``Int8STEConv`` is JAX's ``int8_ste_conv``: the dynamic-scale forward
(``qat_scales`` computes the scales and the int8 weights on the device, so
no value crosses to the host) and the straight-through backward, the float
conv's dX and dW evaluated in bf16 from the saved float residuals (JAX
``_int8_ste_bwd``). Those two stay cuDNN's, as JAX leaves them to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_

# Kernel launches since import (or since the caller last reset it): a run can
# show that its main path went through the kernel. Only the CUDA branch of
# int8_conv adds to it, once per launch.
launches = 0

QMAX = 127.0
QAT_EPS = 1e-8  # _qat_fwd_math's floor of the dynamic absmax scales

_lib: Optional[ctypes.CDLL] = None

# kernels/int8_conv.cu's wgmma kernel: its stage depth, positions of a
# warpgroup's tile, raw ring, epilogue and barrier bytes, and a CTA's
# shared memory on an H100 (kSmemCap)
_QC, _POS, _RAW_BYTES, _RAW_SLOTS, _EPI_BYTES, _BAR_BYTES, _SMEM_CAP = (
    32, 256, 16384, 3, 8 * 2048, 128, 232448)


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        lib = kernels.load("int8_conv")
        lib.int8_conv_launch.restype = ctypes.c_int
        lib.int8_conv_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.int8_conv_error_string.restype = ctypes.c_char_p
        lib.int8_conv_error_string.argtypes = [ctypes.c_int]
        lib.int8_conv_path.restype = ctypes.c_int
        lib.int8_conv_path.argtypes = [ctypes.c_int] * 6
        _lib = lib
    return _lib


def _check_shapes(x: torch.Tensor, w_q: torch.Tensor, ks: torch.Tensor,
                  bias: Optional[torch.Tensor], dynamic: bool) -> None:
    if x.ndim != 4 or w_q.ndim != 4 or tuple(w_q.shape[1:3]) != (3, 3):
        raise ValueError(f"int8_conv takes x (N, H, W, Cin) and w_q (Cout, 3, 3, Cin), got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    if w_q.shape[3] != x.shape[3]:
        raise ValueError(f"w_q has Cin {w_q.shape[3]}, x has {x.shape[3]}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    cout = w_q.shape[0]
    if tuple(ks.shape) != (cout,) or (bias is not None and tuple(bias.shape) != (cout,)):
        raise ValueError(f"ks and bias must be ({cout},)")
    if not dynamic and bias is None:
        raise ValueError("the static epilogue takes a bias")


def wgmma_smem(w: int, cout: int) -> int:
    """The wgmma kernel's dynamic shared memory at width W and Cout (its
    ``wgeo().smem``): two weight slots of 9 x 32 x 64 cw bytes, the raw
    ring, the window's 2 buffers x 2 planes, the epilogue, the barriers and
    1 KB for the alignment; cw = 2 where Cout % 128 == 0, else 1, and the
    window L = 256 (3 - cw) + 2 (W + 2) + 2 positions."""
    cw = 2 if cout % 128 == 0 else 1
    window = _POS * (3 - cw) + 2 * (w + 2) + 2
    plane = -(-16 * window // 128) * 128 + 64
    return (2 * 9 * _QC * 64 * cw + _RAW_SLOTS * _RAW_BYTES + 4 * plane + _EPI_BYTES
            + _BAR_BYTES + 1024)


def im2col_smem(w: int) -> int:
    """The im2col kernel's (``wgeo_im2col().smem``): 64 x 32 bytes of
    weights, a word a window position (L = 512 + 2 (W + 2) + 2), the two
    planes of the 512 positions' im2col rows, the epilogue and 1 KB."""
    window = 2 * _POS + 2 * (w + 2) + 2
    return 64 * _QC + -(-4 * window // 128) * 128 + 2 * (16 * 2 * _POS + 64) + _EPI_BYTES + 1024


def kernel_path(n: int, h: int, w: int, cin: int, cout: int,
                x_dtype: torch.dtype = torch.bfloat16) -> str:
    """Which of the source's three kernels a CUDA call at this shape runs,
    from the shape alone (``int8_conv_path`` in the source is the same
    rule): ``"wgmma_im2col"`` where Cin <= 3 (the first layer: one im2col
    k32 step), ``"wgmma"`` where Cin % 32 == 0 and the window fits the
    shared memory, ``"mma_sync"`` (the first design) for the rest; and
    ``"mma_sync"`` wherever N H W >= 2^31 - 256 or (H + 4)(W + 2) + 2048 >=
    2^31 (int32 coordinates). ``x_dtype`` (bf16 or float32) only sizes the
    TMA boxes, which hold 16 KB either way."""
    if x_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bf16 or float32 x, got {x_dtype}")
    if n * h * w > 2 ** 31 - 1 - 256 or (h + 4) * (w + 2) + 2048 > 2 ** 31 - 1:
        return "mma_sync"
    if cin <= 3:
        return "wgmma_im2col" if im2col_smem(w) <= _SMEM_CAP else "mma_sync"
    if cin % _QC or wgmma_smem(w, cout) > _SMEM_CAP:
        return "mma_sync"
    return "wgmma"


def quantize_input(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The prologue: x -> clamp(round(float(x) * (1 / a)), -127, 127), the
    int8 levels as float32 values; 1 / a in float32."""
    return torch.clamp(torch.round(x.float() * (1.0 / a.float())), -QMAX, QMAX)


def int8_conv_sums(q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The integer conv of the plain version: int8 levels q (N, H, W, Cin),
    as any dtype, and w_q (Cout, 3, 3, Cin) -> the SAME 3x3 sums (N, H, W,
    Cout) int32, by ``F.conv2d`` in float64: every partial sum is an integer
    below 127 * 127 * 9 * Cin < 2^53, so it is exact in any order."""
    with torch.autocast(device_type=q.device.type, enabled=False):
        acc = F.conv2d(q.permute(0, 3, 1, 2).double().contiguous(),
                       w_q.permute(0, 3, 1, 2).double().contiguous(), padding=1)
    return acc.to(torch.int32).permute(0, 2, 3, 1)


def int8_conv_reference(x: torch.Tensor, w_q: torch.Tensor, a: torch.Tensor,
                        ks: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.float32,
                        dynamic: bool = False) -> torch.Tensor:
    """The plain PyTorch version, on any device: the prologue with
    ``torch.round``, the exact integer conv (``int8_conv_sums``), then the
    epilogue in float32, one rounding an operation, in the kernel's order.
    Autocast is off inside."""
    _check_shapes(x, w_q, ks, bias, dynamic)
    with torch.autocast(device_type=x.device.type, enabled=False):
        acc = int8_conv_sums(quantize_input(x, a), w_q)
        y = acc.float() * (a.float() * ks.float())
        if dynamic:
            return y.contiguous()
        return torch.relu(y + bias.float()).to(out_dtype).contiguous()


def _launch(x: torch.Tensor, w_q: torch.Tensor, a: torch.Tensor, ks: torch.Tensor,
            bias: Optional[torch.Tensor], out_dtype: torch.dtype, dynamic: bool) -> torch.Tensor:
    """One launch of the kernel on x's device and current stream."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bf16 or float32 x, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32) or (dynamic and out_dtype != torch.float32):
        raise TypeError(f"the kernel writes bf16 or float32 (float32 when dynamic), "
                        f"got {out_dtype}")
    n, h, w, cin = x.shape
    cout = w_q.shape[0]
    if cout % 8:
        raise ValueError(f"the kernel takes Cout % 8 == 0, got {cout}")
    if x.numel() == 0:
        raise ValueError("x is empty")
    x = x.contiguous()
    w_q = w_q.contiguous()
    scales = [a.reshape(1), ks, bias if bias is not None else ks]
    for t in (x, w_q, *scales):
        if t.device != x.device:
            raise ValueError(f"every operand must lie on {x.device}, got {t.device}")
    a_, ks_, bias_ = (t.float().contiguous() for t in scales)
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("x and w_q must be 16-byte aligned")
    y = torch.empty((n, h, w, cout), dtype=out_dtype, device=x.device)
    lib = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.int8_conv_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w_q.data_ptr(), a_.data_ptr(),
            ks_.data_ptr(), bias_.data_ptr(), y.data_ptr(), int(out_dtype == torch.bfloat16),
            n, h, w, cin, cout, int(dynamic), stream)
    if rc != 0:
        raise RuntimeError("int8_conv kernel launch failed: "
                           + lib.int8_conv_error_string(rc).decode())
    global launches
    launches += 1
    return y


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, a: torch.Tensor, ks: torch.Tensor,
              bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32,
              dynamic: bool = False) -> torch.Tensor:
    """(N, H, W, Cout) NHWC: the static epilogue (``bias`` given, ReLU, in
    ``out_dtype``) or, with ``dynamic``, the float32 dequantised sums.

    On CUDA tensors (x bf16 or float32, Cout % 8 == 0) the kernel; on CPU
    tensors the plain version."""
    if x.device.type == "cpu":
        return int8_conv_reference(x, w_q, a, ks, bias, out_dtype, dynamic)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv runs on CUDA or CPU tensors, got {x.device}")
    _check_shapes(x, w_q, ks, bias, dynamic)
    return _launch(x, w_q, a, ks, bias, out_dtype, dynamic)


def qat_scales(x: torch.Tensor, weight: torch.Tensor, pg=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX ``_qat_fwd_math``'s dynamic scales, on x's device: ``a =
    max(absmax(x), 1e-8) * (1/127)`` (a 0-dim float32 tensor), ``ks`` the
    same per output channel of the OIHW float ``weight``, and the int8
    weights ``clamp(round(w * (1 / ks)), -127, 127)`` laid out (Cout, 3, 3,
    Cin). The absmax of x comes from ``aminmax``: exact, and no float32
    copy of a bf16 x. It reduces the NHWC view, which is contiguous for the
    channels_last x of the trunk: ``aminmax`` of the NCHW view flattens it
    first, a copy of x (2.4 ms a layer at batch 128 on an H100). On a fleet
    (``pg``, x this rank's rows) the absmax is the max over the ranks', the
    global batch's, as JAX's ``jnp.max`` is over its batch-sharded jit; the
    weights are the same on every rank."""
    lo, hi = torch.aminmax(x.permute(0, 2, 3, 1))
    m = torch.maximum(-lo, hi).float()
    if pg is not None:
        m = all_reduce_(m.reshape(1), pg, "max").reshape(())
    a = torch.clamp_min(m, QAT_EPS) * (1.0 / QMAX)
    kf = weight.float()
    ks = torch.clamp_min(kf.abs().amax(dim=(1, 2, 3)), QAT_EPS) * (1.0 / QMAX)
    kq = torch.clamp(torch.round(kf * (1.0 / ks)[:, None, None, None]), -QMAX, QMAX)
    return a, ks, kq.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def qat_conv_forward(x: torch.Tensor, weight: torch.Tensor, pg=None) -> torch.Tensor:
    """The QAT conv's forward: x (N, Cin, H, W) in channels_last memory, any
    float dtype, and the float OIHW weight -> float32 (N, Cout, H, W) in
    channels_last memory, the dynamic-scale int8 conv (K10's dynamic
    variant on the card); ``pg``: ``qat_scales``'."""
    a, ks, kq = qat_scales(x, weight, pg)
    y = int8_conv(x.permute(0, 2, 3, 1), kq, a, ks, dynamic=True)
    return y.permute(0, 3, 1, 2)


class Int8STEConv(torch.autograd.Function):
    """JAX ``int8_ste_conv``: the dynamic int8 W8A8 forward, and as backward
    the float conv's gradients in bf16 (the straight-through estimator:
    rounding and clipping contribute none). dX is cast to x's dtype and dW
    to the weight's, as JAX casts them. ``pg``: the fleet's process group,
    whose global absmax scales x (``qat_scales``); None for one process."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, pg=None) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        return qat_conv_forward(x, weight, pg)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight = ctx.saved_tensors
        gb, wb = g.bfloat16(), weight.bfloat16()
        dx = dw = None
        with torch.autocast(device_type=g.device.type, enabled=False):
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(x.shape, wb, gb, padding=1).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(x.bfloat16(), weight.shape, gb,
                                                 padding=1).to(weight.dtype)
        return dx, dw, None
