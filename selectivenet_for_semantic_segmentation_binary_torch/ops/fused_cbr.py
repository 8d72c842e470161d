"""Fused CBR: conv3x3 with a BatchNorm-apply prologue and a BatchNorm-statistics
epilogue. The CUDA kernel's wrapper, its plain version and its gradient.

Counterpart of the JAX package's ``ops/fused_cbr.py:98-288`` (Pallas kernel
``_fwd_kernel``, wrapper ``fused_conv_stats``, custom VJP ``_fcs_bwd``,
``moments_from_stats``, ``bn_affine``). In one pass over x::

    y     = conv3x3_same(relu(x * a + b), w) + bias     # prologue fused
    stats = [sum(y), sum(y^2)]  over N, H, W            # epilogue fused

where ``(a, b)`` is the previous layer's BatchNorm folded with its batch (or
running) statistics, and ``stats`` are the sums this layer's BatchNorm needs
(var = E[y^2] - E[y]^2, flax's fast variance). Layouts are the JAX
package's: x and y NHWC, w HWIO; the model hands over the NHWC view of its
channels_last activations, which costs no copy.

``fused_conv_stats`` dispatches on the device of ``x``: CUDA tensors go to
the hand-written kernel (``kernels/fused_conv_stats.cu``, bf16 only), CPU
tensors to ``fused_conv_stats_reference``. A CUDA call launches the kernel
or raises; it never falls back. Which layers take the kernel is the
model's choice, through ``eligible`` (the JAX gate's name): bf16 operands
and channel counts the kernel takes. The JAX ``eligible()`` also budgets
the TPU's VMEM and ``choose_rows()`` picks a v5e row block; neither is
carried over.

The backward is not a kernel, as in the JAX package (XLA's conv VJP there):
``_FusedConvStats.backward`` folds the stats cotangent into dy, recomputes
xn, runs the conv backward in x's dtype (cuDNN on the card,
``aten.convolution_backward``) and the ReLU mask and affine gradients in
float32 PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# Kernel launches since import (or since the caller last reset it): a run can
# show that its main path went through the kernel. Only the CUDA branch of
# fused_conv_stats adds to it, once per launch.
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        lib = kernels.load("fused_conv_stats")
        for name in ("fused_conv_stats_tile_n", "fused_conv_stats_tile_k",
                     "fused_conv_stats_cin_step"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        lib.fused_conv_stats_tiles_m.restype = ctypes.c_int64
        lib.fused_conv_stats_tiles_m.argtypes = [ctypes.c_int] * 4
        lib.fused_conv_stats_launch.restype = ctypes.c_int
        lib.fused_conv_stats_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.fused_conv_stats_error_string.restype = ctypes.c_char_p
        lib.fused_conv_stats_error_string.argtypes = [ctypes.c_int]
        if (lib.fused_conv_stats_tile_n(), lib.fused_conv_stats_tile_k(),
                lib.fused_conv_stats_cin_step()) != (TILE_N, TILE_K, CIN_STEP):
            raise RuntimeError("fused_conv_stats kernel library has unexpected "
                               "tile sizes; delete kernels/_build/")
        _lib = lib
    return _lib


# The kernel's unit of output channels (a tile is 128 of them, or 64) and
# the input channels of one chunk: the trunk takes it at Cin % TILE_K == 0 and
# Cout % TILE_N == 0 (``kernel_takes``). The kernel itself also takes a last
# chunk of CIN_STEP channels (Cin % 32 == 0), zero-filled past Cin; the
# staged-band prototype (``fused_cbr_rows``) launches it so. Its tiles' pixel
# count (8 samples x 8 columns x 2 rows, or 4 rows where Cout is not a
# multiple of 128) sizes only the partial sums, which
# ``fused_conv_stats_tiles_m`` counts.
TILE_N, TILE_K = 64, 64
CIN_STEP = 32


def kernel_takes(cin: int, cout: int) -> bool:
    """Whether the kernel takes these channel counts (every trunk conv but
    the first, whose Cin is the image's 3 channels)."""
    return cin % TILE_K == 0 and cout % TILE_N == 0


def eligible(cin: int, cout: int, dtype: torch.dtype) -> bool:
    """Whether a layer runs the kernel (the JAX ``FusedCBR``'s
    ``eligible()``, models/unet.py:512-546): bf16 operands, which are all the
    kernel takes, and channel counts it takes. A float32 layer runs
    ``fused_conv_stats_reference``, the same dataflow in plain PyTorch, as
    the JAX layer runs its XLA branch where ``eligible()`` says no."""
    return dtype == torch.bfloat16 and kernel_takes(cin, cout)


def fused_conv_stats_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                               w: torch.Tensor, bias: torch.Tensor,
                               apply_prologue: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, on any device, differentiable by autograd.

    The prologue in float32, rounded to x's dtype; ``F.conv2d`` in x's dtype;
    the bias added in float32 and y rounded to x's dtype; float32 sums of the
    rounded y. (In bf16 the conv output rounds before the bias is added, the
    kernel rounds once after it: the two differ by up to an ulp of the conv
    output and of y.)"""
    if apply_prologue:
        xn = torch.relu(x.float() * a.float() + b.float()).to(x.dtype)
    else:
        xn = x
    y = F.conv2d(xn.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    y = (y.permute(0, 2, 3, 1).float() + bias.float()).to(x.dtype).contiguous()
    yf = y.float()
    stats = torch.stack([yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
    return y, stats


def _check_cuda_inputs(x, a, b, w, bias, tile_k: int = TILE_K, tile_n: int = TILE_N) -> None:
    """What a fused-CBR kernel refuses: anything but contiguous, aligned bf16
    x and w and float32 a, b, bias of matching shapes, with Cin % tile_k == 0
    and Cout % tile_n == 0."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 x and w, got {x.dtype} and {w.dtype}")
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got shape {tuple(x.shape)}")
    _, _, _, cin = x.shape
    cout = w.shape[-1]
    shapes = {"a": (a, (cin,)), "b": (b, (cin,)), "w": (w, (3, 3, cin, cout)),
              "bias": (bias, (cout,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("a", a), ("b", b), ("w", w), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x in NHWC)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if cin % tile_k or cout % tile_n:
        raise ValueError(f"the kernel takes Cin % {tile_k} == 0 and Cout % {tile_n} == 0, "
                         f"got Cin={cin}, Cout={cout}")


def run_kernel(x, a, b, w, bias, apply_prologue: bool):
    """One launch of the kernel on x's device and current stream, for inputs
    that passed ``_check_cuda_inputs`` with a tile_k of TILE_K or CIN_STEP.
    Counts nothing: each wrapper that launches it keeps its own count."""
    lib = _kernel()
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    tiles = lib.fused_conv_stats_tiles_m(n, h, wd, cout)
    partials = torch.empty((2, cout, tiles), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_conv_stats_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(),
            int(apply_prologue), n, h, wd, cin, cout, y.data_ptr(),
            partials.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("fused_conv_stats kernel launch failed: "
                           + lib.fused_conv_stats_error_string(rc).decode())
    return y, stats


def _launch(x, a, b, w, bias, apply_prologue: bool):
    """One launch of the kernel at the trunk's gate (Cin % TILE_K), counted."""
    _check_cuda_inputs(x, a, b, w, bias)
    y, stats = run_kernel(x, a, b, w, bias, apply_prologue)
    global launches
    launches += 1
    return y, stats


def _forward(x, a, b, w, bias, apply_prologue: bool):
    if x.device.type == "cpu":
        return fused_conv_stats_reference(x, a, b, w, bias, apply_prologue)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_stats runs on CUDA or CPU tensors, got {x.device}")
    return _launch(x, a, b, w, bias, apply_prologue)


class _FusedConvStats(torch.autograd.Function):
    """y, stats = fused_conv_stats(...) with the JAX package's VJP
    (``_fcs_bwd``, ops/fused_cbr.py:231-269)."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias, apply_prologue: bool):
        y, stats = _forward(x, a, b, w, bias, apply_prologue)
        ctx.save_for_backward(x, a, b, w, y)
        ctx.apply_prologue = apply_prologue
        return y, stats

    @staticmethod
    def backward(ctx, ybar, sbar):
        x, a, b, w, y = ctx.saved_tensors
        # stats = [sum(y), sum(y*y)] contribute sbar0 + 2*y*sbar1 to dy
        ybar_eff = ybar.float() + sbar[0] + 2.0 * y.float() * sbar[1]
        bias_bar = ybar_eff.sum((0, 1, 2))
        if ctx.apply_prologue:
            pre = x.float() * a + b
            xn = torch.relu(pre).to(x.dtype)
        else:
            xn = x
        # dx and dw by the conv backward in x's dtype, the cotangent cast to
        # it (fused_cbr.py:254-255); NCHW views of the NHWC tensors
        w_oihw = w.to(x.dtype).permute(3, 2, 0, 1)
        dxn, dw, _ = torch.ops.aten.convolution_backward(
            ybar_eff.to(x.dtype).permute(0, 3, 1, 2), xn.permute(0, 3, 1, 2), w_oihw,
            None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
        dxn = dxn.permute(0, 2, 3, 1).float()
        if ctx.apply_prologue:
            dpre = dxn * (pre > 0)
            x_bar = (dpre * a).to(x.dtype)
            a_bar = (dpre * x.float()).sum((0, 1, 2))
            b_bar = dpre.sum((0, 1, 2))
        else:
            x_bar = dxn.to(x.dtype)
            a_bar = torch.zeros_like(a)
            b_bar = torch.zeros_like(b)
        return x_bar, a_bar, b_bar, dw.permute(2, 3, 1, 0).to(w.dtype), bias_bar, None


def fused_conv_stats(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor, apply_prologue: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = conv3x3_same(relu(x*a + b), w) + bias;  stats = [sum(y), sum(y^2)].

    Args:
        x: (N, H, W, Cin), contiguous: the RAW previous-layer conv output
           (prologue on) or an already-normalised input (prologue off).
        a, b: (Cin,) float32 prologue affine; ignored when ``apply_prologue``
           is False (pass ones and zeros).
        w: (3, 3, Cin, Cout) HWIO kernel in x's dtype. bias: (Cout,) float32.
    Returns:
        (y (N, H, W, Cout) in x's dtype, stats (2, Cout) float32), with
        gradients through both.
    """
    return _FusedConvStats.apply(x, a, b, w, bias, apply_prologue)


def moments_from_stats(stats: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) from [sum, sumsq] over n elements: flax's fast-variance
    math (var = E[x^2] - E[x]^2, clipped at 0)."""
    mean = stats[0] / n
    var = torch.clamp(stats[1] / n - mean * mean, min=0.0)
    return mean, var


def bn_affine(gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN(mean, var, gamma, beta) into (a, b): BN(x) = x * a + b."""
    a = gamma.float() * torch.rsqrt(var.float() + eps)
    b = beta.float() - mean.float() * a
    return a, b
