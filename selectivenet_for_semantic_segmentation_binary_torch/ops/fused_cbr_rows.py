"""Fused CBR with a staged halo tile (forward only): the CUDA kernel's wrapper,
its plain version and the conv-alone baseline.

Counterpart of the JAX package's ``scripts/proto_fused_cbr.py``
(``fused_cbr`` :107-160 with its Pallas kernel ``_fused_cbr_kernel``
:42-103, plain version ``xla_chain`` :168-182, baseline ``xla_conv_only``
:186-192). The function is that of ``ops/fused_cbr.py``::

    y     = conv3x3_same(relu(x * a + b), w) + bias     # prologue fused
    stats = [sum(y), sum(y^2)]  over N, H, W            # epilogue fused

but the kernel is a design of its own (``kernels/fused_cbr_rows.cu``): the
normalised input of a band of rows, halo included, is staged once in shared
memory and the nine taps run from there, so the prologue is applied about
twice per input element (per 64 output channels), not once per tap.

``fused_cbr`` dispatches on the device of ``x``: CUDA tensors go to the
kernel (bf16 x and w), CPU tensors to ``fused_cbr_reference``. A CUDA call
launches the kernel or raises; it never falls back. ``rows`` is the TPU
kernel's row band and is checked as it checks it (``H % rows == 0``); the
CUDA kernel picks its own tile of 2 rows x 64 columns (4 x 32 where W <= 32)
x 64 output channels, walking Cin in chunks of 32. There is no gradient: the
prototype is forward only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import fused_cbr as fc

# Kernel launches since import (or since the caller last reset it): a run can
# show that its main path went through the kernel. Only the CUDA branch of
# fused_cbr adds to it, once per launch.
launches = 0

# Output channels of a CTA and input channels of a chunk: the kernel takes
# Cin % TILE_K == 0 and Cout % TILE_N == 0.
TILE_N, TILE_K = 64, 32

_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        lib = kernels.load("fused_cbr_rows")
        for name in ("fused_cbr_rows_tile_n", "fused_cbr_rows_tile_k"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        lib.fused_cbr_rows_tiles_m.restype = ctypes.c_int64
        lib.fused_cbr_rows_tiles_m.argtypes = [ctypes.c_int] * 3
        lib.fused_cbr_rows_launch.restype = ctypes.c_int
        lib.fused_cbr_rows_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.fused_cbr_rows_error_string.restype = ctypes.c_char_p
        lib.fused_cbr_rows_error_string.argtypes = [ctypes.c_int]
        if (lib.fused_cbr_rows_tile_n(), lib.fused_cbr_rows_tile_k()) != (TILE_N, TILE_K):
            raise RuntimeError("fused_cbr_rows kernel library has unexpected tile "
                               "sizes; delete kernels/_build/")
        _lib = lib
    return _lib


# The plain version (``xla_chain``'s counterpart) is fused_conv_stats': the
# two kernels compute one function.
fused_cbr_reference = fc.fused_conv_stats_reference


def conv_only(xn: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The baseline without prologue or stats (``xla_conv_only``): y =
    conv3x3_same(xn, w) + bias in xn's dtype, cuDNN with the bias fused on
    the card; NHWC out (a channels_last view)."""
    y = F.conv2d(xn.permute(0, 3, 1, 2), w.to(xn.dtype).permute(3, 2, 0, 1),
                 bias.to(xn.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


def _check_rows(x: torch.Tensor, rows: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got shape {tuple(x.shape)}")
    if rows < 1 or x.shape[1] % rows:
        raise ValueError(f"H % rows must be 0, got H={x.shape[1]}, rows={rows}")


def _check_cuda_inputs(x, a, b, w, bias) -> None:
    """Types raise TypeError; shapes, devices, layout and the channel gate
    are fused_conv_stats' checks (ValueError)."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 x and w, got {x.dtype} and {w.dtype}")
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    fc._check_cuda_inputs(x, a, b, w, bias, TILE_K, TILE_N)


def _launch(x, a, b, w, bias, apply_prologue: bool):
    """One launch of the kernel on x's device and current stream."""
    _check_cuda_inputs(x, a, b, w, bias)
    lib = _kernel()
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    partials = torch.empty((2, cout, lib.fused_cbr_rows_tiles_m(n, h, wd)),
                           dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_cbr_rows_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(),
            int(apply_prologue), n, h, wd, cin, cout, y.data_ptr(),
            partials.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("fused_cbr_rows kernel launch failed: "
                           + lib.fused_cbr_rows_error_string(rc).decode())
    global launches
    launches += 1
    return y, stats


def fused_cbr(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor, rows: int = 8, apply_prologue: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = conv3x3_same(relu(x*a + b), w) + bias;  stats = [sum(y), sum(y^2)].

    Args:
        x: (N, H, W, Cin), contiguous: the RAW previous-layer conv output
           (prologue on) or an already-normalised input (prologue off).
        a, b: (Cin,) float32 prologue affine.
        w: (3, 3, Cin, Cout) HWIO. bias: (Cout,) float32.
        rows: the TPU kernel's row band; H % rows must be 0.
    Returns:
        (y (N, H, W, Cout) in x's dtype, stats (2, Cout) float32).
    """
    _check_rows(x, rows)
    if x.device.type == "cpu":
        return fused_cbr_reference(x, a, b, w, bias, apply_prologue)
    if x.device.type != "cuda":
        raise ValueError(f"fused_cbr runs on CUDA or CPU tensors, got {x.device}")
    return _launch(x, a, b, w, bias, apply_prologue)
