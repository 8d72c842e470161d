"""conv3x3 SAME filter gradient (dW): the CUDA kernel's wrapper and its plain
version.

Counterpart of the JAX package's ``scripts/proto_pallas_dw.py``
(``dw_pallas`` :137-166 with its Pallas kernel ``_dw_kernel`` :54-133, plain
version ``dw_xla`` :181-186). For x [H, W, N, Ci] and g [H, W, N, Co], the
TPU kernel's batch-inside layout::

    dW[ky, kx, ci, co] = sum_{h, w, n} x[h+ky-1, w+kx-1, n, ci] * g[h, w, n, co]

with x zero outside the image (SAME padding); dW float32 [3, 3, Ci, Co], the
HWIO gradient of ``conv3x3_same(x, w)`` for the cotangent g.

``conv3x3_dw`` dispatches on the device of ``x``: CUDA tensors go to the
hand-written kernel (``kernels/conv_dw.cu``), CPU tensors to
``conv3x3_dw_reference``. A CUDA call launches the kernel or raises; it never
falls back.

The TPU kernel's row/column band ``TH`` x ``TW`` and its two formulations
(``taps9``: nine (P, Ci) x (P, Co) products a band; ``x3g3``: one
(P, 3 Ci) x (P, 3 Co) product of stacked shifts) are accepted and checked as
the TPU checks them (``H % TH == 0``, ``W % TW == 0``), and give the same
numbers: the CUDA kernel picks its own tiles. It computes the nine taps as
one GEMM of M = 9 Ci rows (tap, ci) by Co over all H*W*N pixels: bf16
operands on the tensor cores (wgmma, both operands straight from their
[H, W, N, C] layout by TMA, the image edge and ragged tails zero-filled by
the copy), float32 accumulation, each CTA one range of pixels, the ranges
summed by a second kernel in a fixed order (see the source); float32
operands stay float32 (CUDA cores). No padded copy is made.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# Kernel launches since import (or since the caller last reset it): a run can
# show that its main path went through the kernel. Only the CUDA branch of
# conv3x3_dw adds to it, once per launch.
launches = 0

VARIANTS = ("taps9", "x3g3")

# The kernel's (ci, co) output tile: it takes Ci and Co in multiples of it.
TILE = 64

_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        lib = kernels.load("conv_dw")
        lib.conv_dw_tile.restype = ctypes.c_int
        lib.conv_dw_tile.argtypes = []
        lib.conv_dw_splits.restype = ctypes.c_int
        lib.conv_dw_splits.argtypes = [ctypes.c_int] * 6
        lib.conv_dw_launch.restype = ctypes.c_int
        lib.conv_dw_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.conv_dw_error_string.restype = ctypes.c_char_p
        lib.conv_dw_error_string.argtypes = [ctypes.c_int]
        if lib.conv_dw_tile() != TILE:
            raise RuntimeError("conv_dw kernel library has an unexpected tile; "
                               "delete kernels/_build/")
        _lib = lib
    return _lib


def _check_args(x: torch.Tensor, g: torch.Tensor, TH: int, TW: int, variant: str) -> None:
    if x.ndim != 4 or g.ndim != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"x [H, W, N, Ci] and g [H, W, N, Co] must agree on H, W, N: "
                         f"got {tuple(x.shape)} and {tuple(g.shape)}")
    h, w = x.shape[0], x.shape[1]
    if TH < 1 or TW < 1 or h % TH or w % TW:
        raise ValueError(f"H % TH and W % TW must be 0, got H={h}, W={w}, TH={TH}, TW={TW}")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def conv3x3_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device: the weight gradient of a
    SAME conv3x3 (``torch.nn.grad.conv2d_weight``, cuDNN on the card) on the
    NCHW views of the [H, W, N, C] operands, in their dtype, TF32 off; float32
    [3, 3, Ci, Co]. (bf16 operands give a bf16 gradient, rounded once, as
    ``dw_xla``'s bf16 conv VJP does.)"""
    ci, co = x.shape[-1], g.shape[-1]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        dw = torch.nn.grad.conv2d_weight(x.permute(2, 3, 0, 1), (co, ci, 3, 3),
                                         g.permute(2, 3, 0, 1), padding=1)
    return dw.permute(2, 3, 1, 0).float()


def _check_cuda_inputs(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32) or g.dtype != x.dtype:
        raise TypeError(f"the kernel takes bf16 or float32 x and g of one dtype, "
                        f"got {x.dtype} and {g.dtype}")
    ci, co = x.shape[-1], g.shape[-1]
    if ci % TILE or co % TILE:
        raise ValueError(f"the kernel takes Ci and Co in multiples of {TILE}, "
                         f"got Ci={ci}, Co={co}")
    for name, t in (("x", x), ("g", g)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous [H, W, N, C]")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on x's device and current stream."""
    _check_cuda_inputs(x, g)
    lib = _kernel()
    h, w, n, ci = x.shape
    co = g.shape[-1]
    is_bf16 = int(x.dtype == torch.bfloat16)
    splits = lib.conv_dw_splits(h, w, n, ci, co, is_bf16)
    partials = torch.empty((splits, 3, 3, ci, co), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, ci, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv_dw_launch(x.data_ptr(), g.data_ptr(), is_bf16, h, w, n, ci, co,
                                partials.data_ptr(), dw.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("conv_dw kernel launch failed: " + lib.conv_dw_error_string(rc).decode())
    global launches
    launches += 1
    return dw


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor, TH: int = 8, TW: int = 8,
               variant: str = "taps9") -> torch.Tensor:
    """dW [3, 3, Ci, Co] float32 of a SAME conv3x3 from x [H, W, N, Ci] and
    the cotangent g [H, W, N, Co].

    ``TH``, ``TW`` and ``variant`` are the TPU kernel's, checked as it checks
    them; the CUDA kernel picks its own tiles (module docstring)."""
    _check_args(x, g, TH, TW, variant)
    if x.device.type == "cpu":
        return conv3x3_dw_reference(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_dw runs on CUDA or CPU tensors, got {x.device}")
    return _launch(x, g)
