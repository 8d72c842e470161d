"""Per-channel BatchNorm statistics of a 64-channel activation: the CUDA
kernel's wrapper and its plain version.

Counterpart of the JAX package's ``scripts/proto_bn_stats.py``
(``pallas_bn_stats`` :47-61 with its Pallas kernel ``_stats_kernel`` :32-43,
plain version ``xla_bn_stats`` :65-67). For x (N, H, W, 64)::

    sum   = sum over N, H, W of x          (float32, per channel)
    sumsq = sum over N, H, W of x * x

``bn_stats`` dispatches on the device of ``x``: CUDA tensors go to the
hand-written kernel (``kernels/bn_stats.cu``, bf16 only), CPU tensors to
``bn_stats_reference``. A CUDA call launches the kernel or raises; it never
falls back. The TPU kernel's grid of ``N*H*W/2 // 1024`` steps silently
drops the tail rows when N*H*W/2 is not a multiple of 1024; the kernel here
sums every row. Like the TPU kernel it takes 64 channels and no other count.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# Kernel launches since import (or since the caller last reset it): a run can
# show that its main path went through the kernel. Only the CUDA branch of
# bn_stats adds to it, once per launch.
launches = 0

C = 64

_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        lib = kernels.load("bn_stats")
        lib.bn_stats_channels.restype = ctypes.c_int
        lib.bn_stats_channels.argtypes = []
        lib.bn_stats_ctas.restype = ctypes.c_int
        lib.bn_stats_ctas.argtypes = [ctypes.c_int64]
        lib.bn_stats_launch.restype = ctypes.c_int
        lib.bn_stats_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p]
        lib.bn_stats_error_string.restype = ctypes.c_char_p
        lib.bn_stats_error_string.argtypes = [ctypes.c_int]
        if lib.bn_stats_channels() != C:
            raise RuntimeError("bn_stats kernel library has an unexpected channel "
                               "count; delete kernels/_build/")
        _lib = lib
    return _lib


def _check_shape(x: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[-1] != C:
        raise ValueError(f"bn_stats takes x of shape (N, H, W, {C}), got {tuple(x.shape)}")


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, on any device: float32 sums of x and x*x
    over every pixel, as ``xla_bn_stats`` computes them."""
    _check_shape(x)
    flat = x.float().reshape(-1, C)
    return flat.sum(0), (flat * flat).sum(0)


def _check_cuda_inputs(x: torch.Tensor) -> None:
    _check_shape(x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (N, H, W, 64)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if x.numel() == 0:
        raise ValueError("x is empty")


def _launch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on x's device and current stream."""
    _check_cuda_inputs(x)
    lib = _kernel()
    m = x.numel() // C
    partials = torch.empty((2, C, lib.bn_stats_ctas(m)), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bn_stats_launch(x.data_ptr(), m, partials.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("bn_stats kernel launch failed: "
                           + lib.bn_stats_error_string(rc).decode())
    global launches
    launches += 1
    return stats[0], stats[1]


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sumsq): float32 (64,) each, over the N, H and W of x (N, H, W, 64).

    On a CUDA tensor (bf16, contiguous) the kernel; on a CPU tensor the
    plain version."""
    if x.device.type == "cpu":
        return bn_stats_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats runs on CUDA or CPU tensors, got {x.device}")
    return _launch(x)
