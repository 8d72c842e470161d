"""Fused CBR with a staged, normalised halo band (forward only): the
wrapper, its plain version and the conv-alone baseline.

Counterpart of the JAX package's ``scripts/proto_fused_cbr.py``
(``fused_cbr`` :107-160 with its Pallas kernel ``_fused_cbr_kernel``
:42-103, plain version ``xla_chain`` :168-182, baseline ``xla_conv_only``
:186-192). The function is that of ``ops/fused_cbr.py``::

    y     = conv3x3_same(relu(x * a + b), w) + bias     # prologue fused
    stats = [sum(y), sum(y^2)]  over N, H, W            # epilogue fused

and so is the kernel: the prototype's idea, the normalised input of a band
of rows, halo included, staged once in shared memory, the prologue applied
once per element and the nine taps run from there, is the design of
``kernels/fused_conv_stats.cu``. ``_launch`` runs that kernel through
``fused_cbr.run_kernel``, at Cin % 32 == 0 (a last chunk of 32 channels,
zero-filled past Cin) where the trunk's gate asks for Cin % 64.

``fused_cbr`` dispatches on the device of ``x``: CUDA tensors go to the
kernel (bf16 x and w), CPU tensors to ``fused_cbr_reference``. A CUDA call
launches the kernel or raises; it never falls back. ``rows`` is the TPU
kernel's row band and is checked as it checks it (``H % rows == 0``); the
CUDA kernel picks its own tiles. There is no gradient: the prototype is
forward only.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import fused_cbr as fc

# Kernel launches since import (or since the caller last reset it): a run can
# show that its main path went through the kernel. Only the CUDA branch of
# fused_cbr adds to it, once per launch.
launches = 0

# Output channels of the kernel's unit and the input channels it takes a
# multiple of: Cin % TILE_K == 0 and Cout % TILE_N == 0.
TILE_N, TILE_K = fc.TILE_N, fc.CIN_STEP


def __getattr__(name: str):
    # ``_lib``, K3's kernel library, is fused_cbr's: None until a CUDA call
    # loads it
    if name == "_lib":
        return fc._lib
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# The plain version (``xla_chain``'s counterpart) is fused_conv_stats': the
# two TPU kernels compute one function, and one CUDA kernel serves both.
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
    """One launch of the band kernel on x's device and current stream,
    counted here (not in ``fused_cbr.launches``)."""
    _check_cuda_inputs(x, a, b, w, bias)
    y, stats = fc.run_kernel(x, a, b, w, bias, apply_prologue)
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
