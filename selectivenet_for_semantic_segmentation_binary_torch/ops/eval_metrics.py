"""Fused binary eval metrics: the CUDA kernel's wrapper and its plain version.

Counterpart of the JAX package's ``ops/pallas_metrics.py`` (Pallas kernel
``_metrics_kernel`` :44-95, wrapper ``fused_eval_metrics`` :98-160). In one
pass over the (N, H, W) logit maps it computes: optional sigmoid of
``output`` and ``selection``; ``pred = p > cut_off``; ``sel = g > s_cut_off``;
``valid = 0 <= label < 2``; the 2x2 confusion counts over valid & sel,
``n_reject`` over valid & ~sel and ``n_pix`` over valid. Thresholds are a
strict ``>`` on float32 values (reference eval.py:179).

``fused_eval_metrics`` dispatches on the tensors' device: CUDA tensors go to
the hand-written kernel (``kernels/eval_metrics.cu``), CPU tensors to
``eval_metrics_reference``. A CUDA call launches the kernel or raises; it
never falls back. The Pallas kernel's padding to (rows, 128) lanes and its
(1, 8, 128) partial block exist only for Mosaic and are not carried over;
neither is its float32-per-tile counting: the kernel counts in int32 per
block and the partials are summed here in int64.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

# Kernel launches since import (or since the caller last reset it): a run can
# show that its main path went through the kernel. Only the CUDA branch of
# fused_eval_metrics adds to it, once per launch.
launches = 0

# Elements per block: 16 per thread at 256 threads. Far below 2^31, so the
# kernel's int32 counters cannot overflow.
PER_BLOCK = 4096

_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        lib = kernels.load("eval_metrics")
        lib.eval_metrics_counters.restype = ctypes.c_int
        lib.eval_metrics_counters.argtypes = []
        lib.eval_metrics_launch.restype = ctypes.c_int
        lib.eval_metrics_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.eval_metrics_error_string.restype = ctypes.c_char_p
        lib.eval_metrics_error_string.argtypes = [ctypes.c_int]
        if lib.eval_metrics_counters() != 6:
            raise RuntimeError("eval_metrics kernel library has an unexpected "
                               "counter layout; delete kernels/_build/")
        _lib = lib
    return _lib


def _pack(cm4: torch.Tensor, n_reject: torch.Tensor,
          n_pix: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"cm": cm4.reshape(2, 2), "n_reject": n_reject, "n_pix": n_pix}


def eval_metrics_reference(output: torch.Tensor, label: torch.Tensor,
                           selection: Optional[torch.Tensor] = None, *,
                           apply_sigmoid: bool = True, selective: bool = False,
                           cut_off: float = 0.5,
                           s_cut_off: float = 0.5) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device.

    Returns ``{"cm": (2, 2) int64, "n_reject": int64, "n_pix": int64}``.
    A Python-float cut-off is compared in float32, as in the kernel."""
    prob = output.float()
    if apply_sigmoid:
        prob = torch.sigmoid(prob)
    pred = prob > cut_off
    valid = (label >= 0) & (label < 2)
    if selective:
        if selection is None:
            raise ValueError("selective=True needs a selection map")
        g = selection.float()
        if apply_sigmoid:
            g = torch.sigmoid(g)
        sel = g > s_cut_off
        counted = valid & sel
        n_reject = (valid & ~sel).sum()
    else:
        counted = valid
        n_reject = torch.zeros((), dtype=torch.int64, device=output.device)
    pos = label == 1
    cm4 = torch.stack([
        (counted & ~pos & ~pred).sum(),
        (counted & ~pos & pred).sum(),
        (counted & pos & ~pred).sum(),
        (counted & pos & pred).sum(),
    ])
    return _pack(cm4, n_reject, valid.sum())


def _check_cuda_inputs(output, label, selection, selective: bool) -> None:
    tensors = [("output", output), ("label", label)]
    if selective:
        if selection is None:
            raise ValueError("selective=True needs a selection map")
        tensors.append(("selection", selection))
    for name, t in tensors:
        if t.device != output.device:
            raise ValueError(f"{name} is on {t.device}, output on {output.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != output.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"output {tuple(output.shape)}")
    if output.dtype != torch.float32 or (selective and selection.dtype != torch.float32):
        raise ValueError("output and selection must be float32")
    if label.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"label must be uint8 or int32, got {label.dtype}")


def fused_eval_metrics(output: torch.Tensor, label: torch.Tensor,
                       selection: Optional[torch.Tensor] = None, *,
                       apply_sigmoid: bool = True, selective: bool = False,
                       cut_off: float = 0.5,
                       s_cut_off: float = 0.5) -> Dict[str, torch.Tensor]:
    """Fused binary eval metrics of one batch.

    Args:
        output: (N, H, W) float32 prediction logits or scores.
        label: (N, H, W) uint8 or int32 labels; PAD_LABEL marks padding.
        selection: (N, H, W) float32 selection logits when ``selective``.
    Returns:
        ``{"cm": (2, 2) int64, "n_reject": int64, "n_pix": int64}`` tensors
        on the input's device.
    """
    if output.device.type == "cpu":
        return eval_metrics_reference(
            output, label, selection, apply_sigmoid=apply_sigmoid,
            selective=selective, cut_off=cut_off, s_cut_off=s_cut_off)
    if output.device.type != "cuda":
        raise ValueError(f"fused_eval_metrics runs on CUDA or CPU tensors, "
                         f"got {output.device}")
    _check_cuda_inputs(output, label, selection, selective)
    lib = _kernel()
    n = output.numel()
    blocks = max(1, -(-n // PER_BLOCK))
    partials = torch.empty((blocks, 6), dtype=torch.int32, device=output.device)
    sel_ptr = selection.data_ptr() if selective else output.data_ptr()
    with torch.cuda.device(output.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eval_metrics_launch(
            output.data_ptr(), sel_ptr, label.data_ptr(), label.element_size(),
            n, int(apply_sigmoid), int(selective), cut_off, s_cut_off,
            PER_BLOCK, blocks, partials.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("eval_metrics kernel launch failed: "
                           + lib.eval_metrics_error_string(rc).decode())
    global launches
    launches += 1
    tot = partials.sum(0, dtype=torch.int64)
    return _pack(tot[:4], tot[4], tot[5])
