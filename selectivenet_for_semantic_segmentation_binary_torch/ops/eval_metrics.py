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
neither is its float32-per-tile counting: the kernel counts in integers and
finishes the six int64 counts in the same launch (its last CTA sums the
per-CTA rows), so a call is one kernel launch. ``kernel_path`` names the
path a call takes: 16-byte loads where the three pointers are 16-byte
aligned, else element by element.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

# Kernel launches since import (or since the caller last reset it): a run can
# show that its main path went through the kernel. Only the CUDA branch of
# fused_eval_metrics adds to it, once per launch.
launches = 0

_lib: Optional[ctypes.CDLL] = None
# The kernel's ticket counters, one zeroed uint32 for each (device, stream):
# launches that share one run in order, and each leaves it at 0.
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of an ``eval_metrics.cu`` build on ``lib``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.eval_metrics_counters.restype = i32
    lib.eval_metrics_counters.argtypes = []
    lib.eval_metrics_grid.restype = i32
    lib.eval_metrics_grid.argtypes = [ctypes.c_int64]
    lib.eval_metrics_vector_path.restype = i32
    lib.eval_metrics_vector_path.argtypes = [ptr] * 3
    lib.eval_metrics_launch.restype = i32
    lib.eval_metrics_launch.argtypes = [
        ptr, ptr, ptr, i32, ctypes.c_int64, i32, i32, ctypes.c_float, ctypes.c_float,
        ptr, ptr, ptr, ptr,
    ]
    lib.eval_metrics_error_string.restype = ctypes.c_char_p
    lib.eval_metrics_error_string.argtypes = [i32]
    if lib.eval_metrics_counters() != 6:
        raise RuntimeError("eval_metrics kernel library has an unexpected "
                           "counter layout; delete kernels/_build/")
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        _lib = bind(kernels.load("eval_metrics"))
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
    tot = run_kernel(_kernel(), output, label, selection if selective else None,
                     apply_sigmoid, cut_off, s_cut_off)
    global launches
    launches += 1
    return _pack(tot[:4], tot[4], tot[5])


def run_kernel(lib: ctypes.CDLL, output: torch.Tensor, label: torch.Tensor,
               selection: Optional[torch.Tensor], apply_sigmoid: bool, cut_off: float,
               s_cut_off: float) -> torch.Tensor:
    """One launch of ``lib``'s kernel (a ``bind``-ed build) on checked CUDA
    inputs, on the current stream; selective where ``selection`` is given.
    Returns the six int64 counts (cm00 cm01 cm10 cm11 reject valid). Counts
    nothing: the wrapper keeps the count."""
    n = output.numel()
    partials = torch.empty((lib.eval_metrics_grid(n), 6), dtype=torch.int64,
                           device=output.device)
    out = torch.empty(6, dtype=torch.int64, device=output.device)
    with torch.cuda.device(output.device):
        stream = torch.cuda.current_stream().cuda_stream
        key = (output.device.index, stream)
        ticket = _tickets.get(key)
        if ticket is None:  # zeroed once; each launch leaves it at 0
            ticket = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=output.device)
        rc = lib.eval_metrics_launch(
            output.data_ptr(), None if selection is None else selection.data_ptr(),
            label.data_ptr(), label.element_size(), n, int(apply_sigmoid),
            int(selection is not None), cut_off, s_cut_off, partials.data_ptr(),
            ticket.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("eval_metrics kernel launch failed: "
                           + lib.eval_metrics_error_string(rc).decode())
    return out


def kernel_path(output: torch.Tensor, label: torch.Tensor,
                selection: Optional[torch.Tensor] = None) -> str:
    """Which path a ``fused_eval_metrics`` call on these tensors takes:
    ``"vector"`` (16-byte loads of whole 256-pixel warp steps, the tail
    element by element) or ``"element"`` of the kernel on CUDA tensors, ``"plain"``
    (``eval_metrics_reference``) on CPU ones. ``selection``: as the call
    passes it (None when not selective)."""
    if output.device.type == "cpu":
        return "plain"
    if output.device.type != "cuda":
        raise ValueError(f"kernel_path takes CUDA or CPU tensors, got {output.device}")
    vec = _kernel().eval_metrics_vector_path(
        output.data_ptr(), None if selection is None else selection.data_ptr(),
        label.data_ptr())
    return "vector" if vec else "element"
