"""The 1x1 conv heads of a U-Net on their shared input, forward and
backward in one kernel pair (K11): the wrapper, its plain version and its
dispatch rule.

K11 has no Pallas original: it stands where the JAX package leaves the
heads' 1x1 convs to XLA (``models/unet.py``: ``Head`` :421-439, the
``_heads`` of ``UNetB`` and ``UNet``). Stack the heads' weights into W (K,
Cin) and their biases into b (K), the K output channels of all heads in
order (UNet_B selective: conv1x1, conv_select, conv_aux, K = 3; UNet_B: K =
1; UNet selective: n_cls + 2 + n_cls). For feat (N, Cin, H, W), in the
compute dtype (``compute_dtype``: autocast's, as autocast hands the
operands to a conv, else feat's), over its NHWC pixels p::

    logit[p, k] = dtype(sum_c feat[p, c] W[k, c] + b[k])   (float32 sums; W, b rounded to dtype)
    dfeat[p, c] = dtype(sum_k g[p, k] W[k, c])              (float32 sums)
    dW[k, c]    = sum_p feat[p, c] g[p, k],  db[k] = sum_p g[p, k]   (float32)

from the float32 gradients g of the logits; the logits are returned as
float32, one (N, H, W, k_j) array a head. The roundings pass the gradient
through unchanged, as autocast's casts do. ``sel_heads`` runs the kernels
(``kernels/sel_heads.cu``) on CUDA tensors and raises outside
``kernel_takes``; ``sel_heads_reference`` is the plain version, for tests
and timings. The model (``models.unet``) calls ``apply_heads``, which takes
the kernels where ``runs_kernel`` holds and each ``Head`` module's own conv
elsewhere, so their parameters and state-dict keys are unchanged. On a
card the ``Head`` convs run in two cases, each call counted in
``bypasses``: heads of more than 8 channels together (selective UNet with
``n_cls`` >= 4), or a feat outside the rule's Cin or dtype. Under
``torch.compile``/``torch.export`` (which cannot trace a ``ctypes`` call)
they run uncounted: a traced graph holds the ``Head`` convs.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

# Calls of the forward and of the backward kernel pair since import (or since
# the caller last reset them): a run can show that its main path went through
# the kernels. Only the CUDA branch adds to them.
launches_fwd = 0
launches_bwd = 0
# Calls of ``apply_heads`` on a CUDA tensor, outside tracing, that ran the
# ``Head`` convs because the kernels do not take the shape or dtype.
bypasses = 0

MAX_K = 8  # output channels of all heads together (the source's kMaxK)

_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        lib = kernels.load("sel_heads")
        ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        lib.sel_heads_max_k.restype = ctypes.c_int
        lib.sel_heads_max_k.argtypes = []
        lib.sel_heads_ctas.restype = ctypes.c_int
        lib.sel_heads_ctas.argtypes = [ctypes.c_int64]
        lib.sel_heads_forward.restype = ctypes.c_int
        lib.sel_heads_forward.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int, ptrs, ptrs, ptrs, ints,
                                          ctypes.c_void_p]
        lib.sel_heads_backward.restype = ctypes.c_int
        lib.sel_heads_backward.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_int, ctypes.c_int, ptrs,
                                           ptrs, ints, ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p]
        lib.sel_heads_error_string.restype = ctypes.c_char_p
        lib.sel_heads_error_string.argtypes = [ctypes.c_int]
        if lib.sel_heads_max_k() != MAX_K:
            raise RuntimeError("sel_heads kernel library has an unexpected MAX_K; "
                               "delete kernels/_build/")
        _lib = lib
    return _lib


def kernel_takes(cin: int, k: int, dtype: torch.dtype) -> bool:
    """The dispatch rule, on shape and dtype alone (the source's launchers
    refuse the rest with ``cudaErrorInvalidValue``): bf16 or float32, 1 <= K <= 8, Cin % 8 == 0 with a
    pixel row of whole 16-byte pieces, a power of two of them and at most
    32 (one a lane of a warp): Cin in 8-256 (bf16) or 8-128 (float32)."""
    if dtype not in (torch.bfloat16, torch.float32) or not 1 <= k <= MAX_K or cin % 8:
        return False
    pieces = cin * (2 if dtype == torch.bfloat16 else 4) // 16
    return pieces <= 32 and pieces & (pieces - 1) == 0


def compute_dtype(feat: torch.Tensor) -> torch.dtype:
    """The dtype a conv on feat computes in here: autocast's where it is on
    for feat's device and would cast feat, else feat's own."""
    dev = feat.device.type
    if (feat.dtype != torch.float64 and torch.amp.is_autocast_available(dev)
            and torch.is_autocast_enabled(dev)):
        return torch.get_autocast_dtype(dev)
    return feat.dtype


def runs_kernel(feat: torch.Tensor, heads: Sequence[nn.Conv2d]) -> bool:
    """Whether ``sel_heads`` on feat takes the kernels: a CUDA tensor, not
    under ``torch.compile``/``torch.export`` (which cannot trace a ``ctypes``
    call), and ``kernel_takes``."""
    return (feat.device.type == "cuda" and not torch.compiler.is_compiling()
            and kernel_takes(feat.shape[1], sum(h.out_channels for h in heads),
                             compute_dtype(feat)))


def _ste(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to dtype and widened back, the gradient passed through
    unchanged."""
    if dtype == torch.float32:
        return t
    return t + (t.to(dtype).float() - t).detach()


def sel_heads_reference(feat: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """The plain PyTorch version, on any device, differentiable by autograd:
    each head's 1x1 conv as a float32 matmul over the NHWC pixels (so that
    no TF32 enters on a card, where cuDNN's convs take it by default) of
    feat rounded to ``dtype`` and the weights and bias rounded to ``dtype``
    (their gradients unrounded), each logit rounded to ``dtype``; the
    (N, H, W, k_j) float32 logits of each head. The gradient of feat is
    rounded to ``dtype``, then to feat's dtype, as the kernel's is."""
    with torch.autocast(device_type=feat.device.type, enabled=False):
        x = feat.to(dtype).float().permute(0, 2, 3, 1)
        outs = []
        for w, b in zip(weights, biases):
            wf = _ste(w.float(), dtype).reshape(w.shape[0], -1)
            y = torch.matmul(x, wf.t()) + _ste(b.float(), dtype)
            outs.append(_ste(y, dtype).contiguous())
        return outs


def check_kernel_inputs(x: torch.Tensor, widths: Sequence[int]) -> None:
    """The kernel's checks of x (N, H, W, Cin) NHWC and the heads' widths;
    raises on what it does not take."""
    if x.ndim != 4:
        raise ValueError(f"sel_heads takes x (N, H, W, Cin), got {tuple(x.shape)}")
    k = sum(widths)
    if not kernel_takes(x.shape[3], k, x.dtype):
        raise ValueError(f"the kernel does not take Cin {x.shape[3]}, K {k} in {x.dtype} "
                         "(kernel_takes: bf16 or float32, K <= 8, Cin % 8 == 0 and a "
                         "power of two of 16-byte pieces up to 32)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (feat in channels_last memory)")
    if x.numel() == 0:
        raise ValueError("x is empty")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def _channels(tensors: Sequence[torch.Tensor], widths: Sequence[int], step: int):
    """Per output channel k (a head's channel c): its pointer in the head's
    tensor, whose rows are ``step`` floats apart per channel (weights: Cin;
    biases and NHWC logits: 1), and the channel stride of the logits."""
    ptrs, strides = [], []
    for t, kj in zip(tensors, widths):
        for c in range(kj):
            ptrs.append(None if t is None else t.data_ptr() + 4 * c * step)
            strides.append(kj)
    arr = (ctypes.c_void_p * MAX_K)(*ptrs)
    return arr, (ctypes.c_int * MAX_K)(*strides)


def _float32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()


def _stream(x: torch.Tensor) -> int:
    with torch.cuda.device(x.device):
        return torch.cuda.current_stream().cuda_stream


class _SelHeads(torch.autograd.Function):
    """The kernel pair behind autograd: x (N, H, W, Cin) NHWC in the compute
    dtype, then each head's weight and bias."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, widths: Tuple[int, ...], *params: torch.Tensor):
        check_kernel_inputs(x, widths)
        n, h, w, cin = x.shape
        weights = [_float32(p) for p in params[0::2]]
        biases = [_float32(p) for p in params[1::2]]
        for t in (*weights, *biases):
            if t.device != x.device:
                raise ValueError(f"every operand must lie on {x.device}, got {t.device}")
        outs = [torch.empty((n, h, w, kj), dtype=torch.float32, device=x.device)
                for kj in widths]
        w_ptrs, _ = _channels(weights, widths, cin)
        b_ptrs, _ = _channels(biases, widths, 1)
        o_ptrs, strides = _channels(outs, widths, 1)
        lib = _kernel()
        rc = lib.sel_heads_forward(x.data_ptr(), int(x.dtype == torch.bfloat16), n * h * w, cin,
                                   sum(widths), w_ptrs, b_ptrs, o_ptrs, strides, _stream(x))
        if rc != 0:
            raise RuntimeError("sel_heads forward kernel launch failed: "
                               + lib.sel_heads_error_string(rc).decode())
        global launches_fwd
        launches_fwd += 1
        ctx.widths = widths
        ctx.save_for_backward(x, *weights)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads: Optional[torch.Tensor]):
        x, *weights = ctx.saved_tensors
        widths = ctx.widths
        n, h, w, cin = x.shape
        k = sum(widths)
        g = [None if t is None else t.to(torch.float32).contiguous() for t in grads]
        lib = _kernel()
        dx = torch.empty_like(x)
        partials = torch.empty((k * cin + k, lib.sel_heads_ctas(n * h * w)),
                               dtype=torch.float32, device=x.device)
        dwb = torch.empty(k * cin + k, dtype=torch.float32, device=x.device)
        w_ptrs, _ = _channels(weights, widths, cin)
        g_ptrs, strides = _channels(g, widths, 1)
        rc = lib.sel_heads_backward(x.data_ptr(), dx.data_ptr(), int(x.dtype == torch.bfloat16),
                                    n * h * w, cin, k, w_ptrs, g_ptrs, strides,
                                    partials.data_ptr(), dwb.data_ptr(), _stream(x))
        if rc != 0:
            raise RuntimeError("sel_heads backward kernel launch failed: "
                               + lib.sel_heads_error_string(rc).decode())
        global launches_bwd
        launches_bwd += 1
        # float32 dW and db; autograd casts them to a parameter's own dtype
        dw, db = dwb[:k * cin].view(k, cin), dwb[k * cin:]
        dparams, start = [], 0
        for kj in widths:
            dparams += [dw[start:start + kj].view(kj, cin, 1, 1), db[start:start + kj]]
            start += kj
        return (dx, None, *dparams)


def sel_heads(feat: torch.Tensor, heads: Sequence[nn.Conv2d]) -> List[torch.Tensor]:
    """Each 1x1 conv head of ``heads`` (Cin -> k_j, with bias) on feat
    (N, Cin, H, W): its float32 logits (N, H, W, k_j), computed in
    ``compute_dtype(feat)`` and differentiable in feat and every head's
    weight and bias.

    One forward and one backward launch for all heads; raises on a tensor
    that is not on CUDA or outside ``kernel_takes``."""
    if feat.device.type != "cuda":
        raise ValueError(f"sel_heads runs on CUDA tensors, got {feat.device}")
    x = feat.to(compute_dtype(feat)).permute(0, 2, 3, 1).contiguous()
    params = [p for h in heads for p in (h.weight, h.bias)]
    return list(_SelHeads.apply(x, tuple(h.out_channels for h in heads), *params))


def apply_heads(feat: torch.Tensor, heads: Sequence[nn.Conv2d]) -> List[torch.Tensor]:
    """The model's heads on feat (N, Cin, H, W): each head's float32 logits
    (N, H, W, k_j), from the kernels where ``runs_kernel`` holds, else from
    each ``Head``'s own conv (counted in ``bypasses`` on a card outside
    tracing)."""
    if runs_kernel(feat, heads):
        return sel_heads(feat, heads)
    if feat.device.type == "cuda" and not torch.compiler.is_compiling():
        global bypasses
        bypasses += 1
    return [h(feat).permute(0, 2, 3, 1).float() for h in heads]
