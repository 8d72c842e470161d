"""Fused CBR in the transposed (H, Cin, W, N) layout (forward only): the CUDA
kernel's two wrappers, their plain version and the NHWC baselines.

Counterpart of the JAX package's ``scripts/proto_transposed_cbr.py``
(``transposed_fused_cbr`` :123-171 with its Pallas kernel ``_kernel``
:49-118, ``transposed_fused_cbr_v2`` :219-285 with ``_kernel2`` :181-214,
``xla_conv_only`` :292-296, ``xla_chain`` :299-308). The function is that of
``ops/fused_cbr.py``::

    y     = conv3x3_same(relu(x * a + b), w) + bias     # prologue fused
    stats = [sum(y), sum(y^2)]  over H, W, N            # epilogue fused

with x (H, Cin, W, N) and y (H, Cout, W, N): the sample index is the minor
dimension. Both wrappers launch one kernel, ``kernels/transposed_cbr.cu``:
the TPU's two designs differ only in where the TPU does the dx shift (on
the input side for v1, on the output side with the stacked-M dot of
``_kernel2`` for v2), and on Hopper the shift is a whole-block view of the
staged row either way. So v1 and v2 give the same y and stats, bit for bit;
each wrapper keeps its own launch count. ``kernel_path`` names the path a
call takes: TMA-fed ``wgmma`` where N % 8 == 0, else the element-by-element
copy of the earlier wmma design.

The port's v2 differs from the JAX v2 in one place. The JAX wrapper pads x
in HBM and fills the pad ring with (-1 - b_c) / a_c, which the prologue
maps to relu(-1) = 0; where |a_c| <= 1e-12 it fills 0 instead
(proto_transposed_cbr.py:231-232), and the prologue then maps the ring to
relu(b_c), which leaks into the border outputs whenever b_c > 0. The port
keeps the halo zero after the affine for every a, as v1 and ``fused_cbr``
do: the kernel's copies zero-fill the halo and the prologue runs only
inside the image, with no padded copy of x.

Each wrapper dispatches on the device of ``x``: CUDA tensors go to the
kernel (bf16 x and w), CPU tensors to ``transposed_fused_cbr_reference``. A
CUDA call launches the kernel or raises; it never falls back. ``rows`` and
``w_blk`` are the TPU kernels' row band and column block and are checked as
they check them (``H % rows == 0``, ``W % w_blk == 0``); the CUDA kernel
picks its own tile (64 output channels x 2 columns x 64 samples of one
output row), walking Cin in chunks of 64 (a last one of 32). ``vmem_mb`` is
the TPU's VMEM limit, accepted and ignored.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import fused_cbr as fc
from . import fused_cbr_rows as fr

# Kernel launches since import (or since the caller last reset them), one
# count for each design: a run can show that its path went through the
# kernel. Only the CUDA branches add to them, once per launch.
launches_v1 = 0
launches_v2 = 0

# Output channels of a tile and the input-channel step: the kernel takes
# Cin % TILE_K == 0 and Cout % TILE_N == 0.
TILE_N, TILE_K = 64, 32

_lib: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``transposed_cbr.cu`` build on ``lib``
    (this checkout's, or another commit's with the same launcher)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("transposed_cbr_tile_n", "transposed_cbr_tile_k"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = []
    lib.transposed_cbr_tiles_m.restype = ctypes.c_int64
    lib.transposed_cbr_tiles_m.argtypes = [i32] * 3
    lib.transposed_cbr_launch.restype = i32
    lib.transposed_cbr_launch.argtypes = [ptr] * 5 + [i32] * 7 + [ptr] * 4
    lib.transposed_cbr_error_string.restype = ctypes.c_char_p
    lib.transposed_cbr_error_string.argtypes = [i32]
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        lib = bind(kernels.load("transposed_cbr"))
        lib.transposed_cbr_path.restype = ctypes.c_int
        lib.transposed_cbr_path.argtypes = [ctypes.c_int]
        if (lib.transposed_cbr_tile_n(), lib.transposed_cbr_tile_k()) != (TILE_N, TILE_K):
            raise RuntimeError("transposed_cbr kernel library has unexpected tile sizes; "
                               "delete kernels/_build/")
        _lib = lib
    return _lib


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(H, C, W, N) -> (N, H, W, C), a view."""
    return x.permute(3, 0, 2, 1)


def from_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (H, C, W, N), a view."""
    return x.permute(1, 3, 2, 0)


def transposed_fused_cbr_reference(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                                   w: torch.Tensor, bias: torch.Tensor,
                                   apply_prologue: bool = True
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on any device: the NHWC view of x through
    ``fused_conv_stats_reference``, y permuted back (a contiguous copy)."""
    y, stats = fc.fused_conv_stats_reference(to_nhwc(x), a, b, w, bias, apply_prologue)
    return from_nhwc(y).contiguous(), stats


# ``xla_conv_only`` and ``xla_chain``'s counterparts, on NHWC tensors as there
conv_only = fr.conv_only
chain = fc.fused_conv_stats_reference


def check_blocks(x: torch.Tensor, rows: int, w_blk: int) -> None:
    """The TPU kernels' checks of their blocks: H % rows == 0, W % w_blk == 0."""
    if x.ndim != 4:
        raise ValueError(f"x must be (H, Cin, W, N), got shape {tuple(x.shape)}")
    h, _, wd, _ = x.shape
    if rows < 1 or h % rows or w_blk < 1 or wd % w_blk:
        raise ValueError(f"H % rows and W % w_blk must be 0, got H={h}, rows={rows}, "
                         f"W={wd}, w_blk={w_blk}")


def _check_cuda_inputs(x, a, b, w, bias) -> None:
    """Types raise TypeError; shapes, devices, layout, alignment and the
    channel gate ValueError."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 x and w, got {x.dtype} and {w.dtype}")
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    _, cin, _, _ = x.shape
    cout = w.shape[-1]
    shapes = {"a": (a, (cin,)), "b": (b, (cin,)), "w": (w, (3, 3, cin, cout)),
              "bias": (bias, (cout,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for name, t in (("x", x), ("a", a), ("b", b), ("w", w), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (x in (H, Cin, W, N))")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if cin % TILE_K or cout % TILE_N:
        raise ValueError(f"the kernel takes Cin % {TILE_K} == 0 and Cout % {TILE_N} == 0, "
                         f"got Cin={cin}, Cout={cout}")


def run_kernel(lib: ctypes.CDLL, x, a, b, w, bias, apply_prologue: bool, stacked_m: bool):
    """One launch of ``lib``'s kernel (a ``bind``-ed build) on checked inputs,
    on x's device and current stream. Counts nothing."""
    h, cin, wd, n = x.shape
    cout = w.shape[-1]
    y = torch.empty((h, cout, wd, n), dtype=x.dtype, device=x.device)
    partials = torch.empty((2, cout, lib.transposed_cbr_tiles_m(h, wd, n)),
                           dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.transposed_cbr_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), bias.data_ptr(),
            int(stacked_m), int(apply_prologue), h, cin, wd, n, cout, y.data_ptr(),
            partials.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("transposed_cbr kernel launch failed: "
                           + lib.transposed_cbr_error_string(rc).decode())
    return y, stats


def _launch(x, a, b, w, bias, apply_prologue: bool, stacked_m: bool):
    """One launch of the kernel on x's device and current stream, counted."""
    _check_cuda_inputs(x, a, b, w, bias)
    y, stats = run_kernel(_kernel(), x, a, b, w, bias, apply_prologue, stacked_m)
    global launches_v1, launches_v2
    if stacked_m:
        launches_v2 += 1
    else:
        launches_v1 += 1
    return y, stats


def kernel_path(x: torch.Tensor) -> str:
    """Which path a call on x (H, Cin, W, N) takes: ``"tma"`` (the TMA-fed
    wgmma kernel, N % 8 == 0) or ``"element"`` (the element-by-element copy)
    on a CUDA x, ``"plain"`` (``transposed_fused_cbr_reference``) on a CPU
    one."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type != "cuda":
        raise ValueError(f"kernel_path takes CUDA or CPU tensors, got {x.device}")
    return "tma" if _kernel().transposed_cbr_path(x.shape[3]) else "element"


def _dispatch(x, a, b, w, bias, rows, w_blk, apply_prologue, stacked_m):
    check_blocks(x, rows, w_blk)
    if x.device.type == "cpu":
        return transposed_fused_cbr_reference(x, a, b, w, bias, apply_prologue)
    if x.device.type != "cuda":
        raise ValueError(f"transposed_fused_cbr runs on CUDA or CPU tensors, got {x.device}")
    return _launch(x, a, b, w, bias, apply_prologue, stacked_m)


def transposed_fused_cbr(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, rows: int = 4, w_blk: int = 32,
                         apply_prologue: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """v1: y = conv3x3_same(relu(x*a + b), w) + bias; stats = [sum(y), sum(y^2)].

    Args:
        x: (H, Cin, W, N), contiguous: the RAW previous-layer conv output
           (prologue on) or an already-normalised input (prologue off).
        a, b: (Cin,) float32 prologue affine.
        w: (3, 3, Cin, Cout) HWIO. bias: (Cout,) float32.
        rows, w_blk: the TPU kernel's blocks; H % rows and W % w_blk must be 0.
    Returns:
        (y (H, Cout, W, N) in x's dtype, stats (2, Cout) float32).
    """
    return _dispatch(x, a, b, w, bias, rows, w_blk, apply_prologue, stacked_m=False)


def transposed_fused_cbr_v2(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                            w: torch.Tensor, bias: torch.Tensor, rows: int = 4,
                            w_blk: int = 16, apply_prologue: bool = True,
                            vmem_mb: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """v2 (stacked-M dot, output-side shift): ``transposed_fused_cbr``'s
    function and arguments; the halo stays zero after the affine for every
    a (module docstring). ``vmem_mb`` is ignored."""
    del vmem_mb
    return _dispatch(x, a, b, w, bias, rows, w_blk, apply_prologue, stacked_m=True)
