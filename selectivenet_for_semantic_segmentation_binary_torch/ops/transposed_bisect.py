"""The Mosaic-bisection kernels of the transposed (H, C, W, N) fused CBR: the
CUDA kernels' wrappers and their plain versions.

Counterparts of the JAX package's ``scripts/bisect_transposed.py`` (K7:
variants ``v1``..``v5`` :29-135), ``scripts/bisect_transposed2.py`` (K8:
``make`` :15-34 with bodies ``a``..``e`` :45-72) and
``scripts/bisect_transposed3.py`` (K9: ``build`` :82-109 with ``_kernel``
:18-79 and the 14 ``CASES`` :112-142). Each was a minimal Pallas kernel
that bisected which feature of the transposed CBR crashed the TPU compiler;
each computes a small function of the padded input, written out here (xp
is the (H+2, C, W+2, N) padded input, (H+2, C, W+8, N) for v5; outputs are
(H, C, W, N) bf16):

- crop (K7 v1, v2, v5): ``xp[h+1, :, w+1, :]``;
- shifted sum in float32 (K7 v4: ``sum_dx xp[h+1, :, w+dx]``; K8 a:
  ``sum_dy xp[h+dy, :, w+1]``), or with each add rounded to bf16 (K8 b,
  whose body adds bf16 rows);
- stacked dot in float32 (K7 v3, K8 c, e: ``W[:, dy*C:(dy+1)*C] @
  xp[h+dy, :, w+1]`` summed over dy; K8 d: ``W[:, 0:C] @ xp[h+1, :, w+1]``);
- K9: ``sum_dx (sum_dy W[0][:, kb(dy)*C:...] @ src[h+dy, :, w+dx])`` with
  dy 0..2 (``merge_dot``) or 1, dx 0..2 (``shift``) or 0, and src the
  scratch copy of xp: bf16(relu(xp * 1.1 + 0.1)) (``prologue``), with row 0
  and column 0 zeroed (``zero_ring``: the TPU kernel zeroes the top row of
  the first row block and the left column of the first column block only).
  Without ``shift`` the kernel reads the block's columns 0..WBLK-1, which
  shifts the output one column left of the shifted sum's centre. ``stats``
  sums y per channel into row 0 of a (2, C) output (True, "2d") or of an
  (8, 128) one ("pad"). Where ``stats`` is off the TPU kernel never writes
  its stats output; the port returns zeros there.

Each wrapper dispatches on the device of ``x``: CUDA tensors go to
``kernels/transposed_bisect.cu`` (bf16 only), CPU tensors to the plain
version; a CUDA call launches the kernel or raises. Each script has its own
launch counter. The kernels copy 16-byte vectors where N % 8 == 0 and the
pointers are aligned, else element by element (``kernel_path``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# the scripts' sizes (bisect_transposed.py:13-14, bisect_transposed3.py:14)
N, H, W, C = 128, 16, 32, 64
ROWS, WBLK = 4, 16

K7_VARIANTS = ("v1", "v2", "v3", "v4", "v5")
K8_BODIES = ("a", "b", "c", "d", "e")
# bisect_transposed3.py:112-142
K9_FLAGS = ("prologue", "zero_ring", "merge_dot", "shift", "stats", "scratch")
K9_CASES = {
    "base": dict(prologue=False, zero_ring=False, merge_dot=False, shift=False, stats=False,
                 scratch=False),
    "scratch": dict(prologue=False, zero_ring=False, merge_dot=False, shift=False, stats=False,
                    scratch=True),
    "merge": dict(prologue=False, zero_ring=False, merge_dot=True, shift=False, stats=False,
                  scratch=True),
    "shift": dict(prologue=False, zero_ring=False, merge_dot=False, shift=True, stats=False,
                  scratch=True),
    "shift_merge": dict(prologue=False, zero_ring=False, merge_dot=True, shift=True, stats=False,
                        scratch=True),
    "stats": dict(prologue=False, zero_ring=False, merge_dot=False, shift=False, stats=True,
                  scratch=True),
    "stats_merge": dict(prologue=False, zero_ring=False, merge_dot=True, shift=False, stats=True,
                        scratch=True),
    "prologue": dict(prologue=True, zero_ring=False, merge_dot=False, shift=False, stats=False,
                     scratch=True),
    "zero_ring": dict(prologue=True, zero_ring=True, merge_dot=False, shift=False, stats=False,
                      scratch=True),
    "stats2d": dict(prologue=False, zero_ring=False, merge_dot=False, shift=False, stats="2d",
                    scratch=True),
    "statspad": dict(prologue=False, zero_ring=False, merge_dot=False, shift=False, stats="pad",
                     scratch=True),
    "all_nostats": dict(prologue=True, zero_ring=True, merge_dot=True, shift=True, stats=False,
                        scratch=True),
    "all2d": dict(prologue=True, zero_ring=True, merge_dot=True, shift=True, stats="2d",
                  scratch=True),
    "all": dict(prologue=True, zero_ring=True, merge_dot=True, shift=True, stats=True,
                scratch=True),
}

# Kernel launches since import (or since the caller last reset them), one
# count for each script's kernel; only the CUDA branches add to them.
launches_k7 = 0
launches_k8 = 0
launches_k9 = 0

_lib: Optional[ctypes.CDLL] = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .. import kernels

        lib = kernels.load("transposed_bisect")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("bisect_k7_launch", "bisect_k8_launch"):
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = [i32, ptr, ptr, i32, i32, i32, i32, ptr, ptr]
        lib.bisect_vector_path.restype = i32
        lib.bisect_vector_path.argtypes = [ptr, ptr, i32]
        lib.bisect_k9_partials.restype = ctypes.c_int64
        lib.bisect_k9_partials.argtypes = [i32] * 4
        lib.bisect_k9_launch.restype = i32
        lib.bisect_k9_launch.argtypes = [i32] * 6 + [ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr,
                                                     i32, ptr]
        lib.bisect_error_string.restype = ctypes.c_char_p
        lib.bisect_error_string.argtypes = [i32]
        _lib = lib
    return _lib


# --- the functions, in plain PyTorch ---------------------------------------------


def _rows(xp: torch.Tensor, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    return xp[dy:dy + h, :, dx:dx + w, :]


def shifted_sum(xp: torch.Tensor, dys, dxs, h: int, w: int, bf16_adds: bool = False
                ) -> torch.Tensor:
    """sum over (dy, dx) of xp[h+dy, :, w+dx, :] in float32 (or rounded to
    xp's dtype after each add), rounded to xp's dtype once at the end."""
    acc = None
    for dy in dys:
        for dx in dxs:
            t = _rows(xp, dy, dx, h, w).float()
            acc = t if acc is None else acc + t
            if bf16_adds:
                acc = acc.to(xp.dtype).float()
    return acc.to(xp.dtype)


def stacked_dot(src: torch.Tensor, wm: torch.Tensor, dys, dxs, h: int, w: int
                ) -> torch.Tensor:
    """sum over dx of (Wm[:, :len(dys)*C] @ the rows src[h+dy] stacked over
    dy, at column w+dx), float32 products and sums, rounded to src's dtype."""
    c = src.shape[1]
    wf = wm[:, :len(dys) * c].float()
    acc = None
    for dx in dxs:
        stacked = torch.cat([_rows(src, dy, dx, h, w) for dy in dys], dim=1).float()
        t = torch.einsum("ok,hkwn->hown", wf, stacked)
        acc = t if acc is None else acc + t
    return acc.to(src.dtype)


def k7_reference(variant: str, xp: torch.Tensor, w: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """bisect_transposed.py's ``variant`` on xp (H+2, C, W+2, N), or
    (H+2, C, W+8, N) for v5; w (C, 3C) for v3. Returns (H, C, W, N)."""
    _check_variant(variant, K7_VARIANTS)
    _check_w(variant, w)
    h = xp.shape[0] - 2
    wd = xp.shape[2] - (8 if variant == "v5" else 2)
    if variant == "v3":
        return stacked_dot(xp, w, (0, 1, 2), (1,), h, wd)
    if variant == "v4":
        return shifted_sum(xp, (1,), (0, 1, 2), h, wd)
    return _rows(xp, 1, 1, h, wd).contiguous()


def k8_reference(body: str, xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bisect_transposed2.py's ``body`` on xp (H+2, C, W+2, N) and w (C, 3C).
    Returns (H, C, W, N)."""
    _check_variant(body, K8_BODIES)
    h, wd = xp.shape[0] - 2, xp.shape[2] - 2
    if body in ("a", "b"):
        return shifted_sum(xp, (0, 1, 2), (1,), h, wd, bf16_adds=body == "b")
    if body == "d":
        return stacked_dot(xp, w, (1,), (1,), h, wd)
    return stacked_dot(xp, w, (0, 1, 2), (1,), h, wd)


def _stats_out(sums: torch.Tensor, stats, c: int) -> torch.Tensor:
    out = torch.zeros((8, 128) if stats == "pad" else (2, c), dtype=torch.float32,
                      device=sums.device)
    if stats:
        out[0, :c] = sums
    return out


def k9_reference(xp: torch.Tensor, w: torch.Tensor, *, prologue, zero_ring, merge_dot, shift,
                 stats, scratch) -> Tuple[torch.Tensor, torch.Tensor]:
    """bisect_transposed3.py's ``_kernel`` under the flags, on xp
    (H+2, C, W+2, N) and w (3, C, 3C). Returns (y (H, C, W, N), stats)."""
    h, c, wd = xp.shape[0] - 2, xp.shape[1], xp.shape[2] - 2
    src = xp
    if scratch and prologue:
        src = torch.relu(xp.float() * 1.1 + 0.1).to(xp.dtype)
    if scratch and zero_ring:
        src = src.clone()
        src[0] = 0
        src[:, :, 0] = 0
    y = stacked_dot(src, w[0], (0, 1, 2) if merge_dot else (1,), (0, 1, 2) if shift else (0,),
                    h, wd)
    return y, _stats_out(y.float().sum((0, 2, 3)), stats, c)


# --- the wrappers -------------------------------------------------------------------


def _check_variant(name: str, names) -> None:
    if name not in names:
        raise ValueError(f"unknown variant {name!r}; one of {names}")


def _check_w(variant: str, w: Optional[torch.Tensor]) -> None:
    if variant == "v3" and w is None:
        raise ValueError("v3 is a dot: it needs w (C, 3C)")


def _check_cuda_inputs(xp: torch.Tensor, w: Optional[torch.Tensor], w_shape) -> None:
    if xp.ndim != 4:
        raise ValueError(f"xp must be (H+2, C, W+2, N), got shape {tuple(xp.shape)}")
    tensors = [("xp", xp)] + ([("w", w)] if w is not None else [])
    if w is not None and tuple(w.shape) != w_shape:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected {w_shape}")
    for name, t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernels take bf16 {name}, got {t.dtype}")
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xp.shape[1] % 8:
        raise ValueError(f"the kernels take C % 8 == 0, got C={xp.shape[1]}")


def _device(xp: torch.Tensor, what: str) -> str:
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {xp.device}")
    return xp.device.type


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _kernel().bisect_error_string(rc).decode())


def kernel_path(xp: torch.Tensor, w: Optional[torch.Tensor] = None) -> str:
    """Which path a K7/K8/K9 call on xp takes: ``"vector"`` (16-byte copies)
    or ``"element"`` of the kernel on a CUDA xp (w: the dots' weights, None
    for a crop or a sum), ``"plain"`` on a CPU one."""
    if _device(xp, "kernel_path") == "cpu":
        return "plain"
    vec = _kernel().bisect_vector_path(xp.data_ptr(), 0 if w is None else w.data_ptr(),
                                       xp.shape[3])
    return "vector" if vec else "element"


def _out(xp: torch.Tensor, margin: int) -> torch.Tensor:
    hs, c, ws, n = xp.shape
    return torch.empty((hs - 2, c, ws - margin, n), dtype=xp.dtype, device=xp.device)


def bisect_transposed(variant: str, xp: torch.Tensor, w: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K7 (``k7_reference``'s function): the kernel on a CUDA xp, the plain
    version on a CPU one. w (C, 3C) is read by v3 only."""
    _check_variant(variant, K7_VARIANTS)
    _check_w(variant, w)
    if _device(xp, "bisect_transposed") == "cpu":
        return k7_reference(variant, xp, w)
    c = xp.shape[1]
    _check_cuda_inputs(xp, w if variant == "v3" else None, (c, 3 * c))
    y = _out(xp, 8 if variant == "v5" else 2)
    with torch.cuda.device(xp.device):
        rc = _kernel().bisect_k7_launch(
            K7_VARIANTS.index(variant) + 1, xp.data_ptr(), w.data_ptr() if variant == "v3" else 0,
            *xp.shape, y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_if(rc, "bisect_transposed")
    global launches_k7
    launches_k7 += 1
    return y


def bisect_transposed2(body: str, xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K8 (``k8_reference``'s function): the kernel on a CUDA xp, the plain
    version on a CPU one."""
    _check_variant(body, K8_BODIES)
    if _device(xp, "bisect_transposed2") == "cpu":
        return k8_reference(body, xp, w)
    c = xp.shape[1]
    _check_cuda_inputs(xp, w, (c, 3 * c))
    y = _out(xp, 2)
    with torch.cuda.device(xp.device):
        rc = _kernel().bisect_k8_launch(
            K8_BODIES.index(body), xp.data_ptr(), w.data_ptr(), *xp.shape, y.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_if(rc, "bisect_transposed2")
    global launches_k8
    launches_k8 += 1
    return y


def bisect_transposed3(xp: torch.Tensor, w: torch.Tensor, *, prologue, zero_ring, merge_dot,
                       shift, stats, scratch, rows: int = ROWS, w_blk: int = WBLK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 (``k9_reference``'s function) under the flags of one of
    ``K9_CASES``: the kernel on a CUDA xp, the plain version on a CPU one.
    ``rows`` and ``w_blk`` are the TPU grid's blocks (ROWS, WBLK) and are
    checked as its grid needs them (H % rows == 0, W % w_blk == 0); the
    function does not depend on them."""
    flags = dict(prologue=prologue, zero_ring=zero_ring, merge_dot=merge_dot, shift=shift,
                 stats=stats, scratch=scratch)
    if stats not in (False, True, "2d", "pad"):
        raise ValueError(f"stats must be False, True, '2d' or 'pad', got {stats!r}")
    h, c, wd = xp.shape[0] - 2, xp.shape[1], xp.shape[2] - 2
    if rows < 1 or h % rows or w_blk < 1 or wd % w_blk:
        raise ValueError(f"H % rows and W % w_blk must be 0, got H={h}, rows={rows}, W={wd}, "
                         f"w_blk={w_blk}")
    if stats == "pad" and c > 128:
        raise ValueError(f"stats='pad' holds at most 128 channels, got C={c}")
    if _device(xp, "bisect_transposed3") == "cpu":
        return k9_reference(xp, w, **flags)
    _check_cuda_inputs(xp, w, (3, c, 3 * c))
    lib = _kernel()
    y = _out(xp, 2)
    partials = torch.empty((c, lib.bisect_k9_partials(*xp.shape)) if stats else (1,),
                           dtype=torch.float32, device=xp.device)
    # written whole by the kernels, zeros included (``_stats_out``'s layout)
    out = torch.empty((8, 128) if stats == "pad" else (2, c), dtype=torch.float32,
                      device=xp.device)
    with torch.cuda.device(xp.device):
        rc = lib.bisect_k9_launch(
            *(int(bool(flags[k])) for k in K9_FLAGS), xp.data_ptr(), w.data_ptr(), *xp.shape,
            y.data_ptr(), partials.data_ptr(), out.data_ptr(), out.numel(),
            torch.cuda.current_stream().cuda_stream)
    _raise_if(rc, "bisect_transposed3")
    global launches_k9
    launches_k9 += 1
    return y, out
