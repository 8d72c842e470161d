"""The K7 bisection kernels on the card: each variant's CUDA kernel
(``ops/transposed_bisect.py``, ``kernels/transposed_bisect.cu``) against
its plain version.

Counterpart of the JAX package's ``scripts/bisect_transposed.py`` (``run``
:18-25, ``__main__`` :138-141)::

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed [v1 ... v5]

Each variant runs twice, on the script's own input (ones) and on a seeded
random bf16 input, at the script's size (N=128, H=16, W=32, C=64), and
prints ``name: OK (sum of the output)`` as the JAX ``run`` does, with the
device times of the kernel and the plain version (median of 20 after
warm-up, in turns, each run with a cold L2) and of the one PyTorch call
that computes the same function (``one_call``), and the least time the card
could take for it (``window_bytes``). Unlike the JAX ``run`` it raises at
the first disagreement, of the kernel or of the one call: the kernel's
copies and sums must equal the plain version's (the same adds in the same
order), its dots, and the one calls' sums and dots, be within one bf16 ulp
of |y| plus 2^-16 max |y| (float32 sums in another order, each side rounded
to bf16 once). The helpers here are shared with ``bisect_transposed2.py``
and ``bisect_transposed3.py``.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from ..ops import transposed_bisect as tb
from .timing import bound_ms, card, in_turns, median_ms_device, require_cuda

CROPS = ("v1", "v2", "v5")
INPUTS = ("ones", "seeded")
# each variant's taps (dys, dxs): it reads xp[h+dy, :, w+dx] (k7_reference)
TAPS = {"v1": ((1,), (1,)), "v2": ((1,), (1,)), "v3": ((0, 1, 2), (1,)),
        "v4": ((1,), (0, 1, 2)), "v5": ((1,), (1,))}


def make_input(which: str, shape, device, seed: int) -> torch.Tensor:
    """The script's input (ones) or a seeded N(0, 1) one, in bf16."""
    if which == "ones":
        return torch.ones(shape, dtype=torch.bfloat16, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of |t|: 2^(floor(log2 |t|) - 7)."""
    mag = t.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def hold(name: str, got: torch.Tensor, want: torch.Tensor, exact: bool) -> float:
    """max |got - want|; raises AssertionError past the bar (module
    docstring)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: the kernel disagrees with the plain version: "
                             f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if exact:
        ok = torch.equal(got, want)
    else:
        ok = bool((diff <= bf16_ulp(w) + 2.0 ** -16 * w.abs().max()).all())
    if not ok:
        raise AssertionError(f"{name}: the kernel disagrees with the plain version: max |diff| "
                             f"{float(diff.max()):.4g} (max |y| {float(w.abs().max()):.4g}, "
                             f"exact={exact})")
    return float(diff.max())


def window_bytes(xp: torch.Tensor, dys, dxs, h: int, w: int, skip_zeroed: bool = False
                 ) -> int:
    """Bytes of xp that the taps (dys, dxs) read for an (h, C, w, N) output:
    rows min(dys)..max(dys)+h-1 and columns min(dxs)..max(dxs)+w-1, less
    row 0 and column 0 with ``skip_zeroed`` (K9's zero_ring zeroes them)."""
    rows = [r for r in range(min(dys), max(dys) + h) if r or not skip_zeroed]
    cols = [x for x in range(min(dxs), max(dxs) + w) if x or not skip_zeroed]
    return len(rows) * xp.shape[1] * len(cols) * xp.shape[3] * xp.element_size()


def _taps_view(xp: torch.Tensor, dys, dxs, h: int, w: int) -> torch.Tensor:
    """xp[h+dy, :, w+dx, :] as one overlapping view (h, C, w, dy, dx, N) of a
    contiguous xp: no copy."""
    s0, s1, s2, _ = xp.stride()
    return xp.as_strided((h, xp.shape[1], w, len(dys), len(dxs), xp.shape[3]),
                         (s0, s1, s2, s0, s2, 1),
                         xp.storage_offset() + dys[0] * s0 + dxs[0] * s2)


def one_call_sum(xp: torch.Tensor, dys, dxs, h: int, w: int) -> torch.Tensor:
    """sum over (dy, dx) of xp[h+dy, :, w+dx] as one reduction (float32
    sums, rounded to xp's dtype once) of an overlapping view."""
    return _taps_view(xp, dys, dxs, h, w).sum((3, 4))


def one_call_dot(xp: torch.Tensor, wm: torch.Tensor, dys, dx: int, h: int, w: int
                 ) -> torch.Tensor:
    """Wm[:, :len(dys)*C] @ the rows xp[h+dy] stacked over dy, at column
    w+dx, as one batched GEMM (``torch.bmm``) of an overlapping view: the
    stacked (dy, channel) index of a contiguous xp has one stride."""
    c, n = xp.shape[1], xp.shape[3]
    s0, s1, s2, _ = xp.stride()
    rows = xp.as_strided((h, len(dys) * c, w * n), (s0, s1, 1),
                         xp.storage_offset() + dys[0] * s0 + dx * s2)
    return torch.bmm(wm[:, :len(dys) * c].expand(h, -1, -1), rows).view(h, c, w, n)


def run_case(name: str, kernel, plain, exact: bool, nbytes: int, flops: int, timed: bool,
             library=None, library_exact: bool = False, path: Optional[str] = None) -> dict:
    """One variant on one input: kernel (and ``library``, the one PyTorch
    call, where there is one) against plain version, printed as the JAX
    ``run`` prints it, with the kernel's ``path`` where given; with
    ``timed`` the device times too, each with a cold L2 (the script makes an
    input once and reads it once)."""
    got = kernel()
    want = plain()
    err = hold(name, got, want, exact)
    if library is not None:
        hold(f"{name} (one PyTorch call)", library(), want, library_exact)
    total = float(got.float().sum())
    out = {"name": name, "sum": total, "max_abs_err": err, "bytes": nbytes, "flops": flops,
           "path": path, **bound_ms(nbytes, flops)}
    line = f"{name}: OK ({total:.3e})" + (f" [{path} path]" if path else "")
    if timed:
        out.update(in_turns(plain, kernel, flush_l2=True))
        out["library_ms"] = (median_ms_device(library, flush_l2=True) if library is not None
                             else None)
        line += (f"  kernel {out['ms'] * 1e3:.2f} us, plain {out['plain_ms'] * 1e3:.2f} us, "
                 f"bound {out['bound_ms'] * 1e3:.2f} us ({out['bound_by']})")
        if library is not None:
            line += f", one PyTorch call {out['library_ms'] * 1e3:.2f} us"
    print(line, flush=True)
    return out


def case(name: str, which: str, device, n=tb.N, h=tb.H, w=tb.W, c=tb.C) -> dict:
    """Variant ``name`` on input ``which``: xp and w (None but for v3), the
    bytes and operations of its bound, its one PyTorch call, and whether the
    kernel and the one call must equal the plain version bit for bit."""
    dys, dxs = TAPS[name]
    k = 3 * c if name == "v3" else 0
    xp = make_input(which, (h + 2, c, w + 8 if name == "v5" else w + 2, n), device, 1)
    wm = make_input(which, (c, 3 * c), device, 2) if name == "v3" else None
    if name in CROPS:  # one contiguous slice copy
        library = (lambda: xp[1:h + 1, :, 1:1 + w, :].contiguous())
    elif name == "v3":
        library = (lambda: one_call_dot(xp, wm, dys, dxs[0], h, w))
    else:
        library = (lambda: one_call_sum(xp, dys, dxs, h, w))
    return {"xp": xp, "wm": wm, "library": library, "exact": name != "v3",
            "library_exact": name in CROPS, "flops": 2 * k * h * c * w * n,
            "nbytes": window_bytes(xp, dys, dxs, h, w) + 2 * c * k + 2 * h * c * w * n}


def run(names=None, device=None, n=tb.N, h=tb.H, w=tb.W, c=tb.C, timed=False) -> list:
    """Every variant of ``names`` (default all) on ones and on a seeded
    input, at (n, h, w, c)."""
    device = device or require_cuda("bisect_transposed")
    results = []
    for name in names or tb.K7_VARIANTS:
        for which in INPUTS:
            cs = case(name, which, device, n, h, w, c)
            xp, wm = cs["xp"], cs["wm"]
            results.append(run_case(
                f"{name}/{which}", lambda: tb.bisect_transposed(name, xp, wm),
                lambda: tb.k7_reference(name, xp, wm), cs["exact"], cs["nbytes"], cs["flops"],
                timed, cs["library"], library_exact=cs["library_exact"],
                path=tb.kernel_path(xp, wm)))
    return results


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    device = require_cuda("bisect_transposed")
    print(card())
    return run(argv or None, device, timed=True)


if __name__ == "__main__":
    main()
