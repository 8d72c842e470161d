"""Exact seamless whole-slide inference by overlapped tiling.

Counterpart of the JAX package's ``tools/tiled_inference.py`` (``GRID``,
``RECEPTIVE_RADIUS``, ``DEFAULT_HALO`` :36-42, ``_window_origin`` :44,
``tiled_inference`` :50, ``wsi_mask`` :148, ``_tumor_prob`` :199). It
computes the exact full-image forward with bounded memory:

* the output is cut into chunks; each chunk comes from an input window that
  reaches ``halo`` pixels past it on every side, ``halo`` >= the trunk's
  receptive-field radius (44 px for UNet and UNet_B) plus 8 px of slack;
* windows are clamped into the image, so at its borders a window is flush
  with them and every conv's zero padding acts as in the whole-image
  forward;
* window origins are rounded down to multiples of 8, so the three max-pool
  grids stay aligned with the whole-image forward's.

The image is ingested once (uint8 stays uint8); the windows are sliced from
it on the device, and only each window's chunk is copied back to the host.
Equality with the whole-image forward is pinned by
``tests/test_torch_tiled_inference.py``. Windows sharded over several cards
(the JAX ``mesh=``) are ROADMAP A8.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# receptive-field radius of the UNet trunk plus 8 px of pool-alignment
# slack, rounded to a multiple of 8
RECEPTIVE_RADIUS = 44
DEFAULT_HALO = 56
GRID = 8  # input dims must be divisible by 2^(#pools)


def _window_origin(chunk_start: int, halo: int, win: int, limit: int) -> int:
    """Clamped, GRID-aligned window origin covering [chunk_start - halo, ...)."""
    w0 = min(max(chunk_start - halo, 0), max(limit - win, 0))
    return (w0 // GRID) * GRID


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("window batches sharded over several cards (mesh=) "
                                  "are not ported yet: ROADMAP A8")


def tiled_inference(apply_fn, image: torch.Tensor, tile: Tuple[int, int] = (512, 512),
                    halo: int = DEFAULT_HALO, batch_size: int = 8, mesh=None):
    """Exact full-image forward of a fully convolutional NHWC model.

    Args:
        apply_fn: (N, h, w, C) windows -> (N, h, w) or (N, h, w, K) maps, or
            a tuple of them (the selective three-head forward). Trailing
            channel dims (the CE-head UNet's K planes) are kept.
        image: (H, W, C) tensor on the device, H and W divisible by 8.
        tile: output chunk size per window (each dim divisible by 8).
        halo: overlap margin, >= RECEPTIVE_RADIUS + 8.
        batch_size: windows per forward.
    Returns:
        (H, W[, K]) numpy array, or a tuple of them if apply_fn returns one.
    """
    _refuse_mesh(mesh)
    H, W, _ = image.shape
    th, tw = tile
    if H % GRID or W % GRID:
        raise ValueError(f"image dims must be divisible by {GRID}, got {(H, W)}")
    if halo < RECEPTIVE_RADIUS + GRID:
        raise ValueError(f"halo must be >= {RECEPTIVE_RADIUS + GRID}, got {halo}")

    win_h = min(H, th + 2 * halo)
    win_w = min(W, tw + 2 * halo)
    win_h = ((win_h + GRID - 1) // GRID) * GRID
    win_w = ((win_w + GRID - 1) // GRID) * GRID

    jobs = []  # (r0, c0, chunk_h, chunk_w, w_r0, w_c0)
    for r0 in range(0, H, th):
        ch = min(th, H - r0)
        wr = _window_origin(r0, halo, win_h, H)
        for c0 in range(0, W, tw):
            cw = min(tw, W - c0)
            wc = _window_origin(c0, halo, win_w, W)
            jobs.append((r0, c0, ch, cw, wr, wc))

    outputs = None
    as_tuple = False
    for lo in range(0, len(jobs), batch_size):
        chunk_jobs = jobs[lo:lo + batch_size]
        batch = torch.stack([image[wr:wr + win_h, wc:wc + win_w]
                             for (_, _, _, _, wr, wc) in chunk_jobs])
        out = apply_fn(batch)
        as_tuple = isinstance(out, tuple)
        outs = out if as_tuple else (out,)
        if outputs is None:
            outputs = [torch.zeros((H, W) + tuple(o.shape[3:]), dtype=o.dtype) for o in outs]
        for k, o in enumerate(outs):
            for j, (r0, c0, ch, cw, wr, wc) in enumerate(chunk_jobs):
                outputs[k][r0:r0 + ch, c0:c0 + cw] = (
                    o[j, r0 - wr:r0 - wr + ch, c0 - wc:c0 - wc + cw].cpu())
    outputs = [o.numpy() for o in outputs]
    return tuple(outputs) if as_tuple else outputs[0]


def wsi_mask(model, image: np.ndarray, selective: bool = False, cut_off: float = 0.5,
             s_cut_off: float = 0.5, tile: Tuple[int, int] = (512, 512),
             halo: int = DEFAULT_HALO, batch_size: int = 8, mesh=None, apply_fn=None,
             device=None):
    """Seamless full-slide probability map and mask (and selection mask).

    ``image``: (H, W, C) raw pixels, float [0, 1] or uint8 [0, 255] (uint8
    crosses to the device as bytes; the normalisation runs there). ``model``
    is an eval-mode model on ``device`` (default: its parameters' device);
    with ``apply_fn`` (raw windows -> tuple of head logits, as the
    ``Predictor``'s cached forward) ``model`` is unused and ``device`` must
    be given. The JAX signature's ``variables`` live in the torch model."""
    from ..ops.ingest import device_ingest, normalize_raw

    _refuse_mesh(mesh)
    if apply_fn is None:
        device = next(model.parameters()).device if device is None else device

        def apply_fn(batch):
            with torch.inference_mode():
                out = model(normalize_raw(batch).permute(0, 3, 1, 2))
            return out if isinstance(out, tuple) else (out,)

    outs = tiled_inference(apply_fn, device_ingest(image, device), tile, halo, batch_size)
    if not isinstance(outs, tuple):
        outs = (outs,)  # a bare (H, W) map is one head, not a tuple of rows
    prob = _tumor_prob(outs[0])
    result = {"prob": prob, "pred": (prob > cut_off).astype(np.uint8)}
    if selective and len(outs) >= 2:
        sel_prob = _tumor_prob(outs[1])
        result["selection"] = (sel_prob > s_cut_off).astype(np.uint8)
    return result


def _tumor_prob(logits: np.ndarray) -> np.ndarray:
    """(H, W) logits -> sigmoid; (H, W, K) CE-head logits -> softmax class-1
    plane (the tumour class, reference eval.py:227-233), in numpy as the JAX
    version computes it."""
    if logits.ndim == 2:
        return 1.0 / (1.0 + np.exp(-logits))
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True))[..., 1]
