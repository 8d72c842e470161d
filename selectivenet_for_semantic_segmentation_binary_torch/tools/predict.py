"""Standalone image -> mask prediction CLI (``snet-predict``).

Counterpart of the JAX package's ``tools/predict.py`` (``_collect_inputs``
:55, ``_load_image`` :78, ``_pad_to_grid`` :108, ``predict_image`` :119,
``_save_outputs`` :213, ``main`` :246), with its flags:

* JPEG/PNG images of any size in; the binary mask, the jet heatmap, the
  selection mask of a selective checkpoint and, with ``--save_prob 1``, the
  float32 probability map out, as ``{stem}_pred.png``,
  ``{stem}_heatmap.png``, ``{stem}_selection.png`` and ``{stem}_prob.npy``
  beside the input or under ``--save_dir`` (colliding stems within a run
  become ``{stem}_2``, ...);
* inference through the serving ``Predictor`` (BN-folded bfloat16 forward
  by default);
* images are edge-padded to the pool grid (dims divisible by 8) and the
  outputs cropped back, so any size is exact;
* ``--tile H W``: the bounded-memory exact tiled path
  (``tools/tiled_inference.py``).

Run on the first card::

    python -m selectivenet_for_semantic_segmentation_binary_torch.tools.predict \\
        IMAGE.png --model_path model_epoch10.pth --selective 1 --save_dir OUT

From Python, ``main(argv, device="cpu")`` runs on the CPU; without a card
and without ``device`` it raises. Not ported yet, and refused naming their
ROADMAP item: ``--uncertainty`` and ``--dropout_rate`` (A7c), ``--quantize
int8`` and ``--calib_images`` (A10), ``--shard_windows`` (A8), and
``--input_type GH|H_RGB`` and ``--blankfield 1`` (A5).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .tiled_inference import GRID  # the trunk max-pools 3x: dims % 8 == 0

_OUTPUT_SUFFIXES = ("_pred.png", "_heatmap.png", "_selection.png", "_label.png")


def _collect_inputs(paths: List[str]) -> List[str]:
    """Expand directories into their image files; skip labels and this
    tool's own outputs, so re-runs on a directory are idempotent."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if not name.lower().endswith((".jpg", ".jpeg", ".png")):
                    continue
                if name.lower().endswith(_OUTPUT_SUFFIXES):
                    continue
                out.append(os.path.join(p, name))
        else:
            if not os.path.isfile(p):
                # fail before any checkpoint load or device work
                raise FileNotFoundError(f"input image does not exist: {p}")
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input images found in {paths}")
    return out


def _check_input_type(input_type: str, blankfield: bool) -> None:
    if input_type != "RGB" or blankfield:
        raise NotImplementedError("only RGB input is ported (--input_type GH|H_RGB and "
                                  "--blankfield 1 are ROADMAP A5)")


def _load_image(path, input_type: str = "RGB", blankfield: bool = False) -> np.ndarray:
    """Decode a file or file object to (H, W, 3) raw uint8 RGB, which
    crosses to the device as bytes and is normalised there
    (``ops/ingest.py``). PIL is imported on use."""
    from PIL import Image

    _check_input_type(input_type, blankfield)
    return np.asarray(Image.open(path).convert("RGB"))


def _pad_to_grid(img: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Edge-pad (H, W, C) so both dims divide GRID; returns the original dims."""
    h, w = img.shape[:2]
    ph, pw = (-h) % GRID, (-w) % GRID
    if ph or pw:
        # edge (replicate) padding works for any pad width, unlike reflect
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return img, h, w


def predict_image(predictor, image: np.ndarray, tile: Optional[Tuple[int, int]] = None,
                  batch_size: int = 8, mesh=None) -> Dict[str, np.ndarray]:
    """One (H, W, C) raw image (float [0, 1] or uint8 [0, 255]) ->
    {'prob', 'pred'[, 'selection']}, each cropped back to (H, W); ``prob``
    float32. uint8 keeps its dtype through the padding."""
    padded, h, w = _pad_to_grid(np.asarray(image))
    if tile is not None:
        out = predictor.predict_wsi(padded, tile=tile, batch_size=batch_size, mesh=mesh)
    else:
        raw = predictor.predict(padded[None])
        out = {k: v[0] for k, v in raw.items() if k in ("prob", "pred", "selection")}
    out = {k: v[:h, :w] for k, v in out.items()}
    out["prob"] = np.asarray(out["prob"], np.float32)
    return out


def _save_outputs(out: Dict[str, np.ndarray], stem: str, save_dir: str, save_prob: bool,
                  heatmap: bool, n_cls: int = 2) -> List[str]:
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    written: List[str] = []

    def _write_png(suffix: str, arr: np.ndarray) -> None:
        path = os.path.join(save_dir, f"{stem}{suffix}")
        Image.fromarray(arr).save(path)
        written.append(path)

    # CE-head class ids spread evenly over the gray levels; binary keeps 0/255
    scale = np.uint8(255 // max(int(n_cls) - 1, 1))
    _write_png("_pred.png", out["pred"].astype(np.uint8) * scale)
    if "selection" in out:
        _write_png("_selection.png", out["selection"].astype(np.uint8) * 255)
    if heatmap:
        try:
            from .wsi import make_heatmap

            _write_png("_heatmap.png", (make_heatmap(out["prob"]) * 255).astype(np.uint8))
        except ImportError:  # matplotlib is optional
            print(f"  (matplotlib unavailable: skipping {stem}_heatmap.png)")
    if save_prob:
        path = os.path.join(save_dir, f"{stem}_prob.npy")
        np.save(path, out["prob"].astype(np.float32))
        written.append(path)
    return written


def build_parser():
    """The JAX ``snet-predict`` flag surface."""
    import argparse

    from ..config import parse_bool

    parser = argparse.ArgumentParser(
        description="standalone image -> tumor mask prediction (whole-image or exact "
                    "tiled inference through the serving Predictor)")
    parser.add_argument("inputs", nargs="+",
                        help="image files and/or directories of JPEG/PNG images")
    parser.add_argument("--model_path", default=None, help="one .pth/.ckpt checkpoint")
    parser.add_argument("--model_dir", default=None,
                        help="checkpoint dir: its digit-latest model_epoch{N} file is used")
    parser.add_argument("--model_arch", default="UNet_B", choices=["UNet", "UNet_B"])
    parser.add_argument("--n_cls", type=int, default=2)
    parser.add_argument("--selective", type=parse_bool, default=False)
    parser.add_argument("--input_type", default="RGB", choices=["RGB", "GH", "H_RGB"])
    parser.add_argument("--blankfield", type=parse_bool, default=False)
    parser.add_argument("--compute_dtype", default="bfloat16")
    parser.add_argument("--cut_off", type=float, default=0.5)
    parser.add_argument("--s_cut_off", type=float, default=0.5)
    parser.add_argument("--fold_bn", type=parse_bool, default=True,
                        help="fold BatchNorm into the convs (serving graph)")
    parser.add_argument("--quantize", default="none", choices=["none", "int8"])
    parser.add_argument("--calib_images", nargs="+", default=None, metavar="PATH")
    parser.add_argument("--tile", type=int, nargs=2, default=None, metavar=("H", "W"),
                        help="bounded-memory exact tiled inference with this output tile "
                             "(dims divisible by 8); default: one whole-image forward")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="windows per device batch on the tiled path")
    parser.add_argument("--shard_windows", type=parse_bool, default=False)
    parser.add_argument("--uncertainty", type=int, default=0, metavar="N")
    parser.add_argument("--dropout_rate", type=float, default=0.0)
    parser.add_argument("--mc_seed", type=int, default=0)
    parser.add_argument("--save_dir", default=None,
                        help="output directory (default: next to each input)")
    parser.add_argument("--save_prob", type=parse_bool, default=False,
                        help="also write {stem}_prob.npy float32 maps")
    parser.add_argument("--heatmap", type=parse_bool, default=True)
    return parser


def main(argv=None, device=None) -> None:
    """CLI: python -m selectivenet_for_semantic_segmentation_binary_torch.tools.predict.
    Runs on ``cuda:0`` unless ``device`` names another device."""
    parser = build_parser()
    a = parser.parse_args(argv)

    tile = tuple(a.tile) if a.tile else None
    if tile and any(t <= 0 or t % GRID for t in tile):
        parser.error(f"--tile dims must be positive multiples of {GRID}, got {tile}")
    if a.batch_size <= 0:
        parser.error(f"--batch_size must be positive, got {a.batch_size}")
    if a.uncertainty < 0:
        parser.error(f"--uncertainty must be >= 0, got {a.uncertainty}")
    if a.uncertainty or a.dropout_rate > 0:
        raise NotImplementedError("MC-dropout uncertainty (--uncertainty, --dropout_rate) "
                                  "is not ported yet: ROADMAP A7c")
    if a.quantize == "int8" or a.calib_images:
        raise NotImplementedError("the int8 serving trunk (--quantize int8, --calib_images) "
                                  "is not ported yet: ROADMAP A10")
    if a.shard_windows:
        raise NotImplementedError("--shard_windows (windows over several cards) is not "
                                  "ported yet: ROADMAP A8")
    _check_input_type(a.input_type, a.blankfield)

    from ..utils.checkpoint import resolve_checkpoint

    try:
        ckpt = resolve_checkpoint(a.model_path, a.model_dir)
    except ValueError as e:
        parser.error(str(e))

    inputs = _collect_inputs(a.inputs)  # validate before the checkpoint load

    from ..predictor import Predictor

    predictor = Predictor(ckpt, model_arch=a.model_arch, n_cls=a.n_cls,
                          selective=a.selective, compute_dtype=a.compute_dtype,
                          cut_off=a.cut_off, s_cut_off=a.s_cut_off, fold_bn=a.fold_bn,
                          device=device)
    print(f"checkpoint: {ckpt} ({a.model_arch}, selective={a.selective}, "
          f"fold_bn={a.fold_bn}, {a.compute_dtype}) on {predictor.device}")

    seen_stems = set()
    for path in inputs:
        image = _load_image(path, a.input_type, a.blankfield)
        out = predict_image(predictor, image, tile=tile, batch_size=a.batch_size)
        base = os.path.splitext(os.path.basename(path))[0]
        save_dir = a.save_dir or os.path.dirname(os.path.abspath(path))
        # a.png beside a.jpg, or same-named inputs funnelled into one --save_dir
        stem, n = base, 2
        while (save_dir, stem) in seen_stems:
            stem = f"{base}_{n}"
            n += 1
        seen_stems.add((save_dir, stem))
        _save_outputs(out, stem, save_dir, a.save_prob, a.heatmap, n_cls=a.n_cls)
        line = (f"{path}: {image.shape[0]}x{image.shape[1]} "
                f"tumor_fraction={float(out['pred'].mean()):.4f}")
        if "selection" in out:
            line += f" coverage={float(out['selection'].mean()):.4f}"
        print(line, flush=True)


if __name__ == "__main__":
    main()
