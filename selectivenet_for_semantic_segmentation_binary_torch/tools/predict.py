"""Standalone image -> mask prediction CLI (``snet-predict``).

Counterpart of the JAX package's ``tools/predict.py`` (``_collect_inputs``
:55, ``_load_image`` :78, ``_pad_to_grid`` :108, ``predict_image`` :119,
``predict_image_with_uncertainty`` :148, ``_mc_pred`` :169, ``_save_uncertainty``
:184, ``_save_outputs`` :213, ``main`` :246), with its flags:

* JPEG/PNG images of any size in; the binary mask, the jet heatmap, the
  selection mask of a selective checkpoint and, with ``--save_prob 1``, the
  float32 probability map out, as ``{stem}_pred.png``,
  ``{stem}_heatmap.png``, ``{stem}_selection.png`` and ``{stem}_prob.npy``
  beside the input or under ``--save_dir`` (colliding stems within a run
  become ``{stem}_2``, ...);
* inference through the serving ``Predictor`` (BN-folded bfloat16 forward
  by default);
* plain RGB is decoded to uint8 and normalised on the card;
  ``--input_type GH|H_RGB`` and ``--blankfield 1`` decode to float32 [0, 1]
  and convert on the host (``_load_image``: the stain first, then the
  blank-field correction, as the train feed orders them), and a GH
  checkpoint's model takes the 2 channels;
* images are edge-padded to the pool grid (dims divisible by 8) and the
  outputs cropped back, so any size is exact;
* ``--tile H W``: the bounded-memory exact tiled path
  (``tools/tiled_inference.py``);
* ``--uncertainty N --dropout_rate R``: N MC-dropout forwards an image
  (``Predictor.predict_with_uncertainty``, seeded by ``--mc_seed``); the
  masks come from their mean, and ``{stem}_uncertainty.npz`` and
  ``{stem}_variance.png`` are written beside the others;
* ``--quantize int8``: the W8A8 serving trunk (K10 on the card), its
  activation scales calibrated on ``--calib_images`` (images or
  directories, padded to the pool grid as the inputs are) or else on the
  first image.

Run on the first card::

    python -m selectivenet_for_semantic_segmentation_binary_torch.tools.predict \\
        IMAGE.png --model_path model_epoch10.pth --selective 1 --save_dir OUT

From Python, ``main(argv, device="cpu")`` runs on the CPU; without a card
and without ``device`` it raises. The heatmaps are jet renderings made
with numpy (``tools/wsi.make_heatmap``), the same pixels as matplotlib's.
Not ported yet, and refused naming its ROADMAP item: ``--shard_windows``
(A8).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.stain import H_RGB, RGB2GH
from ..data.transforms import BlankfieldCorrection
from .tiled_inference import GRID  # the trunk max-pools 3x: dims % 8 == 0
from .wsi import make_heatmap

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


def _load_image(path, input_type: str = "RGB", blankfield: bool = False) -> np.ndarray:
    """Decode a file or file object to (H, W, C) (JAX ``_load_image``
    :78-105): raw uint8 RGB for plain RGB, which crosses to the device as
    bytes and is normalised there (``ops/ingest.py``); else float32 [0, 1],
    then ``RGB2GH`` (2 channels) or ``H_RGB``, then ``BlankfieldCorrection``,
    in that order. PIL is imported on use."""
    from PIL import Image

    raw = np.asarray(Image.open(path).convert("RGB"))
    if input_type == "RGB" and not blankfield:
        return raw
    img = raw.astype(np.float32) / 255.0
    if input_type == "GH":
        img = RGB2GH(img)
    elif input_type == "H_RGB":
        img = H_RGB(img)
    if blankfield:
        img = BlankfieldCorrection()({"input": img}, None)["input"]
    return img


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


def predict_image_with_uncertainty(predictor, image: np.ndarray, n_iter: int,
                                   seed: int = 0) -> Dict[str, np.ndarray]:
    """One (H, W, C) raw image -> the MC-dropout maps of ``n_iter``
    stochastic forwards (check_MC_dropout.ipynb cells 0-4), padded to the
    pool grid and cropped back as :func:`predict_image` does. Returns float32
    {'mean_prob' (H, W, C), 'variance' (H, W, C), 'confidence' (H, W)}."""
    padded, h, w = _pad_to_grid(np.asarray(image))
    out = predictor.predict_with_uncertainty(padded[None], n_iter=n_iter, seed=seed)
    return {k: np.asarray(v[0], np.float32)[:h, :w] for k, v in out.items()}


def _mc_pred(unc: Dict[str, np.ndarray], cut_off: float) -> Dict[str, np.ndarray]:
    """prob and pred from the MC predictive mean: a binary head thresholds
    the mean sigmoid probability at ``cut_off``, a CE head takes the argmax
    of the mean softmax."""
    mp = unc["mean_prob"]
    if mp.shape[-1] == 1:
        prob = mp[..., 0]
        pred = (prob > cut_off).astype(np.uint8)
    else:
        prob = mp[..., 1]
        pred = np.argmax(mp, axis=-1).astype(np.uint8)
    return {"prob": prob.astype(np.float32), "pred": pred}


def _save_uncertainty(unc: Dict[str, np.ndarray], stem: str, save_dir: str,
                      heatmap: bool) -> List[str]:
    """{stem}_uncertainty.npz (mean_prob, variance, confidence) and
    {stem}_variance.png, the class-mean variance min-max normalised, in jet
    with ``--heatmap 1`` and in gray otherwise."""
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    written: List[str] = []
    npz_path = os.path.join(save_dir, f"{stem}_uncertainty.npz")
    np.savez(npz_path, **{k: v.astype(np.float32) for k, v in unc.items()})
    written.append(npz_path)

    var = -unc["confidence"]  # class-mean variance (confidence is its negation)
    spread = float(var.max() - var.min())
    norm = (var - var.min()) / spread if spread > 0 else np.zeros_like(var)
    img = (make_heatmap(norm) if heatmap else norm) * 255
    png_path = os.path.join(save_dir, f"{stem}_variance.png")
    Image.fromarray(img.astype(np.uint8)).save(png_path)
    written.append(png_path)
    return written


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
        _write_png("_heatmap.png", (make_heatmap(out["prob"]) * 255).astype(np.uint8))
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
    if a.uncertainty:
        if a.dropout_rate <= 0:
            parser.error("--uncertainty requires --dropout_rate > 0: with no "
                         "dropout every stochastic forward is identical and "
                         "the variance is zero (the reference model has no "
                         "dropout layer — check_MC_dropout.ipynb only specs "
                         "the aggregation math)")
        if tile is not None:
            parser.error("--uncertainty runs whole-image forwards; it is "
                         "incompatible with --tile")
    elif a.dropout_rate > 0:
        parser.error("--dropout_rate without --uncertainty has no effect "
                     "(inference dropout only runs on the MC path); remove "
                     "the flag or add --uncertainty N")
    if a.quantize == "int8":
        if not a.fold_bn:
            parser.error("--quantize int8 requires --fold_bn 1 (the int8 "
                         "trunk consumes BN-folded weights, ops/quant.py)")
        if a.uncertainty:
            parser.error("--quantize int8 and --uncertainty are exclusive "
                         "(MC-dropout uncertainty runs the bf16 folded graph)")
    elif a.calib_images:
        parser.error("--calib_images without --quantize int8 has no effect")
    if a.shard_windows:
        raise NotImplementedError("--shard_windows (windows over several cards) is not "
                                  "ported yet: ROADMAP A8")

    from ..utils.checkpoint import resolve_checkpoint

    try:
        ckpt = resolve_checkpoint(a.model_path, a.model_dir)
    except ValueError as e:
        parser.error(str(e))

    inputs = _collect_inputs(a.inputs)  # validate before the checkpoint load

    from ..config import check_input_channels
    from ..predictor import Predictor

    predictor = Predictor(ckpt, model_arch=a.model_arch, n_cls=a.n_cls,
                          selective=a.selective, compute_dtype=a.compute_dtype,
                          cut_off=a.cut_off, s_cut_off=a.s_cut_off, fold_bn=a.fold_bn,
                          dropout_rate=a.dropout_rate, quantize=a.quantize, device=device)
    check_input_channels(parser, a.input_type, predictor.in_ch)
    if a.quantize == "int8" and a.calib_images:
        calib = [_pad_to_grid(_load_image(p, a.input_type, a.blankfield))[0]
                 for p in _collect_inputs(a.calib_images)]
        predictor.calibrate(calib)
        print(f"int8 serving trunk: calibrated on {len(calib)} images")
    print(f"checkpoint: {ckpt} ({a.model_arch}, selective={a.selective}, "
          f"fold_bn={a.fold_bn}, {a.compute_dtype}"
          + (", int8" if a.quantize == "int8" else "") + f") on {predictor.device}")

    seen_stems = set()
    for path in inputs:
        image = _load_image(path, a.input_type, a.blankfield)
        unc = None
        if a.uncertainty:
            unc = predict_image_with_uncertainty(predictor, image, a.uncertainty, a.mc_seed)
            out = _mc_pred(unc, a.cut_off)
        else:
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
        if unc is not None:
            _save_uncertainty(unc, stem, save_dir, a.heatmap)
        line = (f"{path}: {image.shape[0]}x{image.shape[1]} "
                f"tumor_fraction={float(out['pred'].mean()):.4f}")
        if "selection" in out:
            line += f" coverage={float(out['selection'].mean()):.4f}"
        if unc is not None:
            line += (f" mc_iters={a.uncertainty}"
                     f" mean_var={float(unc['variance'].mean()):.3e}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
