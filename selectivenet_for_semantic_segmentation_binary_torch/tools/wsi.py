"""Whole-slide stitched scoring, jet heatmaps and CSV reports (``snet-wsi``).

Counterpart of the JAX package's ``tools/wsi.py`` (reference
jupyters/u-net_testing.ipynb cells 4-8):

* ``stitch_patches`` (:33): per-patch arrays into one slide canvas, patch
  j at row ``j % nrow``, column ``j // nrow`` (cell 7);
* ``make_heatmap`` (:49): the jet rendering of a probability map;
* ``save_performance_as_csv`` (:56);
* ``wsi_inference`` (:114): every patch of each slide of a dataset through
  the model on the device, stitched, scored per patch and per slide with
  ``utils.metrics.get_performance``;
* ``main`` (:230, ``snet-wsi``): the same over a test fold, from a
  checkpoint, with the JAX flags and their defaults.

Deliberate differences: ``wsi_inference`` takes no ``variables`` (a torch
model holds its weights) and a ``device`` (default ``cuda:0``, raising
without a card; ``"cpu"`` runs on the CPU), and moves the model there.
``make_heatmap`` is built from jet's segment data with numpy, so it needs no
matplotlib, and gives matplotlib's pixels bit for bit. The AUC is
``get_performance``'s, without scikit-learn and equal to it. Only the raw
uint8 path is ported: a dataset with a host transform, ``--input_type
GH|H_RGB`` and ``--blankfield 1`` are ROADMAP A5, ``--quantize int8`` A10;
they raise ``NotImplementedError``.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.ingest import device_ingest, normalize_raw
from ..train_lib import resolve_device
from ..utils.metrics import get_performance

# matplotlib's jet (matplotlib/_cm.py): (x, y0, y1) segments of each channel
_JET_SEGMENTS = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
)
JET_N = 256


def _lookup_table(segments, n: int = JET_N) -> np.ndarray:
    """One channel of a ``LinearSegmentedColormap``'s table, with
    matplotlib's own arithmetic (``colors._create_lookup_table``, gamma 1)."""
    adata = np.array(segments, dtype=np.float64)
    x = adata[:, 0] * (n - 1)
    y0, y1 = adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


_JET = np.stack([_lookup_table(s) for s in _JET_SEGMENTS], axis=-1)  # (256, 3) float64


def make_heatmap(output: np.ndarray) -> np.ndarray:
    """Probability map -> jet RGB float32 (u-net_testing.ipynb cell 7), equal
    to ``matplotlib.cm.jet(output)[..., :3]``: a float v takes entry
    ``int(v * 256)`` (1.0 the last), below 0 the first and past 1 the last;
    NaN is black. Integer input indexes the table directly, as in
    matplotlib."""
    x = np.array(output, copy=True)
    if x.dtype.kind == "f":
        x *= JET_N  # in x's own dtype, as matplotlib multiplies
        x[x == JET_N] = JET_N - 1
        bad = np.isnan(x)
    else:
        bad = np.zeros(x.shape, bool)
    under, over = x < 0, x >= JET_N
    with np.errstate(invalid="ignore"):
        idx = x.astype(np.int64)
    idx[under] = 0
    idx[over | bad] = JET_N - 1
    rgb = _JET[idx]
    rgb[bad] = 0.0
    return rgb.astype(np.float32)


def stitch_patches(patches: np.ndarray, nrow: int) -> np.ndarray:
    """(B, H, W[, C]) per-patch arrays -> (nrow*H, ncol*W[, C]) canvas.

    Placement: patch j lands at row j % nrow, column j // nrow
    (u-net_testing.ipynb cell 7).
    """
    patches = np.asarray(patches)
    b, h, w = patches.shape[:3]
    ncol = -(-b // nrow)
    canvas = np.zeros((nrow * h, ncol * w) + patches.shape[3:], patches.dtype)
    for j in range(b):
        r, c = j % nrow, j // nrow
        canvas[r * h : (r + 1) * h, c * w : (c + 1) * w] = patches[j]
    return canvas


def save_performance_as_csv(save_dir: str, rows: Sequence[Sequence], csv_name: str,
                            header: Optional[Sequence[str]] = None) -> str:
    """Write performance rows to {save_dir}/{csv_name}.csv."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{csv_name}.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header or ["accuracy", "recall", "precision", "f1 score", "AUC score"])
        for row in rows:
            writer.writerow(list(map(str, row)))
    return path


def _wsi_forward(model: torch.nn.Module, x_u8: torch.Tensor, selective: bool) -> torch.Tensor:
    """(B, H, W, 3) uint8 on the device -> (B, H, W) tumor probability on the
    device: normalised there, the output head only, then sigmoid (binary
    head) or the softmax's class 1 (JAX ``_wsi_forward`` :69)."""
    with torch.inference_mode():
        out = model(normalize_raw(x_u8).permute(0, 3, 1, 2))
        if selective:
            out = out[0]
        return torch.sigmoid(out) if out.ndim == 3 else torch.softmax(out, -1)[..., 1]


def _group_by_slide(ids: List[str]) -> Dict[str, List[int]]:
    groups: Dict[str, List[int]] = {}
    for i, pid in enumerate(ids):
        slide = pid.rsplit("_", 2)[0]  # {slide_id}_{x}_{y}
        groups.setdefault(slide, []).append(i)
    return groups


def _check_dataset(dataset) -> None:
    """Only the raw uint8 feed is ported (the JAX ``raw_mode``)."""
    if (not hasattr(dataset, "get_raw") or getattr(dataset, "transform", None) is not None
            or getattr(dataset, "input_type", "RGB") != "RGB"):
        raise NotImplementedError("wsi_inference takes a dataset of raw RGB patches "
                                  "(get_raw, no host transform); host transforms, stain "
                                  "inputs and blank-field correction are ROADMAP A5")


def wsi_inference(
    model: torch.nn.Module,
    dataset,
    nrow: int,
    selective: bool = False,
    cut_off: float = 0.5,
    batch_size: int = 32,
    save_dir: Optional[str] = None,
    num_workers: int = 16,
    device=None,
) -> Dict[str, Dict]:
    """Stitched whole-slide inference + per-patch / per-WSI scoring.

    Args:
        model: an eval-mode model; it is moved to ``device``.
        dataset: a ``data.dataset.PatchDataset`` (``input_list`` names
            {slide_id}_{x}_{y}_input.*; ``get_raw``); every patch of a slide
            is stitched into one canvas of ``nrow`` rows.
        device: ``None`` is ``cuda:0`` and raises without a card.
    Returns:
        {slide_id: {"prob", "pred", "label", "sample", "heatmap",
                    "patch_scores", "patch_scores_mean", "wsi_score"}}
    """
    _check_dataset(dataset)
    device = resolve_device(device)
    model.to(device)
    ids = [name.split("_input")[0] for name in dataset.input_list]

    results: Dict[str, Dict] = {}
    # the decode (PIL releases the GIL) and the per-patch scores run on a pool
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for slide, indices in _group_by_slide(ids).items():
            decoded = list(pool.map(dataset.get_raw, indices))
            inputs_u8 = np.stack([d[0] for d in decoded])
            labels = np.stack([d[1] for d in decoded])
            inputs = inputs_u8.astype(np.float32) / 255.0  # display canvas

            # launch every batch before copying any back
            outs = [_wsi_forward(model, device_ingest(inputs_u8[i : i + batch_size], device),
                                 selective)
                    for i in range(0, len(indices), batch_size)]
            prob = torch.cat(outs).float().cpu().numpy()
            pred = (prob > cut_off).astype(np.uint8)

            patch_scores = list(pool.map(
                lambda j: get_performance(labels[j], prob[j], pred[j]),
                range(len(indices)),
            ))
            prob_c = stitch_patches(prob, nrow)
            pred_c = stitch_patches(pred, nrow)
            label_c = stitch_patches(labels, nrow)
            sample_c = stitch_patches(inputs, nrow)
            wsi_score = get_performance(label_c, prob_c, pred_c)

            entry = {
                "prob": prob_c,
                "pred": pred_c,
                "label": label_c,
                "sample": sample_c,
                "heatmap": make_heatmap(prob_c),
                "patch_scores": np.asarray(patch_scores, dtype=np.float64),
                "patch_scores_mean": np.nanmean(np.asarray(patch_scores, np.float64), axis=0),
                "wsi_score": wsi_score,
            }
            results[slide] = entry

            if save_dir is not None:
                from PIL import Image

                os.makedirs(save_dir, exist_ok=True)
                Image.fromarray((entry["heatmap"] * 255).astype(np.uint8)).save(
                    os.path.join(save_dir, f"{slide}_heatmap.png"))
                Image.fromarray((pred_c * 255).astype(np.uint8)).save(
                    os.path.join(save_dir, f"{slide}_pred.png"))

    if save_dir is not None:
        save_performance_as_csv(
            save_dir,
            [[s] + list(r["wsi_score"]) for s, r in results.items()],
            "wsi_performance",
            header=["slide", "accuracy", "recall", "precision", "f1 score", "AUC score"],
        )
    return results


def build_parser():
    """The JAX ``snet-wsi`` flag surface."""
    import argparse

    from ..config import parse_bool

    parser = argparse.ArgumentParser(
        description="stitched whole-slide inference + per-patch/per-WSI scoring")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--test_fold", type=int, default=1)
    parser.add_argument("--model_path", default=None,
                        help="one specific .ckpt/.pth checkpoint")
    parser.add_argument("--model_dir", default=None,
                        help="checkpoint dir: digit-latest model_epoch{N} wins")
    parser.add_argument("--model_arch", default="UNet_B", choices=["UNet", "UNet_B"])
    parser.add_argument("--n_cls", type=int, default=2)
    parser.add_argument("--selective", type=parse_bool, default=False)
    parser.add_argument("--input_type", default="RGB", choices=["RGB", "GH", "H_RGB"])
    parser.add_argument("--blankfield", type=parse_bool, default=False,
                        help="apply blank-field correction (ROADMAP A5: refused)")
    parser.add_argument("--patch_mag", type=int, default=200)
    parser.add_argument("--patch_size", type=int, default=256)
    parser.add_argument("--nrow", type=int, required=True,
                        help="rows in each slide's patch grid (the notebook's "
                             "3x6 layout used nrow=3, cell 4)")
    parser.add_argument("--cut_off", type=float, default=0.5)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--num_workers", type=int, default=16)
    parser.add_argument("--compute_dtype", default="bfloat16")
    parser.add_argument("--quantize", default="none", choices=["none", "int8"],
                        help="int8: W8A8 quantized serving trunk (ROADMAP A10: refused)")
    parser.add_argument("--calib_patches", type=int, default=8,
                        help="how many patches calibrate the int8 activation "
                             "scales (--quantize int8)")
    parser.add_argument("--save_dir", default=None,
                        help="write {slide}_heatmap.png / {slide}_pred.png + "
                             "wsi_performance.csv here")
    return parser


def main(argv=None, device=None) -> Dict[str, Dict]:
    """CLI (``snet-wsi``): stitched whole-slide scoring over a test fold
    (u-net_testing.ipynb cells 4-8). Runs on ``cuda:0`` unless ``device``
    names another device. Returns ``wsi_inference``'s results."""
    from ..data.dataset import PatchDataset
    from ..data.folds import construct_test
    from ..models import build_model, load_weights
    from ..utils.checkpoint import load_net_checkpoint, resolve_checkpoint

    parser = build_parser()
    a = parser.parse_args(argv)
    if a.input_type != "RGB" or a.blankfield:
        raise NotImplementedError("only RGB input is ported (--input_type GH|H_RGB and "
                                  "--blankfield 1 are ROADMAP A5)")
    if a.quantize == "int8":
        raise NotImplementedError("the int8 serving trunk (--quantize int8) is not ported "
                                  "yet: ROADMAP A10")
    try:
        ckpt = resolve_checkpoint(a.model_path, a.model_dir)
    except ValueError as e:
        parser.error(str(e))

    model = build_model(a.model_arch, a.n_cls, a.selective, a.compute_dtype)
    load_weights(model, load_net_checkpoint(ckpt))
    data_list = construct_test(a.data_dir, test_fold=a.test_fold)
    dataset = PatchDataset(a.data_dir, data_list, a.patch_mag, a.patch_size, a.input_type)
    print(f"checkpoint: {ckpt} ({a.model_arch}, selective={a.selective})")
    print(f"test fold {a.test_fold}: {len(dataset)} patches")

    results = wsi_inference(
        model, dataset, a.nrow, selective=a.selective, cut_off=a.cut_off,
        batch_size=a.batch_size, save_dir=a.save_dir, num_workers=a.num_workers,
        device=device,
    )
    if not results:
        print(f"no slides found in test fold {a.test_fold} of {a.data_dir}")
        return results
    header = ("accuracy", "recall", "precision", "f1", "auc")
    fmt = lambda vals: " ".join(f"{m}={v:.4f}" for m, v in zip(header, vals))  # noqa: E731
    wsi_scores = []
    for slide, entry in results.items():
        wsi_scores.append(entry["wsi_score"])
        print(f"[{slide}] WSI {fmt(entry['wsi_score'])}")
        print(f"[{slide}] patch-mean {fmt(entry['patch_scores_mean'])}")
    mean = np.nanmean(np.asarray(wsi_scores, np.float64), axis=0)
    print(f"[nanmean over {len(results)} slides] {fmt(mean)}")
    return results


if __name__ == "__main__":
    main()
