"""Evaluation: single model, ensemble mean, and selective in-coverage.

Counterpart of the JAX package's ``eval_lib.py:44-416`` (reference
eval.py:76-280), with ``device_preprocess`` from the port's ``train_lib``
(the JAX package's ``train_lib.py:87-111``):

* every .ckpt/.pth in ``model_dir`` is loaded; one ``model_arch`` entry is
  replicated across them;
* single model: forward, sigmoid if ``single_scale == 'sigmoid'`` (the other
  modes are no-ops at the threshold stage), threshold at ``cut_off``;
* ensemble: each member's output rescaled by ``ens_scale``, then averaged;
  selective ensembles are rejected as in the reference (eval.py:208);
* ``select_eval``: the selection map, thresholded at ``s_cut_off``, masks the
  confusion counts, and the rejection ratio is reported.

On a single binary-head model with ``use_pallas`` (the flag's name is kept
for the CLI; in the port it switches the hand-written CUDA kernel), the
metrics after the forward run in ``ops.eval_metrics.fused_eval_metrics``:
the CUDA kernel for tensors on the card, its plain version for tensors on
the CPU. Every count stays on the device until the loop ends.

The feed is ``train_lib``'s: raw uint8 for RGB normalised on the device,
else the host's float feed (``--input_type GH|H_RGB``, ``--blankfield 1``,
``--device_preproc 0``), whose batches the step takes as they are.

``--quantize int8`` scores the W8A8 serving trunk (K10 on the card): each
member folded, calibrated on the test fold's first ``--calib_patches``
patches on its own, and quantized (``_quantize_models``); the metrics stay
on K1.

On a fleet (``parallel/multihost.py``, JAX eval_lib.py:238-270, 315-400)
each rank scores its slice of every batch: a single binary-head model keeps
K1 on its shard, and the integer counts (confusion matrix, ``n_pix``,
``n_reject``) are summed over the ranks once at the end, which gives what
one process counts on the same outputs; an ensemble's ``minmax`` rescale
takes the global batch's extrema. Rank 0 alone prints and writes the CSV.
``--sp_ways s`` (JAX eval_lib.py:315) gives each rank a block of rows of
its data-parallel group's examples (``train_lib.fleet_rows``), and each
model's 3x3 blocks swap one-row halos within the sp group
(``models.set_process_group``); each rank scores its rows (K1 on its
block) and the counts are summed as on any fleet.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .config import EvalConfig, validate_output_dim
from .data.dataset import PatchDataset
from .data.folds import construct_test
from .data.loader import PatchLoader
from .data.transforms import BlankfieldCorrection, Compose
from .models import build_model, load_weights, set_process_group
from .ops.confusion import confusion_matrix_update
from .ops.eval_metrics import fused_eval_metrics
from .parallel import multihost
from .parallel.mesh import all_reduce_, make_mesh_dp_sp
from .train_lib import (check_rows_split, device_preprocess, fleet_rows, host_transforms,
                        raw_feed, resolve_device)
from .utils.checkpoint import list_checkpoints, load_net_checkpoint
from .utils.metrics import Evaluator


def _rescale(output: torch.Tensor, mode: str,
             valid: Optional[torch.Tensor] = None, pg=None) -> torch.Tensor:
    """Per-member ensemble rescale (reference eval.py:209-222). ``valid``
    keeps padded pixels out of the minmax extrema, which on a fleet
    (``pg``) are the global batch's."""
    if mode == "sigmoid":
        return torch.sigmoid(output)
    if mode == "clip":
        return output.clamp(0.0, 1.0)
    if mode == "minmax":
        if valid is not None:
            while valid.ndim < output.ndim:
                valid = valid[..., None]
            lo = torch.where(valid, output, torch.inf).min()
            hi = torch.where(valid, output, -torch.inf).max()
        else:
            lo, hi = output.min(), output.max()
        lo, hi = all_reduce_(lo.clone(), pg, "min"), all_reduce_(hi.clone(), pg, "max")
        return (output - lo) / (hi - lo)
    return output


def _threshold_scale(output: torch.Tensor, mode: str) -> torch.Tensor:
    """Threshold-stage rescale: only 'sigmoid' acts (reference
    eval.py:230-233, 241-243)."""
    return torch.sigmoid(output) if mode == "sigmoid" else output


def check_supported(cfg: EvalConfig) -> None:
    """Refuse a configuration the port would not run as its flags say, before
    anything is built: an inert ``--output_dim`` and an unknown
    ``--quantize``, and ``--sp_ways`` > 1 for TransUNet
    (``train_lib.check_rows_split``)."""
    validate_output_dim(cfg)
    for arch in cfg.model_arch:
        check_rows_split(arch, cfg.sp_ways)
    q = cfg.quantize
    if q not in ("none", "int8"):
        raise ValueError(f"unknown --quantize {q!r} (expected 'none' or 'int8')")


def _quantize_models(cfg: EvalConfig, paths: List[str], device,
                     verbose: bool) -> List[torch.nn.Module]:
    """``--quantize int8`` (JAX ``_quantize_models``, eval_lib.py:273-306):
    each checkpoint folded, calibrated and quantized on its own (the
    members' activations differ), on the test fold's first
    ``--calib_patches`` patches (inputs only), decoded [0, 1] with the
    stain conversion and blank-field correction the eval feed applies."""
    from .ops.quant import quantize_serving

    n_want = int(cfg.calib_patches)
    if n_want < 1:
        raise ValueError(f"--calib_patches must be >= 1, got {n_want}")
    transform = Compose([BlankfieldCorrection()]) if cfg.blankfield else None
    ds = PatchDataset(cfg.data_dir, construct_test(cfg.data_dir, test_fold=cfg.test_fold),
                      cfg.patch_mag, cfg.patch_size, cfg.input_type, transform=transform)
    n_calib = min(n_want, len(ds))
    calib = np.stack([np.asarray(ds[i]["input"], np.float32) for i in range(n_calib)])
    models = [quantize_serving(cfg.model_arch[0], cfg.n_cls, cfg.selective, cfg.compute_dtype,
                               load_net_checkpoint(p), calib, device, in_ch=cfg.input_channels)
              for p in paths]
    if verbose:
        print(f"    int8 serving trunk: {len(models)} model(s) calibrated on {n_calib} patches")
    return models


def load_models(cfg: EvalConfig, device, verbose: bool = False) -> List[torch.nn.Module]:
    """Discover and load every checkpoint (reference eval.py:116-157)."""
    paths = list_checkpoints(cfg.model_dir)
    if not paths:
        raise FileNotFoundError(f"no .ckpt/.pth checkpoints in {cfg.model_dir}")
    arch_list = list(cfg.model_arch)
    if len(paths) != 1 and len(arch_list) == 1:
        arch_list = arch_list * len(paths)
    if len(arch_list) != len(paths):
        raise ValueError(
            f"model_arch count ({len(arch_list)}) must match the number of "
            f"checkpoints in {cfg.model_dir} ({len(paths)})")
    if len(set(arch_list)) != 1:
        raise ValueError("mixed architectures in one ensemble are unsupported "
                         f"(got {sorted(set(arch_list))})")
    if cfg.quantize == "int8":
        models = _quantize_models(cfg, paths, device, verbose)
    else:
        models = [load_weights(build_model(arch_list[0], cfg.n_cls, cfg.selective,
                                           cfg.compute_dtype, in_ch=cfg.input_channels,
                                           img_size=cfg.patch_size),
                               load_net_checkpoint(p)).to(device) for p in paths]
    if cfg.info_print:
        for p, a in zip(paths, arch_list):
            print(f"    {p} - {a} / SelectiveNet: {cfg.selective}")
    return models


def make_eval_step(models: List[torch.nn.Module], cfg: EvalConfig, use_kernel: bool,
                   pg=None) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """batch -> {"cm" (C, C) int64, "n_pix"[, "n_reject"]}, all on the device.

    ``use_kernel`` routes a single binary-head model's metrics through
    ``fused_eval_metrics``; the other cases count with
    ``confusion_matrix_update``. On a fleet (``pg``) ``batch`` is this
    rank's slice and so are the counts."""
    n_models = len(models)
    selective, select_eval = bool(cfg.selective), bool(cfg.select_eval)
    if n_models > 1 and selective:
        raise ValueError("selective evaluation of an ensemble is unsupported "
                         "(reference eval.py:208)")

    def forward_single(model, x):
        out = model(x)
        if selective:
            return out[0], out[1]
        return out, None

    @torch.inference_mode()
    def step(batch):
        x, label = device_preprocess(batch)
        valid_px = (label >= 0) & (label < cfg.n_cls)

        if n_models == 1:
            output, selection = forward_single(models[0], x)
            if (use_kernel and output.ndim == 3 and cfg.n_cls == 2
                    and (selection is not None or not select_eval)):
                res = fused_eval_metrics(
                    output, label, selection if select_eval else None,
                    apply_sigmoid=(cfg.single_scale == "sigmoid"),
                    selective=select_eval, cut_off=cfg.cut_off,
                    s_cut_off=cfg.s_cut_off)
                metrics = {"cm": res["cm"], "n_pix": res["n_pix"]}
                if select_eval:
                    metrics["n_reject"] = res["n_reject"]
                return metrics
        else:
            # per-member rescale before the mean (reference eval.py:213-220)
            outputs = [_rescale(forward_single(m, x)[0], cfg.ens_scale, valid=valid_px, pg=pg)
                       for m in models]
            output = torch.stack(outputs).mean(0)
            selection = None

        if output.ndim == 3:
            pred = (_threshold_scale(output, cfg.single_scale) > cfg.cut_off).long()
        else:
            pred = output.argmax(-1)

        valid = valid_px.long()
        metrics: Dict[str, Any] = {"n_pix": valid.sum()}
        sel_mask = None
        if select_eval:
            if selection is None:
                raise ValueError("--select_eval 1 requires --selective 1 and a "
                                 "selective checkpoint")
            if selection.ndim == 3:
                s = _threshold_scale(selection, cfg.single_scale)
                sel_mask = (s > cfg.s_cut_off).long()
            else:
                sel_mask = selection.argmax(-1)
            metrics["n_reject"] = metrics["n_pix"] - (sel_mask * valid).sum()
        metrics["cm"] = confusion_matrix_update(label, pred, cfg.n_cls, sel_mask)
        return metrics

    return step


def make_eval_loader(cfg: EvalConfig, device, data_list=None) -> PatchLoader:
    """The no-shuffle loader of ``data_list`` (input, label) filename pairs,
    by default the test fold's (JAX ``make_eval_loader``, eval_lib.py:238):
    raw uint8 where ``train_lib.raw_feed`` says so, else the float feed with
    blank-field (if asked) and ``Normalization`` on the host; on a fleet
    each rank decodes its slice of every batch."""
    if data_list is None:
        data_list = construct_test(cfg.data_dir, test_fold=cfg.test_fold)
    raw = raw_feed(cfg)
    ds = PatchDataset(cfg.data_dir, data_list, cfg.patch_mag, cfg.patch_size,
                      cfg.input_type, transform=None if raw else host_transforms(cfg, False))
    return PatchLoader(ds, cfg.batch_size, num_workers=cfg.num_workers, device=device,
                       seed=cfg.seed, device_preproc=raw, **fleet_rows(cfg))


def save_performance_as_csv(save_dir: str, row, csv_name: str, header) -> str:
    """``{save_dir}/{csv_name}.csv`` with one header and one row (the JAX
    package's tools/wsi.py:56-66 format)."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{csv_name}.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerow(list(map(str, row)))
    return path


def evaluate(cfg: EvalConfig, loader: Optional[PatchLoader] = None,
             verbose: bool = True, device=None) -> Dict[str, Any]:
    """Full evaluation (reference eval.py:76-280); returns the metric dict,
    the same on every rank of a fleet. ``device`` defaults to the first
    card (this rank's on a fleet) and raises without one
    (``train_lib.resolve_device``); pass ``device="cpu"`` to run on the CPU.
    With ``--sp_ways`` a given ``loader`` yields this rank's row blocks
    (``train_lib.fleet_rows``)."""
    check_supported(cfg)
    device = resolve_device(device)
    pg = multihost.group()
    grid = make_mesh_dp_sp(cfg.n_devices, cfg.sp_ways, cfg.batch_size, cfg.patch_size)
    verbose = verbose and multihost.is_writer()
    models = [set_process_group(m, pg, grid.sp_group) for m in load_models(cfg, device, verbose)]
    n_models = len(models)

    if loader is None:
        loader = make_eval_loader(cfg, device)
        if cfg.info_print and verbose:
            print(f"Load Test Dataset ({cfg.test_fold}-fold)")
            print(f"    patch mag: {cfg.patch_mag}")
            print(f"    patch size: {cfg.patch_size}")
            print(f"    batch size: {cfg.batch_size}")
            print(f"    num workers: {cfg.num_workers}")
            print("     # of test dataset", len(loader.dataset))

    step = make_eval_step(models, cfg, use_kernel=bool(cfg.use_pallas) and n_models == 1,
                          pg=pg)
    cms, n_pix, n_reject = [], [], []
    for batch in loader:
        metrics = step(batch)
        cms.append(metrics["cm"])
        if cfg.select_eval:
            n_pix.append(metrics["n_pix"])
            n_reject.append(metrics["n_reject"])

    cms = torch.stack(cms)
    rejects = torch.stack([torch.stack(n_pix).sum(), torch.stack(n_reject).sum()]) if n_pix \
        else torch.zeros(2, dtype=torch.int64, device=cms.device)
    if pg is not None:  # the ranks' integer counts: exactly one process's sums
        packed = all_reduce_(torch.cat([cms.reshape(-1), rejects.to(cms.dtype)]), pg)
        cms, rejects = packed[:-2].reshape(cms.shape), packed[-2:]
    evaluator = Evaluator(num_class=cfg.n_cls)
    for cm in cms.cpu().numpy():
        evaluator.add_confusion_matrix(cm)
    total_pix, total_reject = (int(v) for v in rejects.cpu())

    prec = evaluator.get_Precision()
    recall = evaluator.get_Recall()
    results = {
        "confusion_matrix": evaluator.confusion_matrix.copy(),
        "accuracy": evaluator.get_Pixel_Accuracy(),
        "accuracy_class": evaluator.get_Pixel_Accuracy_Class(),
        "precision": prec,
        "recall": recall,
        "f1_score": evaluator.get_F1_Score(prec, recall),
        "mIoU": evaluator.get_mIoU(),
        "IoU_class": evaluator.get_IoU_Class(),
        "n_models": n_models,
    }
    if cfg.select_eval:
        results["rejection_ratio"] = total_reject / total_pix if total_pix else float("nan")

    if verbose:
        print(evaluator.confusion_matrix)
        if cfg.select_eval:
            print(f"    rejection ratio: {round(results['rejection_ratio'], 3)}")
        print(f"    Acc:{results['accuracy']}")
        print(f"    Acc_class:{results['accuracy_class']}")
        print(f"    Prec:{results['precision']}, Recall:{results['recall']}, "
              f"F1_Score:{results['f1_score']}")
        print(f"    mIoU:{results['mIoU']}")
        print(f"    IoU_class:{results['IoU_class']}")

    if cfg.save_dir and multihost.is_writer():  # one CSV writer a fleet
        fmt = lambda a: " ".join(f"{float(v):.6f}" for v in np.atleast_1d(a))
        row = [
            f"{results['accuracy']:.6f}", f"{results['accuracy_class']:.6f}",
            fmt(results["precision"]), fmt(results["recall"]),
            fmt(results["f1_score"]), f"{results['mIoU']:.6f}",
            fmt(results["IoU_class"]),
            f"{results['rejection_ratio']:.6f}" if cfg.select_eval else "",
            n_models,
        ]
        save_performance_as_csv(
            cfg.save_dir, row, f"eval_fold{cfg.test_fold}",
            header=["accuracy", "accuracy_class", "precision", "recall",
                    "f1_score", "mIoU", "IoU_class", "rejection_ratio", "n_models"])
    return results
