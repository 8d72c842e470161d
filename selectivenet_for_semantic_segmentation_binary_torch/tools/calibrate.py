"""Selection-threshold calibration and the risk-coverage curve (``snet-calibrate``).

Counterpart of the JAX package's ``tools/calibrate.py``: the reference
evaluates at a fixed ``--s_cut_off 0.5`` (eval.py:45), so the share of
pixels it rejects is whatever the selection head gives there. This tool
picks the threshold that gives a REQUESTED coverage on a calibration split
(SelectiveNet's post-hoc calibration): one pass of the selective model
builds a histogram of the selection confidence g = sigmoid(selection) over
the valid pixels on the device, and the (1 - coverage)-quantile of it is
the threshold. ``--curve_csv`` also sweeps the whole risk-coverage curve
from a joint histogram of (g bin, prediction correct).

Usage (on the first card; from Python, ``main(argv, device="cpu")`` runs
on the CPU)::

    python -m selectivenet_for_semantic_segmentation_binary_torch.tools.calibrate \\
        --data_dir DATA --fold 1 --model_dir MODELS/1-fold/checkpoint \\
        --model_arch UNet_B --target_coverage 0.8 --split valid

then evaluate with the printed ``--s_cut_off``. The histograms are
fixed-shape ``index_add_`` counts on the device (invalid pixels go to a
scratch bin that is dropped), summed there over the batches and copied to
the host once. ``--blankfield 1`` and ``--input_type`` other than RGB are
ROADMAP A5 and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import EvalConfig, parse_bool
from ..train_lib import device_preprocess, resolve_device

N_BINS = 4096
_HEAD_ERROR = ("applies to binary (BCE-form, UNet_B) selection heads only; CE-form "
               "selection is argmax-evaluated")


def _bins(selection: torch.Tensor, label: torch.Tensor, n_cls: int) -> torch.Tensor:
    """Each pixel's bin of g = sigmoid(selection), truncated as ``astype(int32)``
    truncates; ``N_BINS`` (the scratch bin) where the label is not a class."""
    g = torch.sigmoid(selection.float())
    idx = torch.clamp((g * N_BINS).to(torch.int32), 0, N_BINS - 1)
    valid = (label >= 0) & (label < n_cls)
    return torch.where(valid, idx, N_BINS).reshape(-1)


def _count(index: torch.Tensor, size: int) -> torch.Tensor:
    counts = torch.zeros(size, dtype=torch.int32, device=index.device)
    return counts.index_add_(0, index, torch.ones_like(index))


def make_histogram_step(model: torch.nn.Module, n_cls: int):
    """``step(batch) -> int32[N_BINS]`` on the device: the histogram of the
    selection confidence sigmoid(selection) over the batch's valid pixels.

    The histogram lives in sigmoid space: sigmoid is monotonic, so quantiles
    commute, and the caller maps the threshold back to logit space where
    eval compares raw logits (``single_scale != 'sigmoid'``)."""

    def step(batch):
        x, label = device_preprocess(batch)
        with torch.inference_mode():
            _output, selection, _aux = model(x)
            if selection.ndim != 3:
                raise ValueError(f"s_cut_off calibration {_HEAD_ERROR}")
            return _count(_bins(selection, label, n_cls), N_BINS + 1)[:N_BINS]

    return step


def make_rc_histogram_step(model: torch.nn.Module, cfg: EvalConfig):
    """``step(batch) -> int32[N_BINS, 2]`` on the device: the joint histogram
    of (selection-confidence bin, prediction correct) over the valid pixels,
    the sufficient statistic of the whole risk-coverage curve."""
    apply_sigmoid = getattr(cfg, "single_scale", "sigmoid") == "sigmoid"

    def step(batch):
        x, label = device_preprocess(batch)
        with torch.inference_mode():
            output, selection, _aux = model(x)
            if selection.ndim != 3:
                raise ValueError(f"risk-coverage analysis {_HEAD_ERROR}")
            prob = torch.sigmoid(output) if apply_sigmoid else output
            correct = ((prob > cfg.cut_off).to(torch.int32) == label).to(torch.int32)
            index = 2 * _bins(selection, label, cfg.n_cls) + correct.reshape(-1)
            return _count(index, 2 * (N_BINS + 1)).reshape(N_BINS + 1, 2)[:N_BINS]

    return step


def curve_from_histogram(hist2d: np.ndarray) -> Dict[str, np.ndarray]:
    """(N_BINS, 2) [incorrect, correct] counts -> monotone coverage sweep.

    Row i of the output is the operating point 's_cut_off = i / N_BINS'
    (sigmoid space): coverage = P(g >= t), selective_risk = P(wrong | g >= t)
    — the standard SelectiveNet risk-coverage trade-off curve."""
    total = int(hist2d.sum())
    if total == 0:
        raise ValueError("empty calibration split")
    tail = np.cumsum(hist2d[::-1], axis=0)[::-1].astype(np.float64)
    selected = tail.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        risk = np.where(selected > 0, tail[:, 0] / selected, np.nan)
    return {
        "threshold": np.arange(N_BINS) / N_BINS,
        "coverage": selected / total,
        "selective_risk": risk,
        "selective_accuracy": 1.0 - risk,
    }


def _accumulate(loader, step) -> np.ndarray:
    """The batches' histograms summed in int64 on the device; one copy to the
    host after the loop, so the decode never waits for a fetch."""
    total = None
    for batch in loader:
        device_batch = {k: batch[k] for k in ("input", "label", "flips") if k in batch}
        hist = step(device_batch).to(torch.int64)
        total = hist if total is None else total + hist
    if total is None:
        raise ValueError("empty calibration split")
    return total.cpu().numpy()


def _check_supported(cfg: EvalConfig) -> None:
    if cfg.input_type != "RGB" or cfg.blankfield:
        raise NotImplementedError("only RGB input is ported (--input_type GH|H_RGB and "
                                  "--blankfield 1 are ROADMAP A5)")


def _load_single(cfg: EvalConfig, device, verbose: bool = True) -> torch.nn.Module:
    """The digit-latest checkpoint of ``cfg.model_dir`` as an eval-mode
    selective UNet_B on ``device``: unlike eval, which would ensemble every
    file, calibration targets one model (the resume convention,
    net_utils.py:18-24)."""
    from ..models import build_model, load_weights
    from ..utils.checkpoint import list_checkpoints, load_latest_checkpoint

    if not cfg.selective:
        raise ValueError("calibration requires a selective model")
    if cfg.model_arch[0] != "UNet_B":
        raise ValueError(
            "s_cut_off calibration applies to binary (BCE-form, UNet_B) "
            "selection heads only; CE-form (UNet) selection is argmax-evaluated"
        )
    found = load_latest_checkpoint(cfg.model_dir)  # parses the winner once
    if found is None:
        raise FileNotFoundError(f"no .ckpt/.pth checkpoints in {cfg.model_dir}")
    _path, epoch, payload = found
    n = len(list_checkpoints(cfg.model_dir))
    if verbose and n > 1:
        print(f"calibrating the digit-latest of {n} checkpoints: epoch {epoch}")
    model = build_model(cfg.model_arch[0], cfg.n_cls, cfg.selective, cfg.compute_dtype)
    return load_weights(model, payload["net"]).to(device)


def _to_eval_space(t, single_scale: str):
    """Sigmoid-space threshold(s) -> whatever space eval will threshold in:
    identity for --single_scale sigmoid, else the (monotonic) logit — eval's
    non-sigmoid modes compare RAW selection logits (eval.py:241-243)."""
    if single_scale == "sigmoid":
        return t
    lo, hi = 1.0 / (2 * N_BINS), 1.0 - 1.0 / (2 * N_BINS)
    t = np.clip(np.asarray(t, np.float64), lo, hi)
    out = np.log(t / (1.0 - t))
    return float(out) if out.ndim == 0 else out


def _histogram(cfg: EvalConfig, data_list, device, verbose: bool, make_step):
    from ..eval_lib import make_eval_loader

    _check_supported(cfg)
    device = resolve_device(device)
    model = _load_single(cfg, device, verbose)
    return _accumulate(make_eval_loader(cfg, device, data_list=data_list), make_step(model))


def risk_coverage_curve(cfg: EvalConfig, data_list=None, csv_path: Optional[str] = None,
                        verbose: bool = True, device=None) -> Dict[str, np.ndarray]:
    """Full risk-coverage trade-off of a selective checkpoint in one pass.

    The returned/written ``threshold`` column is in EVAL space (sigmoid for
    --single_scale sigmoid, raw-logit otherwise), so any row's s_cut_off can
    be passed to eval directly. Also returns ``histogram2d``: its
    ``sum(axis=1)`` marginal is exactly the calibration histogram, so callers
    needing both never run the split twice. ``device`` defaults to the
    first card and raises without one."""
    hist2d = _histogram(cfg, data_list, device, verbose,
                        lambda model: make_rc_histogram_step(model, cfg))
    curve = curve_from_histogram(hist2d)
    single_scale = getattr(cfg, "single_scale", "sigmoid")
    curve["threshold"] = _to_eval_space(curve["threshold"], single_scale)
    curve["histogram2d"] = hist2d

    if csv_path:
        d = os.path.dirname(csv_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["s_cut_off", "coverage", "selective_risk", "selective_accuracy"])
            for i in range(N_BINS):
                w.writerow([curve["threshold"][i], curve["coverage"][i],
                            curve["selective_risk"][i], curve["selective_accuracy"][i]])
        if verbose:
            print(f"risk-coverage curve ({N_BINS} points, thresholds in "
                  f"--single_scale {single_scale} eval space) -> {csv_path}")
    if verbose:
        for cov in (1.0, 0.9, 0.8, 0.7, 0.5):
            i = int(np.argmin(np.abs(curve["coverage"] - cov)))
            print(f"    coverage {curve['coverage'][i]:.3f} @ s_cut_off "
                  f"{curve['threshold'][i]:.4f}: selective accuracy "
                  f"{curve['selective_accuracy'][i]:.4f}")
    return curve


def threshold_for_coverage(hist: np.ndarray, target_coverage: float) -> Dict[str, float]:
    """Largest bin edge t with P(g >= t) >= target_coverage — the
    (1 - coverage)-quantile, erring on the inclusive side so the achieved
    coverage is never below the request (up to one bin of granularity)."""
    total = int(hist.sum())
    if total == 0:
        raise ValueError("empty calibration split")
    # cov[i] = fraction of pixels with g >= the lower edge of bin i
    cov = (np.cumsum(hist[::-1])[::-1] / total).astype(np.float64)
    ok = np.nonzero(cov >= target_coverage)[0]
    bin_idx = int(ok[-1]) if len(ok) else 0
    return {
        "s_cut_off": bin_idx / N_BINS,
        "achieved_coverage": float(cov[bin_idx]),
        "n_pixels": total,
    }


def calibrate(cfg: EvalConfig, target_coverage: float = 0.8, data_list=None,
              verbose: bool = True, device=None) -> Dict[str, float]:
    """Calibrate s_cut_off for ``target_coverage`` on the test fold (or an
    explicit ``data_list`` — pass the VALID split to keep the test fold
    untouched, the methodologically clean choice). ``device`` defaults to
    the first card and raises without one."""
    hist = _histogram(cfg, data_list, device, verbose,
                      lambda model: make_histogram_step(model, cfg.n_cls))
    return _finish_calibration(hist, target_coverage,
                               getattr(cfg, "single_scale", "sigmoid"), verbose)


def _finish_calibration(hist: np.ndarray, target_coverage: float, single_scale: str,
                        verbose: bool) -> Dict[str, float]:
    res = threshold_for_coverage(hist, target_coverage)
    res["s_cut_off"] = _to_eval_space(res["s_cut_off"], single_scale)
    res["space"] = "sigmoid" if single_scale == "sigmoid" else "logit"
    if verbose:
        print(f"calibrated on {res['n_pixels']:,} pixels: "
              f"--s_cut_off {res['s_cut_off']:.6f} ({res['space']} space, "
              f"--single_scale {single_scale}) "
              f"-> empirical coverage {res['achieved_coverage']:.4f} "
              f"(requested {target_coverage})")
    return res


def build_parser() -> argparse.ArgumentParser:
    """The JAX ``snet-calibrate`` flag surface."""
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--fold", "--test_fold", dest="fold", type=int, required=True)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--model_arch", default="UNet_B")
    p.add_argument("--input_type", default="RGB")
    p.add_argument("--patch_mag", type=int, default=200)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--n_cls", type=int, default=2)
    p.add_argument("--blankfield", type=parse_bool, default=False,
                   help="apply blank-field correction (ROADMAP A5: refused)")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--single_scale", default="sigmoid",
                   choices=["None", "clip", "minmax", "sigmoid"],
                   help="must match the --single_scale you will evaluate with; "
                        "non-sigmoid modes get a raw-logit threshold")
    p.add_argument("--target_coverage", type=float, default=0.8)
    p.add_argument("--split", choices=["test", "valid"], default="valid",
                   help="calibration split; 'valid' keeps the test fold clean")
    p.add_argument("--seed", type=int, default=42,
                   help="train/valid split seed — must match the --seed the "
                        "model was trained with, or the 'valid' split overlaps "
                        "the training data and biases the threshold")
    p.add_argument("--curve_csv", default=None,
                   help="also sweep the full risk-coverage curve and write it "
                        "as CSV (s_cut_off, coverage, risk, accuracy rows)")
    return p


def main(argv=None, device=None) -> Dict[str, float]:
    """CLI (``snet-calibrate``); runs on ``cuda:0`` unless ``device`` names
    another device. Returns the calibration result."""
    a = build_parser().parse_args(argv)
    cfg = EvalConfig(
        data_dir=a.data_dir, test_fold=a.fold, model_dir=a.model_dir,
        model_arch=[a.model_arch], selective=True, select_eval=True,
        input_type=a.input_type, patch_mag=a.patch_mag, patch_size=a.patch_size,
        n_cls=a.n_cls, batch_size=a.batch_size, single_scale=a.single_scale,
        blankfield=a.blankfield,
    )
    data_list = None
    if a.split == "valid":
        from ..data.folds import construct_train_valid

        _train, data_list = construct_train_valid(a.data_dir, test_fold=a.fold, seed=a.seed)
    if a.curve_csv:
        # one pass serves both: the rc histogram's correctness marginal IS
        # the calibration histogram
        curve = risk_coverage_curve(cfg, data_list=data_list, csv_path=a.curve_csv,
                                    device=device)
        return _finish_calibration(curve["histogram2d"].sum(axis=1), a.target_coverage,
                                   a.single_scale, True)
    return calibrate(cfg, a.target_coverage, data_list=data_list, device=device)


if __name__ == "__main__":
    main()
