"""Offline dataset tooling: fold-list generation, non-tissue mining, imbalance report
(``snet-split``).

The port's own copy of the JAX package's ``tools/data_split.py:30-226``, host
numpy and PIL as there, with its own KFold (``_kfold_indices``): the card's
machine has no scikit-learn. ``tests/test_torch_data_split.py`` holds the
two to the same files.

Turns the reference's notebook workbench into library functions + CLI:

* ``build_fold_lists`` <- jupyters/tumor_label-based_data_split.ipynb cells 0-4:
  pair ``*_input.jpg`` / ``*_label.png`` files, classify a patch *tumorable* iff
  sum(label_png) > threshold_ratio * 255 * size^2 (default 10%), then 5-fold
  KFold(shuffle=True, random_state=44) applied separately per class, saving
  ``{i}-fold_{non_}tumorable_data.npy`` — the exact inputs
  data/folds.py consumes.
* ``mine_non_tissue`` <- jupyters/check_rgb_color_space.ipynb cell 10: harvest
  patches whose mean intensity exceeds a whiteness threshold (default 243) as
  extra all-zero-label negatives.
* ``tumor_pixel_report`` <- jupyters/class_imbalance_visualization.ipynb: per-fold
  tumor/benign pixel counts motivating the selective objective.
* ``tumor_proportion_histogram`` <- jupyters/tumor_label-based_data_split.ipynb
  cells 5-8: per-patch tumor-proportion distributions + decile counts at
  multiple patch sizes (256/512/1024).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image


def _paired_files(patch_dir: str) -> List[Tuple[str, str]]:
    files = sorted(os.listdir(patch_dir))
    inputs = [f for f in files if f.endswith("_input.jpg")]
    pairs = []
    for f in inputs:
        label = f.replace("_input.jpg", "_label.png")
        if os.path.exists(os.path.join(patch_dir, label)):
            pairs.append((f, label))
        else:
            print(f"unpaired input dropped: {f}")
    return pairs


def _kfold_indices(n: int, n_splits: int, seed: int) -> List[np.ndarray]:
    """scikit-learn's ``KFold(shuffle=True, random_state=seed)`` test folds,
    without scikit-learn: the indices shuffled by ``RandomState(seed)``, cut
    into ``n_splits`` runs (the first ``n % n_splits`` one longer), each run
    sorted, as ``KFold.split`` returns it through a mask.

    Falls back to shuffled round-robin when a class has fewer samples than
    folds (scikit-learn's KFold refuses; tiny synthetic datasets hit this)."""
    if n == 0:
        return [np.array([], dtype=int)] * n_splits
    if n < n_splits:
        perm = np.random.RandomState(seed).permutation(n)
        return [perm[i::n_splits] for i in range(n_splits)]
    indices = np.arange(n)
    np.random.RandomState(seed).shuffle(indices)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    stops = np.cumsum(sizes)
    return [np.sort(indices[stop - size:stop]) for size, stop in zip(sizes, stops)]


def build_fold_lists(
    data_dir: str,
    patch_mag: int = 200,
    patch_size: int = 256,
    threshold_ratio: float = 0.1,
    n_splits: int = 5,
    seed: int = 44,
    out_dir: Optional[str] = None,
) -> Dict[str, int]:
    """Generate the {i}-fold_{non_}tumorable_data.npy lists from a patch tree."""
    patch_dir = os.path.join(data_dir, f"{patch_mag}x_{patch_size}")
    out_dir = out_dir or data_dir
    pairs = _paired_files(patch_dir)
    if not pairs:
        raise FileNotFoundError(f"no *_input.jpg/*_label.png pairs in {patch_dir}")

    tumorable, non_tumorable = [], []
    for inp, lab in pairs:
        label = np.asarray(Image.open(os.path.join(patch_dir, lab)).convert("L"), np.int64)
        # tumorable iff sum over the 0/255 mask exceeds 10% of full-tumor mass
        # (tumor_label-based_data_split.ipynb cell 0)
        if label.sum() > threshold_ratio * 255 * label.size:
            tumorable.append((inp, lab))
        else:
            non_tumorable.append((inp, lab))

    os.makedirs(out_dir, exist_ok=True)
    for class_name, items in (("tumorable", tumorable), ("non_tumorable", non_tumorable)):
        arr = np.array(items) if items else np.empty((0, 2), dtype="<U64")
        folds = _kfold_indices(len(items), n_splits, seed) if items else [np.array([], int)] * n_splits
        for i, idx in enumerate(folds):
            np.save(
                os.path.join(out_dir, f"{i + 1}-fold_{class_name}_data.npy"),
                arr[idx] if len(items) else arr,
            )
    return {"tumorable": len(tumorable), "non_tumorable": len(non_tumorable)}


def mine_non_tissue(
    data_dir: str,
    out_dir: str,
    patch_mag: int = 200,
    patch_size: int = 256,
    whiteness_threshold: float = 243.0,
) -> int:
    """Copy near-white (background) patches to out_dir with all-zero labels
    (check_rgb_color_space.ipynb cell 10). Returns the number mined."""
    patch_dir = os.path.join(data_dir, f"{patch_mag}x_{patch_size}")
    os.makedirs(out_dir, exist_ok=True)
    mined = 0
    for inp, _lab in _paired_files(patch_dir):
        img = np.asarray(Image.open(os.path.join(patch_dir, inp)))
        if img.mean() > whiteness_threshold:
            Image.fromarray(img).save(os.path.join(out_dir, inp))
            zero = np.zeros(img.shape[:2], np.uint8)
            Image.fromarray(zero).save(
                os.path.join(out_dir, inp.replace("_input.jpg", "_label.png"))
            )
            mined += 1
    return mined


def tumor_pixel_report(data_dir: str, patch_mag: int = 200, patch_size: int = 256,
                       n_splits: int = 5) -> Dict[int, Dict[str, int]]:
    """Per-fold tumor/benign pixel counts (class_imbalance_visualization.ipynb)."""
    patch_dir = os.path.join(data_dir, f"{patch_mag}x_{patch_size}")
    report: Dict[int, Dict[str, int]] = {}
    for fold in range(1, n_splits + 1):
        tumor_px = benign_px = 0
        for class_name in ("tumorable", "non_tumorable"):
            path = os.path.join(data_dir, f"{fold}-fold_{class_name}_data.npy")
            if not os.path.exists(path):
                continue
            for _inp, lab in np.load(path):
                label = np.asarray(Image.open(os.path.join(patch_dir, lab)).convert("L"))
                t = int((label > 0).sum())
                tumor_px += t
                benign_px += label.size - t
        total = tumor_px + benign_px
        report[fold] = {
            "tumor_pixels": tumor_px,
            "benign_pixels": benign_px,
            "tumor_ratio": tumor_px / total if total else 0.0,
        }
    return report


def tumor_proportion_histogram(
    data_dir: str,
    patch_mag: int = 200,
    patch_sizes: Tuple[int, ...] = (256, 512, 1024),
) -> Dict[int, Dict[str, object]]:
    """Per-patch tumor-proportion distribution at multiple patch sizes
    (tumor_label-based_data_split.ipynb cells 5-8).

    For every ``{patch_mag}x_{size}`` tree present under ``data_dir``, computes
    each patch's tumor proportion ``round(sum(label) / (255 * size^2), 3)``
    (cell 5) and the 10-decile counts the notebook prints (cell 6:
    ``count_w_10_cutoffs``). Sizes whose tree is absent are skipped.

    Returns {size: {"proportions": [...], "decile_counts": [10 ints],
                    "mean": float, "n_patches": int}}.
    """
    report: Dict[int, Dict[str, object]] = {}
    for size in patch_sizes:
        patch_dir = os.path.join(data_dir, f"{patch_mag}x_{size}")
        if not os.path.isdir(patch_dir):
            continue
        props: List[float] = []
        for _inp, lab in _paired_files(patch_dir):
            label = np.asarray(
                Image.open(os.path.join(patch_dir, lab)).convert("L"), np.int64
            )
            props.append(round(float(label.sum()) / (255.0 * size * size), 3))
        # decile bins with the notebook's <=-cutoff semantics (cell 6):
        # bin k holds proportions in (k/10, (k+1)/10], bin 0 includes 0
        counts = [0] * 10
        for p in props:
            k = min(int(np.ceil(p * 10)) - 1, 9) if p > 0 else 0
            counts[max(k, 0)] += 1
        report[size] = {
            "proportions": props,
            "decile_counts": counts,
            "mean": float(np.mean(props)) if props else 0.0,
            "n_patches": len(props),
        }
    return report


def main(argv=None) -> None:
    """CLI: python -m selectivenet_for_semantic_segmentation_binary_torch.tools.data_split"""
    import argparse

    parser = argparse.ArgumentParser(description="Generate 5-fold patch lists")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--patch_mag", type=int, default=200)
    parser.add_argument("--patch_size", type=int, default=256)
    parser.add_argument("--threshold_ratio", type=float, default=0.1)
    parser.add_argument("--n_splits", type=int, default=5)
    parser.add_argument("--seed", type=int, default=44)
    parser.add_argument("--report", action="store_true",
                        help="print per-fold tumor/benign pixel stats after splitting")
    parser.add_argument("--proportion_hist", action="store_true",
                        help="print per-size tumor-proportion decile histograms "
                             "(notebook cells 5-8)")
    parser.add_argument("--hist_sizes", type=int, nargs="+", default=[256, 512, 1024])
    args = parser.parse_args(argv)

    counts = build_fold_lists(args.data_dir, args.patch_mag, args.patch_size,
                              args.threshold_ratio, args.n_splits, args.seed)
    print(f"tumorable: {counts['tumorable']}  non_tumorable: {counts['non_tumorable']}")
    if args.report:
        for fold, stats in tumor_pixel_report(
            args.data_dir, args.patch_mag, args.patch_size, args.n_splits
        ).items():
            print(f"fold {fold}: tumor_ratio={stats['tumor_ratio']:.4f} "
                  f"(tumor={stats['tumor_pixels']}, benign={stats['benign_pixels']})")
    if args.proportion_hist:
        hist = tumor_proportion_histogram(
            args.data_dir, args.patch_mag, tuple(args.hist_sizes)
        )
        for size, stats in hist.items():
            print(f"{args.patch_mag}x_{size}: n={stats['n_patches']} "
                  f"mean={stats['mean']:.3f} deciles={stats['decile_counts']}")


if __name__ == "__main__":
    main()
