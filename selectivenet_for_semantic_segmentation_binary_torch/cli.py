"""Command-line entry points of the port: ``train``, ``eval``, ``predict``,
``serve``, ``wsi``, ``calibrate``, ``split``, ``sweep``, ``inspect_ckpt``,
``export`` and ``bench`` sub-commands.

Counterpart of the JAX package's ``cli.py`` (``train_main``, ``eval_main``,
``predict_main``, ``serve_main``, ``wsi_main``, ``calibrate_main``,
``split_main``, ``sweep_main``, ``inspect_ckpt_main``, ``export_main``) and
of the repository's ``bench.py``, with the same flags
(``config.parse_train_args``, ``config.parse_eval_args``, ``tools/*.py``)::

    python -m selectivenet_for_semantic_segmentation_binary_torch.cli train \\
        --fold 1 --data_dir DATA --model_dir MODELS --model_arch UNet_B \\
        --selective 1 --loss BCElogit --batch_size 128 --patch_size 256 \\
        --compute_dtype bfloat16 --fused_cbr on
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli eval \\
        --fold 1 --data_dir DATA --model_dir MODELS/1-fold/checkpoint \\
        --model_arch UNet_B --selective 1 --select_eval 1 --batch_size 128
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli predict \
        IMAGE.png --model_path MODEL.pth --selective 1 --save_dir OUT
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli serve \
        --model_path MODEL.pth --selective 1 --port 8500 --warmup 256 256
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli wsi \
        --data_dir DATA --test_fold 1 --model_dir MODELS/1-fold/checkpoint \
        --selective 1 --nrow 3 --save_dir OUT
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli calibrate \
        --data_dir DATA --fold 1 --model_dir MODELS/1-fold/checkpoint \
        --target_coverage 0.8 --split valid --curve_csv OUT/rc.csv
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli split \
        --data_dir DATA --report
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli sweep \
        --data_dir DATA --model_root MODELS --folds 1 --variants baseline \
        --selective 1 --n_epoch 10 --save_dir OUT
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli inspect_ckpt \
        MODEL.pth --compare OTHER.ckpt
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli export \
        --out unet.pt2 --model_path MODEL.pth --selective 1 --batch 8
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli bench [bfloat16]

Without a sub-command the flags are evaluation's, as before training was
ported. All but ``split`` and ``inspect_ckpt`` (host tools) run on the
first CUDA card and raise without one; from Python, ``main(argv,
device="cpu")`` runs them on the CPU (the command line has no device flag,
as ``train.py`` and ``eval.py`` have none).
"""

from __future__ import annotations

import sys


def train_main(argv=None, device=None) -> None:
    from .config import parse_train_args
    from .train_lib import train

    cfg = parse_train_args(argv)
    print("")
    print(f"args={cfg}\n")
    train(cfg, device=device)


def eval_main(argv=None, device=None) -> None:
    from .config import parse_eval_args
    from .eval_lib import evaluate

    cfg = parse_eval_args(argv)
    print("")
    print(f"args={cfg}\n")
    if cfg.info_print:
        print("Load Tumor Segmentation Model...")
    print("Model Prediction...")
    evaluate(cfg, device=device)


def predict_main(argv=None, device=None) -> None:
    from .tools.predict import main

    main(argv, device=device)


def serve_main(argv=None, device=None) -> None:
    from .tools.serve import main

    main(argv, device=device)


def wsi_main(argv=None, device=None):
    """``snet-wsi``; returns the per-slide results."""
    from .tools.wsi import main

    return main(argv, device=device)


def calibrate_main(argv=None, device=None):
    """``snet-calibrate``; returns the calibrated threshold."""
    from .tools.calibrate import main

    return main(argv, device=device)


def split_main(argv=None, device=None) -> None:
    """``snet-split``: host numpy and PIL; ``device`` is not used."""
    from .tools.data_split import main

    main(argv)


def sweep_main(argv=None, device=None):
    """``snet-sweep``; returns the rows."""
    from .tools.sweep import main

    return main(argv, device=device)


def inspect_ckpt_main(argv=None, device=None) -> None:
    """``snet-inspect-ckpt``: host only; ``device`` is not used."""
    from .tools.inspect_ckpt import main

    main(argv)


def export_main(argv=None, device=None):
    """``snet-export``; returns the sidecar's dict."""
    from .tools.export import main

    return main(argv, device=device)


def bench_main(argv=None, device=None):
    """The port's benchmark (``..._torch/bench.py``); returns its JSON line."""
    from .bench import main

    return main(argv, device=device)


_COMMANDS = {"train": train_main, "eval": eval_main, "predict": predict_main,
             "serve": serve_main, "wsi": wsi_main, "calibrate": calibrate_main,
             "split": split_main, "sweep": sweep_main, "inspect_ckpt": inspect_ckpt_main,
             "export": export_main, "bench": bench_main}


def main(argv=None, device=None):
    """Runs the sub-command; returns what it returns (``wsi``, ``calibrate``,
    ``sweep``, ``export``, ``bench``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _COMMANDS:
        return _COMMANDS[argv[0]](argv[1:], device=device)
    return eval_main(argv, device=device)


if __name__ == "__main__":
    main()
