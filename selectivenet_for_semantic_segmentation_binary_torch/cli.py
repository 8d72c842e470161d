"""Command-line entry points of the port: ``train`` and ``eval`` sub-commands.

Counterpart of the JAX package's ``cli.py:24-50``, with the same flags
(``config.parse_train_args``, ``config.parse_eval_args``)::

    python -m selectivenet_for_semantic_segmentation_binary_torch.cli train \\
        --fold 1 --data_dir DATA --model_dir MODELS --model_arch UNet_B \\
        --selective 1 --loss BCElogit --batch_size 128 --patch_size 256 \\
        --compute_dtype bfloat16 --fused_cbr on
    python -m selectivenet_for_semantic_segmentation_binary_torch.cli eval \\
        --fold 1 --data_dir DATA --model_dir MODELS/1-fold/checkpoint \\
        --model_arch UNet_B --selective 1 --select_eval 1 --batch_size 128

Without a sub-command the flags are evaluation's, as before training was
ported. Both run on the first CUDA card and raise without one; from Python,
``main(argv, device="cpu")`` runs them on the CPU (the command line has no
device flag, as ``train.py`` and ``eval.py`` have none).
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


def main(argv=None, device=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "train":
        train_main(argv[1:], device=device)
    elif argv and argv[0] == "eval":
        eval_main(argv[1:], device=device)
    else:
        eval_main(argv, device=device)


if __name__ == "__main__":
    main()
