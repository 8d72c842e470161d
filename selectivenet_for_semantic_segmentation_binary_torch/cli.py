"""Command-line entry point of the port's evaluation.

Counterpart of the JAX package's ``cli.py:39-50``, with the same flags
(``config.parse_eval_args``)::

    python -m selectivenet_for_semantic_segmentation_binary_torch.cli \
        --fold 1 --data_dir DATA --model_dir MODELS \
        --model_arch UNet_B --selective 1 --select_eval 1 --batch_size 128
"""

from __future__ import annotations


def eval_main(argv=None) -> None:
    from .config import parse_eval_args
    from .eval_lib import evaluate

    cfg = parse_eval_args(argv)
    print("")
    print(f"args={cfg}\n")
    if cfg.info_print:
        print("Load Tumor Segmentation Model...")
    print("Model Prediction...")
    evaluate(cfg)


if __name__ == "__main__":
    eval_main()
