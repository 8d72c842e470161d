"""Entry points that hold the port's prototype kernels against their plain
versions on the card, one per Pallas prototype of the JAX package's
``scripts/`` directory, under the same names:

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_bn_stats
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_pallas_dw {check,bench}
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_fused_cbr [shapes]
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_transposed_cbr [check|bench|all] [--against OTHER_DIR]
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed [v1 ... v5]
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed2 [a ... e]
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed3 [case ...]

Each needs a CUDA device and raises without one, and raises at the first
disagreement between a kernel and its plain version. Beside them, another
commit's kernels (its ``kernels/`` directory, unpacked with ``git archive``)
are timed against this checkout's in turns by ``bisect_against OTHER.cu``
(K7-K9), ``conv_against OTHER_DIR`` (K2, K5), ``eval_metrics_against
OTHER_DIR`` (K1), and the ``--against OTHER_DIR`` options of
``proto_fused_cbr`` (K3) and ``proto_transposed_cbr`` (K6).
"""
