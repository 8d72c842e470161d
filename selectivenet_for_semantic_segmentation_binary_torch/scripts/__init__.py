"""Entry points that hold the port's prototype kernels against their plain
versions on the card, one per Pallas prototype of the JAX package's
``scripts/`` directory, under the same names:

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_bn_stats
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_pallas_dw {check,bench}
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_fused_cbr [shapes]
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_transposed_cbr [check|bench|all]
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed [v1 ... v5]
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed2 [a ... e]
    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed3 [case ...]

Each needs a CUDA device and raises without one, and raises at the first
disagreement between a kernel and its plain version. Beside them,
``bisect_against OTHER.cu`` times K7's and K8's kernels against another
commit's ``kernels/transposed_bisect.cu``.
"""
