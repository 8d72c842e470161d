"""Per-channel BatchNorm statistics on the card: the CUDA kernel
(``ops/bn_stats.py``, ``kernels/bn_stats.cu``) against its plain version.

Counterpart of the JAX package's ``scripts/proto_bn_stats.py`` ``main()``
:80-96, at its shape: a (128, 256, 256, 64) bf16 activation, 1 GiB, the
full-resolution C=64 level of UNet_B at batch 128. It prints the kernel's
sums against the plain version's (max |sum diff| and its relative size, as
the JAX script does) and the device time of each with its read bandwidth
against the 3.35 TB/s of the H100's HBM3, and the time of
``torch.var_mean``, the one PyTorch call that gives the same two statistics
(mean and biased variance).

    python -m selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_bn_stats
"""

from __future__ import annotations

import torch

from ..ops import bn_stats as bs
from .timing import HBM_BYTES_PER_S, card, in_turns, median_ms_device, require_cuda

SHAPE = (128, 256, 256, bs.C)  # scripts/proto_bn_stats.py:83


def bench(shape=SHAPE, seed: int = 0) -> dict:
    """Kernel against plain version at ``shape``: their sums and device times."""
    device = require_cuda("proto_bn_stats")
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    nbytes = x.numel() * x.element_size()
    s_k, q_k = bs.bn_stats(x)
    s_p, q_p = bs.bn_stats_reference(x)
    sum_err = float((s_k - s_p).abs().max())
    sum_rel = float(((s_k - s_p).abs() / (s_p.abs() + 1)).max())
    sq_rel = float(((q_k - q_p).abs() / (q_p.abs() + 1)).max())
    print(f"max |sum diff|: {sum_err:.6g}  rel: {sum_rel:.3e}")
    print(f"max |sumsq rel diff|: {sq_rel:.3e}")
    t = in_turns(lambda: bs.bn_stats_reference(x), lambda: bs.bn_stats(x))
    # one PyTorch call for the same two statistics (mean and biased variance)
    x2d = x.view(-1, shape[-1])
    t["library_ms"] = median_ms_device(lambda: torch.var_mean(x2d, dim=0, correction=0))
    for name, ms in (("plain version", t["plain_ms"]), ("CUDA kernel", t["ms"]),
                     ("torch.var_mean", t["library_ms"])):
        rate = nbytes / ms / 1e6
        print(f"{name:14s} {ms:8.4f} ms  ({rate:7.1f} GB/s, "
              f"{rate * 1e9 / HBM_BYTES_PER_S * 100:5.1f}% of 3.35 TB/s)")
    return {"shape": tuple(shape), "bytes": nbytes, "sum_err": sum_err, "sum_rel": sum_rel,
            "sumsq_rel": sq_rel, **t}


def main() -> None:
    require_cuda("proto_bn_stats")
    print(card())
    bench()


if __name__ == "__main__":
    main()
