"""The yardstick: operations, bytes, peaks and bounds of the selective UNet_B
at a 256x256 input, and the classification of device kernels by kind.

Frozen copies, not imports, of the port's arithmetic
(``scripts/timing.py``: the peaks, ``bound_ms``, the layer tables;
``scripts/int8_conv_against.py::layer_bytes``; ``tools/profile_train_step.py``:
``KINDS``), so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth, bf16 and int8 tensor rates
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12

# the 14 3x3 trunk convs at a 256x256 RGB input: (name, Cin, Cout, H = W)
CONV3X3 = (
    ("enc1_1", 3, 64, 256), ("enc1_2", 64, 64, 256), ("enc2_1", 64, 128, 128),
    ("enc2_2", 128, 128, 128), ("enc3_1", 128, 256, 64), ("enc3_2", 256, 256, 64),
    ("dec4_2", 256, 512, 32), ("dec4_1", 512, 512, 32), ("dec3_2", 512, 256, 64),
    ("dec3_1", 256, 256, 64), ("dec2_2", 256, 128, 128), ("dec2_1", 128, 128, 128),
    ("dec1_2", 128, 64, 256), ("dec1_1", 64, 64, 256),
)
# the k2s2 transposed convs: (name, Cin, Cout, input H = W)
CONVT2X2 = (("unpool3", 512, 256, 32), ("unpool2", 256, 128, 64), ("unpool1", 128, 64, 128))
# the three 1x1 heads on 64 channels at 256x256
HEADS = 3


def conv3x3_macs(scale: float = 1.0) -> int:
    """Multiply-accumulates of the 14 3x3 convs for one patch; ``scale`` is
    (side / 256)^2 for another square side."""
    return int(sum(h * h * cin * 9 * cout for _, cin, cout, h in CONV3X3) * scale)


def other_macs(scale: float = 1.0) -> int:
    """The transposed convs (one tap an output: in_pixels * Cin * 4 * Cout)
    and the 1x1 heads, for one patch."""
    up = sum(h * h * cin * 4 * cout for _, cin, cout, h in CONVT2X2)
    return int((up + HEADS * 256 * 256 * 64) * scale)


def forward_flops(side: int = 256) -> float:
    """Model FLOPs of one forward of one patch (2 a MAC): 73.5e9 at 256."""
    s = (side / 256) ** 2
    return 2.0 * (conv3x3_macs(s) + other_macs(s))


def train_step_flops(batch: int, side: int = 256) -> float:
    """Forward plus backward of a train step, 3x the forward, nothing counted
    for recompute: 28.2e12 at batch 128."""
    return 3.0 * forward_flops(side) * batch


def int8_forward_least_ms(batch: int) -> float:
    """The W8A8 forward's least time at the configuration's own peaks: the 14
    int8 convs at the int8 rate plus the bf16 transposed convs and heads at
    the bf16 rate (~4.97 ms at batch 128)."""
    int8_ops = 2.0 * conv3x3_macs() * batch
    bf16 = 2.0 * other_macs() * batch
    return (int8_ops / PEAK_INT8_OPS + bf16 / PEAK_BF16_FLOPS) * 1e3


def bound_ms(nbytes: float, ops: float, peak: float) -> float:
    """The larger of bytes at HBM bandwidth and operations at ``peak``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3


def int8_layer_bytes(n: int, s: int, cin: int, cout: int, x_bytes: int, y_bytes: int) -> int:
    """x read, y written, the int8 weights and the float32 scales and bias."""
    return n * s * s * (cin * x_bytes + cout * y_bytes) + 9 * cin * cout + 8 * cout + 4


def int8_conv_bound_ms(batch: int) -> float:
    """The bound of the 14 int8 convs of a W8A8 forward (float32 x at the
    first layer, bf16 elsewhere, bf16 y): 5.976 ms at batch 128."""
    total = 0.0
    for i, (_, cin, cout, s) in enumerate(CONV3X3):
        nbytes = int8_layer_bytes(batch, s, cin, cout, 4 if i == 0 else 2, 2)
        total += bound_ms(nbytes, 2.0 * batch * s * s * cin * 9 * cout, PEAK_INT8_OPS)
    return total


# kernel-name fragments -> kind, first match wins
KINDS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("nccl", ("nccl",)),
    ("fused_conv_stats", ("fused_conv_stats_kernel", "rows_reduce_kernel")),
    ("int8_conv", ("int8_conv",)),
    ("eval_metrics", ("eval_metrics",)),
    ("cudnn_cublas_conv_matmul", ("xmma", "cutlass", "dgrad", "wgrad", "fprop", "nvjet",
                                  "implicit_gemm", "gemm", "conv")),
    ("batch_norm", ("batch_norm",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("cat_copies_pooling", ("CatArray", "copy", "max_pool", "Memcpy", "Memset")),
    ("elementwise", ("elementwise", "vectorized", "Functor", "where", "clamp")),
)


def kind_of(name: str) -> str:
    for kind, fragments in KINDS:
        if any(f in name for f in fragments):
            return kind
    return "other"


def matching_us(kernels: Iterable[Tuple[str, float]], fragments: Iterable[str]) -> float:
    """Summed duration (us) of the kernels whose name holds any fragment."""
    frags = tuple(fragments)
    return sum(d for name, d in kernels if any(f in name for f in frags))
