"""Which layers of the fused trunk take the fused-CBR kernel (``ops/fused_cbr.py::
eligible``, the JAX ``FusedCBR``'s ``eligible()``), and what the CUDA
wrappers of K2 (``fused_conv_stats``) and K5 (``conv3x3_dw``) refuse with
their tiles: all on CPU tensors, with no launch.

A float32 layer runs the plain dataflow (``fused_conv_stats_reference``),
as the JAX layer runs its XLA branch where ``eligible()`` says no; a bf16
layer whose channels the kernel takes runs ``fused_conv_stats``, which
dispatches to the kernel for a CUDA tensor."""

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch.models import build_model
from selectivenet_for_semantic_segmentation_binary_torch.models import unet
from selectivenet_for_semantic_segmentation_binary_torch.ops import conv_dw as cd
from selectivenet_for_semantic_segmentation_binary_torch.ops import fused_cbr as fc
from selectivenet_for_semantic_segmentation_binary_torch.ops import fused_cbr_rows as fr
from selectivenet_for_semantic_segmentation_binary_torch.ops import transposed_cbr as tc

# the trunk's 14 convs: (Cin, Cout)
TRUNK = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 512),
         (512, 512), (512, 256), (256, 256), (256, 128), (128, 128), (128, 64), (64, 64))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16],
                         ids=["bf16", "f32", "f16"])
def test_eligible_layers(dtype):
    """bf16: every trunk conv but the first; any other dtype: none."""
    got = [fc.eligible(cin, cout, dtype) for cin, cout in TRUNK]
    want = [dtype == torch.bfloat16 and cin != 3 for cin, _ in TRUNK]
    assert got == want


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_fused_trunk_routes_by_dtype(monkeypatch, compute_dtype):
    """A fused forward calls fused_conv_stats for the 13 eligible bf16 layers
    and the plain version for the rest; in float32 every layer is plain."""
    calls = []

    def recorder(kind, fn):
        def op(x, a, b, w, bias, prologue):
            calls.append((kind, x.shape[-1], w.shape[-1], x.dtype))
            return fn(x, a, b, w, bias, prologue)
        return op

    monkeypatch.setattr(unet, "fused_conv_stats",
                        recorder("kernel", fc.fused_conv_stats_reference))
    monkeypatch.setattr(unet, "fused_conv_stats_reference",
                        recorder("plain", fc.fused_conv_stats_reference))
    model = build_model("UNet_B", selective=True, compute_dtype=compute_dtype, fused=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 16, 16))
                         .astype(np.float32)).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = model(x)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert [(cin, cout) for _, cin, cout, _ in calls] == list(TRUNK)
    if compute_dtype == "bfloat16":
        assert [k for k, *_ in calls] == ["plain"] + ["kernel"] * 13
        assert all(d == torch.bfloat16 for *_, d in calls)
    else:
        assert [k for k, *_ in calls] == ["plain"] * 14
        assert all(d == torch.float32 for *_, d in calls)


def _cbr_args(cin=64, cout=128, dtype=torch.bfloat16):
    x = torch.zeros((2, 8, 8, cin), dtype=dtype)
    return x, torch.ones(cin), torch.zeros(cin), torch.zeros((3, 3, cin, cout), dtype=dtype), \
        torch.zeros(cout)


def test_k2_tiles():
    """The kernel's tile: Cout in 64s, Cin in chunks of 64."""
    assert (fc.TILE_N, fc.TILE_K) == (64, 64)


@pytest.mark.parametrize("cin,cout,ok", [(64, 64, True), (128, 64, True), (512, 256, True),
                                         (64, 192, True), (32, 64, False), (96, 64, False),
                                         (64, 32, False), (64, 96, False), (3, 64, False)])
def test_k2_wrapper_channel_checks(cin, cout, ok):
    """Cin % 64 and Cout % 64: what kernel_takes says, what the wrapper
    checks."""
    assert fc.kernel_takes(cin, cout) == ok
    args = _cbr_args(cin, cout)
    if ok:
        fc._check_cuda_inputs(*args)
    else:
        with pytest.raises(ValueError, match="the kernel takes Cin % 64 == 0 and Cout % 64"):
            fc._check_cuda_inputs(*args)


def test_k2_wrapper_refuses_float32():
    """The wrapper never takes float32: the model's gate keeps such layers
    off it."""
    with pytest.raises(ValueError, match="bf16"):
        fc._check_cuda_inputs(*_cbr_args(dtype=torch.float32))


def test_k3_and_k6_keep_their_own_tiles():
    """The redesigned K2 takes Cin in 64s; K3 and K6 still take Cin in 32s."""
    assert (fr.TILE_N, fr.TILE_K) == (64, 32) and (tc.TILE_N, tc.TILE_K) == (64, 32)
    fc._check_cuda_inputs(*_cbr_args(32, 64), fr.TILE_K, fr.TILE_N)


@pytest.mark.parametrize("ci,co,ok", [(64, 64, True), (128, 64, True), (64, 128, True),
                                      (512, 512, True), (32, 64, False), (64, 96, False)])
def test_k5_wrapper_channel_checks(ci, co, ok):
    """Ci and Co in multiples of 64 (the wgmma kernel's 64-channel blocks)."""
    x = torch.zeros((4, 4, 2, ci), dtype=torch.bfloat16)
    g = torch.zeros((4, 4, 2, co), dtype=torch.bfloat16)
    if ok:
        cd._check_cuda_inputs(x, g)
    else:
        with pytest.raises(ValueError, match="multiples of 64"):
            cd._check_cuda_inputs(x, g)


def test_k5_wrapper_dtype_checks():
    x = torch.zeros((4, 4, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        cd._check_cuda_inputs(x, x.float())
    with pytest.raises(TypeError, match="bf16 or float32"):
        cd._check_cuda_inputs(x.half(), x.half())
