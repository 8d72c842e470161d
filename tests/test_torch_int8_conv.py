"""K10's plain version (``ops/int8_conv.py``) against the JAX package's XLA
int8 convs, on the CPU: the W8A8 serving CBR (``models/unet.py:315-327``)
and the dynamic epilogue of ``_qat_fwd_math`` (:221-240).

Tolerances: the int8 levels and the int32 sums are integers and must be
equal; the float32 outputs may differ by one rounding where XLA contracts
the dequant ``y * s + b`` into an FMA (rtol/atol 1e-6). The kernel itself
runs only on a card (``tests/test_torch_kernels_cuda.py``, chip_smoke.py
phase 20), where it is held to this plain version bit for bit; which of
its two kernels a shape takes (``kernel_path``) is checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.models.unet import CBR as JaxCBR
from selectivenet_for_semantic_segmentation_binary_torch.ops import int8_conv as ic
from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import INT8_LAYERS

TOL = dict(rtol=1e-6, atol=1e-6)


def _operands(seed, n, h, w, cin, cout):
    """x (N, H, W, Cin) float32, kq (3, 3, Cin, Cout) int8 HWIO, ks, a
    (clipping the largest inputs) and a bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    kq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    ks = (10.0 ** rng.uniform(-3, -1, cout)).astype(np.float32)
    a = np.float32(np.abs(x).max() / 127 * 0.8)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, kq, ks, a, b


def _jax_levels(x, a):
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / jnp.float32(a))), -127, 127))


def _jax_sums(q, kq):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(q, jnp.int8), jnp.asarray(kq), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))


def _port(x, kq, ks, a, b=None, dynamic=False, out_dtype=torch.float32):
    return ic.int8_conv(torch.from_numpy(x), torch.from_numpy(kq.transpose(3, 0, 1, 2).copy()),
                        torch.tensor(a), torch.from_numpy(ks),
                        None if b is None else torch.from_numpy(b), out_dtype, dynamic)


def test_prologue_rounds_half_to_even_and_clamps():
    a = np.float32(0.25)
    x = (np.arange(-140, 140, dtype=np.float32) + 0.5) * a  # every level on a tie
    x = np.concatenate([x, x * 0.999, x * 1.001]).reshape(1, 1, -1, 1)
    got = ic.quantize_input(torch.from_numpy(x), torch.tensor(a)).numpy()
    want = _jax_levels(x, a)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 127 and got.min() == -127
    # -0.5 and 0.5 -> 0, 1.5 -> 2: half to even
    assert np.array_equal(got[0, 0, 139:142, 0], [0, 0, 2])


@pytest.mark.parametrize("cin", [2, 3, 32, 512])
def test_integer_sums_equal_xla_int32(cin):
    """The float64 conv of the plain version gives XLA's int32 sums, also at
    the largest |sum| the trunk can reach (127 * 127 * 9 * 512 > 2^24)."""
    rng = np.random.default_rng(cin)
    q = rng.integers(-127, 128, (2, 5, 6, cin)).astype(np.int8)
    kq = rng.integers(-127, 128, (3, 3, cin, 8)).astype(np.int8)
    q[0], kq[..., 0] = 127, 127  # every tap at the extreme
    got = ic.int8_conv_sums(torch.from_numpy(q), torch.from_numpy(kq.transpose(3, 0, 1, 2).copy()))
    want = _jax_sums(q, kq)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == 127 * 127 * 9 * cin  # an inner pixel of sample 0, channel 0


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", [2, 3, 32, 64])
def test_static_epilogue_matches_the_jax_w8a8_cbr(cin, x_dtype):
    x, kq, ks, a, b = _operands(cin, 2, 7, 9, cin, 16)
    if x_dtype == "bfloat16":  # the bf16 graph's inputs; JAX reads them as float32
        x = torch.from_numpy(x).bfloat16().float().numpy()
    params = {"conv": {"kernel_q": jnp.asarray(kq), "kernel_scale": jnp.asarray(ks),
                       "act_scale": jnp.asarray(a), "bias": jnp.asarray(b)}}
    want = JaxCBR(features=16, dtype=jnp.float32, folded=True, quantize=True).apply(
        {"params": params}, jnp.asarray(x), train=False)
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    got = ic.int8_conv(xt, torch.from_numpy(kq.transpose(3, 0, 1, 2).copy()), torch.tensor(a),
                       torch.from_numpy(ks), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy() == 0).any() and (got.numpy() > 0).any()  # the ReLU acts


@pytest.mark.parametrize("cin", [3, 64])
def test_dynamic_epilogue_matches_xla(cin):
    """``float(acc) * (a * ks)`` with no bias and no ReLU, float32: the
    product ``_qat_fwd_math`` returns for given scales."""
    x, kq, ks, a, _ = _operands(cin + 1, 2, 6, 6, cin, 8)
    want = (_jax_sums(_jax_levels(x, a), kq).astype(np.float32)
            * np.asarray(jnp.float32(a) * jnp.asarray(ks)))
    got = _port(x, kq, ks, a, dynamic=True)
    assert got.dtype == torch.float32 and (got.numpy() < 0).any()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_output_is_the_float32_output_rounded_once():
    x, kq, ks, a, b = _operands(5, 2, 8, 8, 32, 24)
    y32 = _port(x, kq, ks, a, b)
    y16 = _port(x, kq, ks, a, b, out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, y32.bfloat16())


def test_cpu_tensors_take_the_plain_version():
    x, kq, ks, a, b = _operands(6, 1, 4, 4, 3, 8)
    before = ic.launches
    got = _port(x, kq, ks, a, b)
    want = ic.int8_conv_reference(torch.from_numpy(x),
                                  torch.from_numpy(kq.transpose(3, 0, 1, 2).copy()),
                                  torch.tensor(a), torch.from_numpy(ks), torch.from_numpy(b))
    assert torch.equal(got, want) and ic.launches == before


@pytest.mark.parametrize("case", ["w_shape", "w_dtype", "cin", "ks_shape", "no_bias", "device"])
def test_bad_operands_raise(case):
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(16, 3, 3, 8, dtype=torch.int8)
    a, ks, b = torch.tensor(0.1), torch.ones(16), torch.zeros(16)
    kw = dict(x=x, w_q=w, a=a, ks=ks, bias=b)
    err = ValueError
    if case == "w_shape":
        kw["w_q"] = torch.zeros(16, 8, 3, 3, dtype=torch.int8)
    elif case == "w_dtype":
        kw["w_q"], err = w.float(), TypeError
    elif case == "cin":
        kw["x"] = torch.zeros(1, 4, 4, 4)
    elif case == "ks_shape":
        kw["ks"] = torch.ones(8)
    elif case == "no_bias":
        kw["bias"] = None
    else:
        kw["x"] = x.to("meta")
    with pytest.raises(err):
        ic.int8_conv(**kw)


# -- kernel_path: which of the source's two kernels a shape takes, from the
# shape alone (no card needed; the card tests hold the source's own
# int8_conv_path to it)


@pytest.mark.parametrize("layer", INT8_LAYERS, ids=lambda layer: layer[0])
def test_kernel_path_of_the_trunk_layers(layer):
    """The 13 layers with Cin >= 64 take the wgmma kernel at batch 128, in
    both input dtypes; the RGB first layer (Cin 3) the im2col kernel."""
    _, cin, cout, size = layer
    want = "wgmma" if cin >= 64 else "wgmma_im2col"
    for dtype in (torch.bfloat16, torch.float32):
        assert ic.kernel_path(128, size, size, cin, cout, dtype) == want


@pytest.mark.parametrize("cin", [1, 2, 3])
def test_kernel_path_takes_the_im2col_kernel_for_the_first_layer(cin):
    """Cin <= 3 (RGB, GH, one channel): K = 9 Cin <= 27 fits one k32 step."""
    for cout in (64, 72, 128):
        assert ic.kernel_path(128, 256, 256, cin, cout) == "wgmma_im2col"
    assert ic.kernel_path(1, 7, 1000, cin, 64, torch.float32) == "wgmma_im2col"


@pytest.mark.parametrize("cin", [4, 16, 48, 100])
def test_kernel_path_takes_the_mma_sync_kernel_where_cin_is_not_a_multiple_of_32(cin):
    assert ic.kernel_path(128, 256, 256, cin, 64) == "mma_sync"


@pytest.mark.parametrize("cout", [8, 72, 200, 264])
def test_kernel_path_keeps_a_ragged_cout_on_the_wgmma_kernel(cout):
    """Cout % 8 == 0 but not a multiple of 64: the last channel tile's rows
    past Cout are the weight map's zeros, dropped by the epilogue."""
    assert ic.kernel_path(2, 8, 8, 96, cout) == "wgmma"
    assert ic.wgmma_smem(8, cout) == ic.wgmma_smem(8, 64)  # cw = 1: 64-channel tiles


def test_kernel_path_width_limit_is_the_shared_memory():
    """The window (P + 2 (W + 2) + 2 positions, double-buffered) must fit a
    CTA's 227 KB: W 745 at cw = 1 (P = 512), W 585 at cw = 2 (P = 256)."""
    for cout, widest in ((64, 745), (128, 585), (512, 585)):
        assert ic.wgmma_smem(widest, cout) <= 232448 < ic.wgmma_smem(widest + 1, cout)
        assert ic.kernel_path(1, 4, widest, 64, cout) == "wgmma"
        assert ic.kernel_path(1, 4, widest + 1, 64, cout) == "mma_sync"


def test_kernel_path_of_the_verify_images_levels():
    """A 300x420 image padded to 304x424 reaches 38x53 at the deepest
    level: every level takes the wgmma kernel."""
    for level, (h, w) in enumerate([(304, 424), (152, 212), (76, 106), (38, 53)]):
        cin = 64 << level
        assert ic.kernel_path(1, h, w, cin, cin) == "wgmma"


def test_kernel_path_large_images_take_the_mma_sync_kernel():
    """The 2D map's pixel coordinate is int32 (N H W < 2^31 - 256), as are a
    window's positions ((H + 4)(W + 2) + 2048 < 2^31)."""
    for cin in (3, 64):
        assert ic.kernel_path(2 ** 20, 64, 32, cin, 64) == "mma_sync"  # N H W = 2^31
        assert ic.kernel_path(1, 2 ** 31 // 3, 1, cin, 64) == "mma_sync"  # positions past 2^31
    assert ic.kernel_path(1, 2 ** 20, 256, 64, 64) == "wgmma"
    assert ic.kernel_path(1, 2 ** 20, 256, 3, 64) == "wgmma_im2col"


def test_kernel_path_takes_bf16_or_float32_only():
    with pytest.raises(TypeError):
        ic.kernel_path(1, 8, 8, 64, 64, torch.float16)
