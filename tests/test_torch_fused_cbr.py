"""The port's fused_conv_stats against the JAX package's, on the CPU.

The port's public function (its ``autograd.Function``, which takes the plain
version for CPU tensors) and the plain version itself are held to the JAX
``fused_conv_stats`` with its Pallas kernel run in interpret mode, in
float32, at the shapes of ``tests/test_fused_cbr.py``. Tolerances are that
file's: 1e-5 for y, rtol 1e-4 / atol 1e-3 for the stats, 2e-4 for gradients.
The CUDA kernel itself is tested on the card (``test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.ops.fused_cbr import (
    bn_affine as jax_bn_affine,
    fused_conv_stats as jax_fused_conv_stats,
    moments_from_stats as jax_moments_from_stats,
)
from selectivenet_for_semantic_segmentation_binary_torch.ops import fused_cbr as fc

Y_TOL = dict(rtol=1e-5, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-3)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, n, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, w, cin)).astype(np.float32),
            (rng.standard_normal(cin) * 0.1 + 1.0).astype(np.float32),
            (rng.standard_normal(cin) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32))


@pytest.fixture(scope="module")
def op_inputs():
    return _inputs(0, 2, 8, 8, 128, 128)


PORT_FNS = {"function": fc.fused_conv_stats, "plain": fc.fused_conv_stats_reference}


@pytest.mark.parametrize("fn", list(PORT_FNS), ids=list(PORT_FNS))
@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
def test_forward_matches_jax(op_inputs, prologue, fn):
    want_y, want_s = jax_fused_conv_stats(*map(jnp.asarray, op_inputs), prologue, True)
    before = fc.launches
    y, s = PORT_FNS[fn](*map(torch.from_numpy, op_inputs), prologue)
    assert fc.launches == before  # the CPU takes the plain version, never the kernel
    assert y.shape == want_y.shape and y.is_contiguous() and s.shape == (2, 128)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **Y_TOL)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(want_s), **STATS_TOL)


def test_halo_matches_jax():
    """A nonzero prologue shift b: relu(b) must not reach the zero padding."""
    x, _, _, w, _ = _inputs(1, 1, 16, 8, 128, 128)
    a = np.ones(128, np.float32)
    b = np.full(128, 0.2, np.float32)
    bias = np.zeros(128, np.float32)
    want_y, _ = jax_fused_conv_stats(*map(jnp.asarray, (x, a, b, w, bias)), True, True)
    y, _ = fc.fused_conv_stats(*map(torch.from_numpy, (x, a, b, w, bias)), True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **Y_TOL)
    # the halo really is zero after the affine: a zero-padded relu(x*a+b)
    # would differ at the border
    leak = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.relu(torch.from_numpy(x) + 0.2).permute(0, 3, 1, 2),
                                (1, 1, 1, 1), value=0.2),
        torch.from_numpy(w).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    assert float((leak - y).abs().max()) > 1e-2


@pytest.mark.parametrize("fn", list(PORT_FNS), ids=list(PORT_FNS))
def test_gradients_match_jax(op_inputs, fn):
    """Gradients of x, a, b, w and bias through y and the stats, with the
    loss of tests/test_fused_cbr.py:83-91."""
    def jax_loss(*args):
        y, s = jax_fused_conv_stats(*args, True, True)
        mean, var = jax_moments_from_stats(s, y.size)
        return jnp.sum(y * y) * 1e-3 + jnp.sum(mean) + jnp.sum(var)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, op_inputs))
    args = [torch.from_numpy(v).requires_grad_(True) for v in op_inputs]
    y, s = PORT_FNS[fn](*args, True)
    mean, var = fc.moments_from_stats(s, y.numel())
    ((y * y).sum() * 1e-3 + mean.sum() + var.sum()).backward()
    for t, g, name in zip(args, want, ("x", "a", "b", "w", "bias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD_TOL,
                                   err_msg=f"gradient of {name}")


def test_gradients_without_prologue_match_jax(op_inputs):
    """Prologue off: x's gradient is the conv's, and a, b get zeros, as in
    the JAX VJP (fused_cbr.py:264-267)."""
    def jax_loss(*args):
        y, s = jax_fused_conv_stats(*args, False, True)
        return jnp.sum(y * y) * 1e-3 + jnp.sum(s[0]) * 1e-2

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, op_inputs))
    args = [torch.from_numpy(v).requires_grad_(True) for v in op_inputs]
    y, s = fc.fused_conv_stats(*args, False)
    ((y * y).sum() * 1e-3 + s[0].sum() * 1e-2).backward()
    for t, g in zip(args, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD_TOL)
    assert not args[1].grad.any() and not args[2].grad.any()


def test_moments_and_bn_affine_match_jax():
    rng = np.random.default_rng(3)
    stats = np.stack([rng.standard_normal(8) * 10, rng.random(8) * 100 + 50]).astype(np.float32)
    stats[1, 0] = 0.0  # E[y^2] < E[y]^2: the variance clips at 0
    mean, var = fc.moments_from_stats(torch.from_numpy(stats), 64)
    want_mean, want_var = jax_moments_from_stats(jnp.asarray(stats), 64)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_var), rtol=1e-6, atol=1e-6)
    assert float(var[0]) == 0.0
    gamma, beta = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
    got = fc.bn_affine(torch.from_numpy(gamma), torch.from_numpy(beta), mean, var)
    want = jax_bn_affine(jnp.asarray(gamma), jnp.asarray(beta), want_mean, want_var)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_kernel_shape_gate():
    """The kernel takes every trunk conv but the first (Cin 3)."""
    assert fc.kernel_takes(64, 64) and fc.kernel_takes(512, 256) and fc.kernel_takes(128, 64)
    assert not fc.kernel_takes(3, 64) and not fc.kernel_takes(2, 64)
    assert not fc.kernel_takes(64, 32) and not fc.kernel_takes(48, 64)


@pytest.mark.parametrize("case", ["dtype", "layout", "shape", "gate", "bias_dtype"])
def test_kernel_input_checks(case):
    """What the CUDA wrapper refuses, checked on CPU tensors before any launch."""
    x = torch.zeros((2, 8, 8, 64), dtype=torch.bfloat16)
    a, b = torch.ones(64), torch.zeros(64)
    w = torch.zeros((3, 3, 64, 128), dtype=torch.bfloat16)
    bias = torch.zeros(128)
    if case == "dtype":
        x, match = x.float(), "bf16"
    elif case == "layout":
        x, match = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), "contiguous"
    elif case == "shape":
        a, match = torch.ones(32), "shape"
    elif case == "gate":
        x, a, b = torch.zeros((2, 8, 8, 48), dtype=torch.bfloat16), torch.ones(48), torch.zeros(48)
        w, match = torch.zeros((3, 3, 48, 128), dtype=torch.bfloat16), "Cin"
    else:
        bias, match = bias.double(), "float32"
    with pytest.raises(ValueError, match=match):
        fc._check_cuda_inputs(x, a, b, w, bias)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fc.fused_conv_stats(x.to("meta"), a.to("meta"), b.to("meta"), w.to("meta"),
                            bias.to("meta"), True)
