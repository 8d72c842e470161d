"""The port's three prototype kernels' plain versions against the JAX
package's Pallas prototypes in ``scripts/``, on the CPU.

The JAX scripts are loaded from their files (they are not a package) and
their Pallas kernels run in interpret mode; ``pallas_bn_stats`` has no
interpret switch, so ``bn_stats`` is held to ``xla_bn_stats`` alone. The
same seeded numpy inputs go to both sides. Tolerances:

- ``fused_cbr`` (float32): y within 1e-5 of max |y|, stats within 1e-4 of
  max |stats|;
- ``bn_stats`` (bf16 in, float32 sums): within 1e-5 of sum |x| (sum) and of
  sum x^2 (sumsq);
- ``conv3x3_dw``: within 2e-6 of max |dW| in float32 and 2e-2 in bf16, the
  JAX script's own bars (proto_pallas_dw.py:207, :217).

The CUDA kernels are tested on the card (``test_torch_kernels_cuda.py``);
nothing here builds or loads one.
"""

import ast
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch.ops import bn_stats as bs
from selectivenet_for_semantic_segmentation_binary_torch.ops import conv_dw as cd
from selectivenet_for_semantic_segmentation_binary_torch.ops import fused_cbr_rows as fr
from selectivenet_for_semantic_segmentation_binary_torch.scripts import (
    proto_bn_stats as port_bn_script,
    proto_fused_cbr as port_cbr_script,
    proto_pallas_dw as port_dw_script,
)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_cbr():
    return _load_script("proto_fused_cbr")


@pytest.fixture(scope="module")
def jax_dw():
    return _load_script("proto_pallas_dw")


@pytest.fixture(scope="module")
def jax_bn():
    return _load_script("proto_bn_stats")


# --- fused_cbr --------------------------------------------------------------


def _cbr_inputs(seed, n, h, w, cin, cout):
    """b is far from zero, so relu(b) would show in a leaking halo."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, w, cin)).astype(np.float32),
            (rng.standard_normal(cin) * 0.1 + 1.0).astype(np.float32),
            (rng.standard_normal(cin) * 0.5 + 0.3).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("band", ["whole", "half"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 16), (1, 8, 12, 16, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_cbr_matches_jax(jax_cbr, shape, band, prologue):
    """rows = H takes the TPU kernel's Blocked path, rows = H/2 its
    pl.Element path with overlapping halo rows."""
    inputs = _cbr_inputs(0, *shape)
    rows = shape[1] if band == "whole" else shape[1] // 2
    jx = [jnp.asarray(v) for v in inputs]
    want_y, want_s = jax_cbr.fused_cbr(*jx, rows=rows, apply_prologue=prologue, interpret=True)
    chain_y, chain_s = jax_cbr.xla_chain(*jx, apply_prologue=prologue)
    before = fr.launches
    tensors = [torch.from_numpy(v) for v in inputs]
    for y, s in (fr.fused_cbr(*tensors, rows=rows, apply_prologue=prologue),
                 fr.fused_cbr_reference(*tensors, apply_prologue=prologue)):
        assert y.shape == shape[:3] + (shape[4],) and s.shape == (2, shape[4])
        for wy, ws in ((want_y, want_s), (chain_y, chain_s)):
            assert _close(y.detach().numpy(), wy, 1e-5)
            assert _close(s.detach().numpy(), ws, 1e-4)
    assert fr.launches == before and fr._lib is None


def test_conv_only_matches_jax(jax_cbr):
    x, _, _, w, bias = _cbr_inputs(1, 2, 8, 8, 8, 16)
    want = jax_cbr.xla_conv_only(*map(jnp.asarray, (x, w, bias)))
    got = fr.conv_only(*map(torch.from_numpy, (x, w, bias)))
    assert _close(got.numpy(), want, 1e-5)


def test_fused_cbr_halo_is_zero_after_the_affine():
    """A padded relu(x*a + b) would differ at the border: the plain version
    pads the normalised input."""
    x, a, b, w, bias = map(torch.from_numpy, _cbr_inputs(2, 1, 6, 6, 8, 8))
    y, _ = fr.fused_cbr(x, a, b, w, bias, rows=3)
    w_oihw = w.permute(3, 2, 0, 1)
    xn = torch.relu(x * a + b).permute(0, 3, 1, 2)
    right = torch.nn.functional.conv2d(xn, w_oihw, padding=1).permute(0, 2, 3, 1) + bias
    # the raw x padded with zeros BEFORE the affine: relu(b) in the halo
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    leak_in = torch.relu(xp * a[:, None, None] + b[:, None, None])
    leak = torch.nn.functional.conv2d(leak_in, w_oihw).permute(0, 2, 3, 1) + bias
    assert torch.allclose(y, right, atol=1e-5)
    assert float((leak - y).abs().max()) > 1e-2


# --- bn_stats ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (1, 3, 5, 64), (3, 7, 11, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_stats_matches_jax(jax_bn, shape):
    """bf16 in; (1, 3, 5) has an odd pixel count the TPU kernel's (M/2, 128)
    view cannot take, and (3, 7, 11) a tail its grid would drop."""
    rng = np.random.default_rng(3)
    xj = jnp.asarray(rng.standard_normal(shape) * 2.0 + 0.5, jnp.bfloat16)
    x32 = np.array(xj.astype(jnp.float32))
    want_s, want_q = jax_bn.xla_bn_stats(xj)
    before = bs.launches
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    for s, q in (bs.bn_stats(xt), bs.bn_stats_reference(xt)):
        assert s.dtype == q.dtype == torch.float32 and s.shape == q.shape == (64,)
        assert float(np.abs(s.numpy() - np.asarray(want_s)).max()) <= 1e-5 * np.abs(x32).sum()
        assert float(np.abs(q.numpy() - np.asarray(want_q)).max()) <= 1e-5 * (x32 * x32).sum()
    assert bs.launches == before and bs._lib is None


def test_bn_stats_sums_every_row():
    """An odd row count: the last pixel counts (the TPU grid would drop it)."""
    x = torch.zeros((1, 1, 2049, 64), dtype=torch.bfloat16)
    x[0, 0, -1] = 1.0
    s, q = bs.bn_stats(x)
    assert torch.equal(s, torch.ones(64)) and torch.equal(q, torch.ones(64))


# --- conv3x3_dw -------------------------------------------------------------


@pytest.mark.parametrize("variant", ["taps9", "x3g3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 8, 2, 8, 16, 4, 4), (8, 12, 3, 16, 8, 4, 6)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_dw_matches_jax(jax_dw, shape, dtype, variant):
    h, w, n, ci, co, th, tw = shape
    rng = np.random.default_rng(4)
    x = rng.standard_normal((h, w, n, ci)).astype(np.float32)
    g = rng.standard_normal((h, w, n, co)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    want = np.asarray(jax_dw.dw_pallas(xj, gj, TH=th, TW=tw, variant=variant, interpret=True))
    want_xla = np.asarray(jax_dw.dw_xla(xj, gj))
    tol = 2e-2 if dtype == "bfloat16" else 2e-6
    before = cd.launches
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(getattr(torch, dtype))
    for got in (cd.conv3x3_dw(xt, gt, TH=th, TW=tw, variant=variant),
                cd.conv3x3_dw_reference(xt, gt)):
        assert got.dtype == torch.float32 and got.shape == (3, 3, ci, co)
        assert _close(got.numpy(), want, tol)
        assert _close(got.numpy(), want_xla, tol)
    assert cd.launches == before and cd._lib is None


def test_conv3x3_dw_is_the_conv_weight_gradient():
    """dW equals autograd's gradient of the HWIO weight of a SAME conv."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 5, 2, 4)).astype(np.float64))
    g = torch.from_numpy(rng.standard_normal((6, 5, 2, 3)).astype(np.float64))
    w = torch.zeros((3, 3, 4, 3), dtype=torch.float64, requires_grad=True)
    y = torch.nn.functional.conv2d(x.permute(2, 3, 0, 1), w.permute(3, 2, 0, 1), padding=1)
    (y * g.permute(2, 3, 0, 1)).sum().backward()
    got = cd.conv3x3_dw(x, g, TH=3, TW=5)
    assert torch.allclose(got.double(), w.grad, rtol=1e-6, atol=1e-6)


# --- what the wrappers refuse, checked before any launch ----------------------


@pytest.mark.parametrize("case", ["dtype", "w_dtype", "a_dtype", "gate", "shape"])
def test_fused_cbr_input_checks(case):
    x = torch.zeros((2, 8, 8, 64), dtype=torch.bfloat16)
    a, b = torch.ones(64), torch.zeros(64)
    w = torch.zeros((3, 3, 64, 128), dtype=torch.bfloat16)
    bias = torch.zeros(128)
    err = TypeError
    if case == "dtype":
        x, match = x.float(), "bf16"
    elif case == "w_dtype":
        w, match = w.float(), "bf16"
    elif case == "a_dtype":
        a, match = a.double(), "float32"
    elif case == "gate":
        w, bias, err, match = w[..., :32].contiguous(), bias[:32], ValueError, "Cout"
    else:
        a, err, match = torch.ones(32), ValueError, "shape"
    with pytest.raises(err, match=match):
        fr._check_cuda_inputs(x, a, b, w, bias)


@pytest.mark.parametrize("rows", [0, 3, 16])
def test_fused_cbr_rows_must_divide_h(rows):
    x, a, b, w, bias = map(torch.from_numpy, _cbr_inputs(0, 1, 8, 8, 8, 8))
    with pytest.raises(ValueError, match="rows"):
        fr.fused_cbr(x, a, b, w, bias, rows=rows)


def test_fused_cbr_refuses_other_devices():
    x, a, b, w, bias = (t.to("meta") for t in map(torch.from_numpy, _cbr_inputs(0, 1, 8, 8, 8, 8)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fr.fused_cbr(x, a, b, w, bias)


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 8, 8, 128), (8, 64)])
def test_bn_stats_takes_64_channels(shape):
    with pytest.raises(ValueError, match="64"):
        bs.bn_stats(torch.zeros(shape, dtype=torch.bfloat16))


def test_bn_stats_input_checks():
    x = torch.zeros((2, 4, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        bs._check_cuda_inputs(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        bs._check_cuda_inputs(x.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bs.bn_stats(x.to("meta"))


@pytest.mark.parametrize("th, tw", [(3, 4), (4, 5), (0, 4)])
def test_conv3x3_dw_bands_must_divide(th, tw):
    x, g = torch.zeros((8, 8, 2, 8)), torch.zeros((8, 8, 2, 16))
    with pytest.raises(ValueError, match="TH"):
        cd.conv3x3_dw(x, g, TH=th, TW=tw)


@pytest.mark.parametrize("case", ["variant", "mismatch", "dtype", "mixed", "gate"])
def test_conv3x3_dw_input_checks(case):
    x = torch.zeros((8, 8, 2, 64), dtype=torch.bfloat16)
    g = torch.zeros((8, 8, 2, 128), dtype=torch.bfloat16)
    if case == "variant":
        with pytest.raises(ValueError, match="variant"):
            cd.conv3x3_dw(x, g, variant="im2col")
    elif case == "mismatch":
        with pytest.raises(ValueError, match="agree"):
            cd.conv3x3_dw(x, g[:, :, :1])
    elif case == "dtype":
        with pytest.raises(TypeError, match="bf16 or float32"):
            cd._check_cuda_inputs(x.half(), g.half())
    elif case == "mixed":
        with pytest.raises(TypeError, match="one dtype"):
            cd._check_cuda_inputs(x, g.float())
    else:
        with pytest.raises(ValueError, match="multiples of 64"):
            cd._check_cuda_inputs(x[..., :48].contiguous(), g)


# --- the entry points ---------------------------------------------------------


def test_dw_shapes_are_the_jax_scripts(jax_dw):
    assert port_dw_script.SHAPES == jax_dw.SHAPES and port_dw_script.N == jax_dw.N


def _jax_main(name):
    """The body of main() in the JAX script ``name``, parsed."""
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    return next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")


def _eval(node, env):
    return eval(compile(ast.Expression(node), "<main>", "eval"), {}, env)


def test_fused_cbr_shapes_are_the_jax_scripts():
    """The JAX script keeps its shapes local to main() (:239-252): read them
    from its source."""
    env = {}
    for stmt in _jax_main("proto_fused_cbr").body:
        if isinstance(stmt, ast.Assign) and stmt.targets[0].id in ("N", "shapes"):
            env[stmt.targets[0].id] = _eval(stmt.value, env)
    assert env["shapes"] == port_cbr_script.SHAPES


def test_bn_stats_shape_is_the_jax_scripts(jax_bn):
    """main() :83 draws its activation at one 4-tuple shape."""
    shapes = [_eval(node, {"C": jax_bn.C}) for node in ast.walk(_jax_main("proto_bn_stats"))
              if isinstance(node, ast.Tuple) and len(node.elts) == 4]
    assert shapes == [port_bn_script.SHAPE]


@pytest.mark.parametrize("call", [
    lambda: port_bn_script.bench(),
    lambda: port_bn_script.main(),
    lambda: port_dw_script.main(["check"]),
    lambda: port_dw_script.bench(["btl"]),
    lambda: port_cbr_script.main(["level1"]),
], ids=["bn_bench", "bn_main", "dw_check", "dw_bench", "cbr_main"])
def test_entry_points_need_a_card(call):
    """Without a CUDA device the entry points raise, before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run")
    with pytest.raises(SystemExit, match="CUDA device"):
        call()
