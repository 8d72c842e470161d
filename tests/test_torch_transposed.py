"""The port's transposed-layout kernels (K6-K9) against the JAX package's
Pallas prototypes in ``scripts/``, on the CPU: the plain versions and the
CPU branch of every wrapper.

The JAX scripts are loaded from their files (they are not a package).
``proto_transposed_cbr.py`` has an ``interpret`` switch. The three
bisection scripts have none: the module's ``pl`` is replaced by a namespace
whose ``pallas_call`` forces ``interpret=True`` and records the kernel and
its specs, so that each variant runs on the script's own input (ones) and
then, through the same kernel and specs, on seeded numpy inputs. Nothing in
``scripts/`` changes. Tolerances:

- K6 (float32): y within 1e-5 of max |y|, stats within 1e-4 of max |stats|;
- K7-K9: copies equal; sums and dots (float32 sums in another order, then
  one rounding to bf16) within one bf16 ulp of |y| plus 2^-16 max |y|. One
  ulp is 2^-8 to 2^-7 of |y|: a bar of 2^-8 |y| fails where an element
  rounds to its neighbouring bf16 on one side (18 of the seeded cases);
- K9 stats within 1e-5 of the largest per-channel sum of |y|: y rounds to
  bf16 at a different element here and there on the two sides (above), and
  the stats sum y over 65536 elements a channel, partly cancelling, so
  their difference is measured against the sum of |y|, not against the
  sum itself.

The CUDA kernels are tested on the card (``test_torch_kernels_cuda.py``);
nothing here builds or loads one.
"""

import ast
import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from selectivenet_for_semantic_segmentation_binary_torch.ops import transposed_bisect as tb
from selectivenet_for_semantic_segmentation_binary_torch.ops import transposed_cbr as tc
from selectivenet_for_semantic_segmentation_binary_torch.scripts import (
    bisect_against as port_against_script,
    bisect_transposed as port_k7_script,
    bisect_transposed2 as port_k8_script,
    bisect_transposed3 as port_k9_script,
    proto_transposed_cbr as port_cbr_script,
    timing as port_timing,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load_bisect(name):
    """The script with a ``pl`` that interprets and records every call."""
    module = _load_script(name)
    calls = []

    def pallas_call(kernel, **kw):
        kw["interpret"] = True
        calls.append((kernel, kw))
        return pl.pallas_call(kernel, **kw)

    names = {k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")}
    module.pl = types.SimpleNamespace(**{**names, "pallas_call": pallas_call})
    module.calls = calls
    return module


@pytest.fixture(scope="module")
def jax_cbr():
    return _load_script("proto_transposed_cbr")


@pytest.fixture(scope="module")
def jax_k7():
    return _load_bisect("bisect_transposed")


@pytest.fixture(scope="module")
def jax_k8():
    return _load_bisect("bisect_transposed2")


@pytest.fixture(scope="module")
def jax_k9():
    return _load_bisect("bisect_transposed3")


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


# --- K6: transposed_fused_cbr, v1 and v2 ------------------------------------------


def _cbr_inputs(seed, n, h, w, cin, cout):
    """NHWC x; b far from zero, so relu(b) would show in a leaking halo."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, w, cin)).astype(np.float32),
            (rng.standard_normal(cin) * 0.1 + 1.0).astype(np.float32),
            (rng.standard_normal(cin) * 0.5 + 0.5).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32))


def _hcwn(x_nhwc):
    return np.ascontiguousarray(np.transpose(x_nhwc, (1, 3, 2, 0)))


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("shape, rows, w_blk", [((4, 8, 16, 8, 16), 4, 8),
                                                ((2, 4, 32, 16, 8), 2, 16)],
                         ids=["4x8x16_8to16", "2x4x32_16to8"])
def test_transposed_fused_cbr_matches_jax(jax_cbr, shape, rows, w_blk, prologue):
    x, a, b, w, bias = _cbr_inputs(0, *shape)
    xt = _hcwn(x)
    jx = [jnp.asarray(v) for v in (xt, a, b, w, bias)]
    kw = dict(rows=rows, w_blk=w_blk, apply_prologue=prologue, interpret=True)
    wants = [jax_cbr.transposed_fused_cbr(*jx, **kw), jax_cbr.transposed_fused_cbr_v2(*jx, **kw)]
    if prologue:  # xla_chain always applies the prologue
        cy, cs = jax_cbr.xla_chain(*map(jnp.asarray, (x, a, b, w, bias)))
        wants.append((np.transpose(np.asarray(cy), (1, 3, 2, 0)), cs))
    before = (tc.launches_v1, tc.launches_v2)
    tensors = [torch.from_numpy(v) for v in (xt, a, b, w, bias)]
    n, h, wd, cin, cout = shape
    for y, s in (tc.transposed_fused_cbr(*tensors, rows=rows, w_blk=w_blk,
                                         apply_prologue=prologue),
                 tc.transposed_fused_cbr_v2(*tensors, rows=rows, w_blk=w_blk,
                                            apply_prologue=prologue),
                 tc.transposed_fused_cbr_reference(*tensors, apply_prologue=prologue)):
        assert y.shape == (h, cout, wd, n) and s.shape == (2, cout)
        for wy, ws in wants:
            assert _close(y.numpy(), wy, 1e-5)
            assert _close(s.numpy(), ws, 1e-4)
    assert (tc.launches_v1, tc.launches_v2) == before and tc._lib is None


def test_chain_and_conv_only_match_jax(jax_cbr):
    x, a, b, w, bias = _cbr_inputs(1, 2, 8, 8, 8, 16)
    jy, js = jax_cbr.xla_chain(*map(jnp.asarray, (x, a, b, w, bias)))
    y, s = tc.chain(*map(torch.from_numpy, (x, a, b, w, bias)))
    assert _close(y.numpy(), jy, 1e-5) and _close(s.numpy(), js, 1e-4)
    xn = np.maximum(x * a + b, 0.0).astype(np.float32)
    want = jax_cbr.xla_conv_only(*map(jnp.asarray, (xn, w, bias)))
    assert _close(tc.conv_only(*map(torch.from_numpy, (xn, w, bias))).numpy(), want, 1e-5)


def test_v2_halo_stays_zero_where_a_is_zero(jax_cbr):
    """One channel with a = 0, b > 0: the JAX v2 fills its pad ring with 0
    there (proto_transposed_cbr.py:231-232), the prologue maps it to relu(b)
    and the border rows differ from the JAX v1; the port's v2 keeps the halo
    zero after the affine and equals the JAX v1 everywhere."""
    x, a, b, w, bias = _cbr_inputs(2, 2, 8, 16, 8, 8)
    a[3], b[3] = 0.0, 0.7
    xt = _hcwn(x)
    jx = [jnp.asarray(v) for v in (xt, a, b, w, bias)]
    kw = dict(rows=4, w_blk=16, interpret=True)
    j1 = np.asarray(jax_cbr.transposed_fused_cbr(*jx, **kw)[0])
    j2 = np.asarray(jax_cbr.transposed_fused_cbr_v2(*jx, **kw)[0])
    got = tc.transposed_fused_cbr_v2(*map(torch.from_numpy, (xt, a, b, w, bias)),
                                     rows=4, w_blk=16)[0].numpy()
    interior = (slice(1, -1), slice(None), slice(1, -1))
    assert np.abs(j2 - j1).max() > 1e-2  # the JAX v2 leaks relu(b) into the border
    assert np.abs(j2 - j1)[interior].max() <= 1e-5 * np.abs(j1).max()
    assert _close(got, j1, 1e-5)
    assert np.abs(got - j2)[interior].max() <= 1e-5 * np.abs(j1).max()


@pytest.mark.parametrize("rows, w_blk", [(3, 8), (4, 5), (0, 8)])
def test_transposed_blocks_must_divide(rows, w_blk):
    x, a, b, w, bias = map(torch.from_numpy, _cbr_inputs(0, 2, 8, 16, 8, 8))
    xt = x.permute(1, 3, 2, 0).contiguous()
    for fn in (tc.transposed_fused_cbr, tc.transposed_fused_cbr_v2):
        with pytest.raises(ValueError, match="w_blk"):
            fn(xt, a, b, w, bias, rows=rows, w_blk=w_blk)


@pytest.mark.parametrize("case", ["dtype", "w_dtype", "a_dtype", "gate", "shape", "layout"])
def test_transposed_cbr_input_checks(case):
    x = torch.zeros((8, 64, 16, 8), dtype=torch.bfloat16)
    a, b = torch.ones(64), torch.zeros(64)
    w = torch.zeros((3, 3, 64, 128), dtype=torch.bfloat16)
    bias = torch.zeros(128)
    err = ValueError
    if case == "dtype":
        x, err, match = x.float(), TypeError, "bf16"
    elif case == "w_dtype":
        w, err, match = w.float(), TypeError, "bf16"
    elif case == "a_dtype":
        a, err, match = a.double(), TypeError, "float32"
    elif case == "gate":
        w, bias, match = w[..., :32].contiguous(), bias[:32], "Cout"
    elif case == "shape":
        a, match = torch.ones(32), "shape"
    else:
        x, match = x.transpose(0, 2).contiguous().transpose(0, 2), "contiguous"
    with pytest.raises(err, match=match):
        tc._check_cuda_inputs(x, a, b, w, bias)


def test_transposed_cbr_refuses_other_devices():
    x, a, b, w, bias = (t.to("meta") for t in map(torch.from_numpy,
                                                  _cbr_inputs(0, 2, 8, 16, 8, 8)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tc.transposed_fused_cbr(x.permute(1, 3, 2, 0), a, b, w, bias, w_blk=16)


# --- K7-K9: the bisection kernels ---------------------------------------------------


def _bf16(shape, seed):
    """A seeded bf16 array (JAX) and the same values as a bf16 tensor."""
    xj = jnp.asarray(np.random.default_rng(seed).standard_normal(shape), jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)


def _ones(shape):
    return jnp.ones(shape, jnp.bfloat16), torch.ones(shape, dtype=torch.bfloat16)


def _as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32))


def _within_ulp(got, want):
    """|got - want| <= one bf16 ulp of |want| + 2^-16 max |want|: float32
    sums in another order, each side rounded to bf16 once."""
    got, want = _as_np(got).astype(np.float64), _as_np(want).astype(np.float64)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return bool((np.abs(got - want) <= ulp + 2.0 ** -16 * np.abs(want).max()).all())


def _rerun(module, x, w=None):
    """The last recorded Pallas kernel, with its specs, on other inputs."""
    kernel, kw = module.calls[-1]
    args = (x,) if w is None else (x, w)
    return pl.pallas_call(kernel, **kw)(*args)


def _inputs(which, x_shape, w_shape):
    if which == "ones":
        return _ones(x_shape), _ones(w_shape) if w_shape else (None, None)
    return _bf16(x_shape, 7), _bf16(w_shape, 8) if w_shape else (None, None)


def _round_bf16(v):
    return np.asarray(jnp.asarray(v, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _prologue_safe(shape, seed):
    """A seeded bf16 input on which relu(x * 1.1 + 0.1) rounds to the same
    bf16 whether the product is rounded to float32 first (the K9 body as
    written, the port's kernel and plain version) or not (XLA on the CPU
    contracts the two into one fma): the few elements where the two differ
    are set to 0."""
    xj, _ = _bf16(shape, seed)
    x = np.asarray(xj.astype(jnp.float32))
    two = _round_bf16(np.maximum((x * np.float32(1.1)) + np.float32(0.1), 0))
    one = _round_bf16(np.maximum(
        (x.astype(np.float64) * np.float32(1.1) + np.float32(0.1)).astype(np.float32), 0))
    x = np.where(two == one, x, 0.0).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("which", ["ones", "seeded"])
@pytest.mark.parametrize("variant", tb.K7_VARIANTS)
def test_k7_matches_jax(jax_k7, variant, which):
    m = jax_k7
    n, h, w, c = m.N, m.H, m.W, m.C
    ws = w + 8 if variant == "v5" else w + 2
    out = getattr(m, variant)()  # on the script's own input
    x_shape = (h + 2, c, ws, n) if variant == "v5" else (h + 2, c, ws * n)
    (xj, xt), (wj, wt) = _inputs(which, x_shape, (c, 3 * c) if variant == "v3" else None)
    if which == "seeded":
        out = _rerun(m, xj, wj)
    want = _as_np(out).reshape(h, c, w, n)
    xp = xt.reshape(h + 2, c, ws, n)
    before = tb.launches_k7
    for got in (tb.bisect_transposed(variant, xp, wt), tb.k7_reference(variant, xp, wt)):
        assert got.dtype == torch.bfloat16 and got.shape == (h, c, w, n)
        if variant in ("v1", "v2", "v5"):
            assert np.array_equal(_as_np(got), want)
        else:
            assert _within_ulp(got, want)
    assert tb.launches_k7 == before and tb._lib is None


@pytest.mark.parametrize("which", ["ones", "seeded"])
@pytest.mark.parametrize("body", tb.K8_BODIES)
def test_k8_matches_jax(jax_k8, body, which):
    m = jax_k8
    n, h, w, c = m.N, m.H, m.W, m.C
    out = m.make(getattr(m, body))
    (xj, xt), (wj, wt) = _inputs(which, (h + 2, c, (w + 2) * n), (c, 3 * c))
    if which == "seeded":
        out = _rerun(m, xj, wj)
    want = _as_np(out).reshape(h, c, w, n)
    xp = xt.reshape(h + 2, c, w + 2, n)
    before = tb.launches_k8
    for got in (tb.bisect_transposed2(body, xp, wt), tb.k8_reference(body, xp, wt)):
        assert got.dtype == torch.bfloat16 and got.shape == (h, c, w, n)
        assert _within_ulp(got, want)
    if body == "b":  # bf16 adds: bit for bit
        assert np.array_equal(_as_np(got), want)
    assert tb.launches_k8 == before and tb._lib is None


@pytest.mark.parametrize("which", ["ones", "seeded"])
@pytest.mark.parametrize("case", list(tb.K9_CASES))
def test_k9_matches_jax(jax_k9, case, which):
    m = jax_k9
    n, h, w, c = m.N, m.H, m.W, m.C
    flags = m.CASES[case]
    y, stats = m.build(**flags)
    x_shape = (h + 2, c, (w + 2) * n)
    (xj, xt), (wj, wt) = _inputs(which, x_shape, (3, c, 3 * c))
    if which == "seeded" and flags["prologue"] and flags["scratch"]:
        xj, xt = _prologue_safe(x_shape, 7)
    if which == "seeded":
        y, stats = _rerun(m, xj, wj)
    want = _as_np(y).reshape(h, c, w, n)
    xp = xt.reshape(h + 2, c, w + 2, n)
    before = tb.launches_k9
    for got, s in (tb.bisect_transposed3(xp, wt, **flags), tb.k9_reference(xp, wt, **flags)):
        assert got.dtype == torch.bfloat16 and got.shape == (h, c, w, n)
        assert _within_ulp(got, want)
        assert s.dtype == torch.float32
        assert s.shape == ((8, 128) if flags["stats"] == "pad" else (2, c))
        if flags["stats"]:
            scale = np.abs(want).sum((0, 2, 3)).max()
            assert np.abs(s.numpy() - np.asarray(stats)).max() <= 1e-5 * scale
        else:  # the TPU kernel leaves its stats output unwritten; the port's is zero
            assert not s.any()
    assert tb.launches_k9 == before and tb._lib is None


def test_k9_cases_are_the_jax_scripts(jax_k9):
    assert tb.K9_CASES == jax_k9.CASES
    assert (tb.ROWS, tb.WBLK) == (jax_k9.ROWS, jax_k9.WBLK)


@pytest.mark.parametrize("name", ["bisect_transposed", "bisect_transposed2",
                                  "bisect_transposed3"])
def test_bisect_sizes_are_the_jax_scripts(name):
    m = _load_script(name)
    assert (tb.N, tb.H, tb.W, tb.C) == (m.N, m.H, m.W, m.C)


def test_k9_prologue_rounds_the_product():
    """The port's K9 prologue is the body as written, x * 1.1 rounded to
    float32, then + 0.1 (as the CUDA kernel's __fmul_rn / __fadd_rn): not
    one fma, which XLA on the CPU makes of it."""
    xj, xt = _bf16((3, 8, 4, 64), 9)
    x = np.asarray(xj.astype(jnp.float32))
    w = torch.zeros((3, 8, 24), dtype=torch.bfloat16)
    w[0, :, 8:16] = torch.eye(8)  # dy = 1, identity: y = src[h+1, :, w, :]
    y, _ = tb.bisect_transposed3(xt, w, prologue=True, zero_ring=False, merge_dot=True,
                                 shift=False, stats=False, scratch=True, rows=1, w_blk=2)
    two = _round_bf16(np.maximum((x * np.float32(1.1)) + np.float32(0.1), 0))
    one = _round_bf16(np.maximum(
        (x.astype(np.float64) * np.float32(1.1) + np.float32(0.1)).astype(np.float32), 0))
    assert (two != one)[1:2, :, 0:2].any()  # the input tells the two apart
    assert np.array_equal(y.float().numpy(), two[1:2, :, 0:2])


def test_zero_ring_zeroes_top_row_and_left_column_only():
    """zero_ring on ones: the first output row and column lose their zeroed
    taps; the last row and column (bottom, right ring) keep theirs."""
    xp = torch.ones((6, 8, 6, 2), dtype=torch.bfloat16)
    w = torch.zeros((3, 8, 24), dtype=torch.bfloat16)
    w[0, :, :8] = 1.0  # the dy = 0 block: sum over channels
    y, _ = tb.bisect_transposed3(xp, w, prologue=False, zero_ring=True, merge_dot=True,
                                 shift=True, stats=False, scratch=True, rows=2, w_blk=2)
    row = y[:, 0, :, 0].float()
    assert float(row[0, 0]) == 0.0  # dy = 0 reads the zeroed row 0
    assert float(row[1, 0]) == 2 * 8 and float(row[1, 1]) == 3 * 8
    assert float(row[3, 3]) == 3 * 8


@pytest.mark.parametrize("case", ["variant", "dtype", "w_shape", "layout", "blocks", "v3_w",
                                  "stats"])
def test_bisect_input_checks(case):
    xp = torch.zeros((6, 8, 10, 4), dtype=torch.bfloat16)
    w = torch.zeros((8, 24), dtype=torch.bfloat16)
    flags = dict(tb.K9_CASES["all"])
    if case == "variant":
        with pytest.raises(ValueError, match="variant"):
            tb.bisect_transposed("v6", xp)
    elif case == "dtype":
        with pytest.raises(TypeError, match="bf16"):
            tb._check_cuda_inputs(xp.float(), None, None)
    elif case == "w_shape":
        with pytest.raises(ValueError, match="shape"):
            tb._check_cuda_inputs(xp, w[:, :8], (8, 24))
    elif case == "layout":
        with pytest.raises(ValueError, match="contiguous"):
            tb._check_cuda_inputs(xp.transpose(1, 2).contiguous().transpose(1, 2), w, (8, 24))
    elif case == "blocks":
        with pytest.raises(ValueError, match="w_blk"):
            tb.bisect_transposed3(xp, torch.zeros((3, 8, 24), dtype=torch.bfloat16), **flags,
                                  rows=3, w_blk=4)
    elif case == "v3_w":
        with pytest.raises(ValueError, match="needs w"):
            tb.bisect_transposed("v3", xp)
    else:
        flags["stats"] = "3d"
        with pytest.raises(ValueError, match="stats"):
            tb.bisect_transposed3(xp, torch.zeros((3, 8, 24), dtype=torch.bfloat16), **flags,
                                  rows=2, w_blk=4)


def test_bisect_refuses_other_devices():
    xp = torch.zeros((6, 8, 10, 4), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tb.bisect_transposed("v1", xp)


# --- the entry points ---------------------------------------------------------------


def test_bench_blocks_are_the_jax_scripts():
    """The JAX bench's (rows, w_blk, vmem_mb) list (proto_transposed_cbr.py
    :366-368), read from its source."""
    with open(os.path.join(SCRIPTS, "proto_transposed_cbr.py")) as f:
        tree = ast.parse(f.read())
    bench = next(node for node in tree.body
                 if isinstance(node, ast.FunctionDef) and node.name == "bench")
    loop = next(node for node in ast.walk(bench) if isinstance(node, ast.For))
    assert ast.literal_eval(loop.iter) == port_cbr_script.V2_BLOCKS


def test_check_and_bench_shapes_are_the_jax_scripts(jax_cbr):
    import inspect

    for fn, shape in ((jax_cbr.check_numerics, port_cbr_script.CHECK_SHAPE),
                      (jax_cbr.bench, port_cbr_script.BENCH_SHAPE)):
        p = inspect.signature(fn).parameters
        assert tuple(p[k].default for k in ("N", "H", "W", "Cin", "Cout")) == shape


@pytest.mark.parametrize("call", [
    lambda: port_cbr_script.main(["check"]),
    lambda: port_cbr_script.main(["bench"]),
    lambda: port_k7_script.main([]),
    lambda: port_k8_script.main(["a"]),
    lambda: port_k9_script.main(["all"]),
    lambda: port_against_script.main(["other/transposed_bisect.cu"]),
], ids=["cbr_check", "cbr_bench", "k7", "k8", "k9", "against"])
def test_entry_points_need_a_card(call):
    """Without a CUDA device the entry points raise, before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run")
    with pytest.raises(SystemExit, match="CUDA device"):
        call()


def test_entry_points_hold_the_plain_version_on_the_cpu(monkeypatch, capsys):
    """The bisection scripts' comparison, run on CPU tensors (the wrappers'
    plain branch) at a small size: every variant passes, and a kernel that
    disagrees raises at once."""
    small = dict(n=4, h=4, w=16, c=8)
    for script, names in ((port_k7_script, tb.K7_VARIANTS), (port_k8_script, tb.K8_BODIES),
                          (port_k9_script, list(tb.K9_CASES))):
        results = script.run(names, device=torch.device("cpu"), **small)
        assert [r["name"] for r in results] == [f"{n}/{w}" for n in names
                                               for w in ("ones", "seeded")]
    assert "v1/ones: OK" in capsys.readouterr().out
    monkeypatch.setattr(tb, "bisect_transposed2", functools.partial(
        lambda f, body, xp, w: f(body, xp, w) + 1, tb.bisect_transposed2))
    with pytest.raises(AssertionError, match="disagrees"):
        port_k8_script.run(["a"], device=torch.device("cpu"), **small)


def _window_case(case, n=4, h=4, w=16, c=8):
    """(xp, dys, dxs, skip_zeroed, the plain version) of one K7-K9 case."""
    kernel, name = case.split(":")
    g = torch.Generator().manual_seed(0)
    wm = torch.randn((3, c, 3 * c), generator=g).to(torch.bfloat16)
    skip = False
    if kernel == "K7":
        (dys, dxs), ws = port_k7_script.TAPS[name], w + (8 if name == "v5" else 2)
        fn = functools.partial(tb.k7_reference, name, w=wm[0])
    elif kernel == "K8":
        (dys, dxs), ws = port_k8_script.TAPS[name], w + 2
        fn = functools.partial(tb.k8_reference, name, w=wm[0])
    else:
        flags = tb.K9_CASES[name]
        (dys, dxs), ws, skip = port_k9_script.taps(flags), w + 2, flags["zero_ring"]
        fn = lambda xp: tb.k9_reference(xp, wm, **flags)[0]  # noqa: E731
    xp = torch.randn((h + 2, c, ws, n), generator=g).to(torch.bfloat16)
    return xp, dys, dxs, skip, fn


@pytest.mark.parametrize("case", [f"K7:{v}" for v in tb.K7_VARIANTS]
                         + [f"K8:{b}" for b in tb.K8_BODIES]
                         + [f"K9:{c}" for c in tb.K9_CASES])
def test_bound_counts_the_window_the_function_reads(case):
    """``window_bytes``, the bytes of xp in the scripts' bound, is exactly
    the part of xp the function depends on: NaN everywhere else changes no
    output element."""
    h, w = 4, 16
    xp, dys, dxs, skip, fn = _window_case(case, h=h, w=w)
    inside = torch.zeros(xp.shape, dtype=torch.bool)
    inside[min(dys):max(dys) + h, :, min(dxs):max(dxs) + w] = True
    if skip:
        inside[0] = False
        inside[:, :, 0] = False
    assert torch.equal(fn(xp.masked_fill(~inside, float("nan"))), fn(xp))
    assert port_k7_script.window_bytes(xp, dys, dxs, h, w, skip) == 2 * int(inside.sum())


@pytest.mark.parametrize("case", ["K7:v3", "K7:v4", "K8:a", "K8:c", "K8:d", "K8:e"])
def test_one_call_counterparts_equal_plain_versions(case):
    """The one PyTorch call each script times beside a sum or a dot (an
    overlapping view of xp, then one reduction or one ``torch.bmm``) is the
    plain version's function, within the scripts' bar."""
    h, w = 6, 16
    xp, dys, dxs, _, fn = _window_case(case, n=8, h=h, w=w, c=16)
    wm = torch.randn((16, 48), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    if case in ("K7:v4", "K8:a"):
        got = port_k7_script.one_call_sum(xp, dys, dxs, h, w)
    else:
        got = port_k7_script.one_call_dot(xp, wm, dys, dxs[0], h, w)
        fn = functools.partial(fn, w=wm)
    port_k7_script.hold(case, got, fn(xp), exact=False)


def test_run_case_times_every_callable_with_a_cold_l2(monkeypatch):
    """The bisection scripts time the kernel, the plain version and the one
    PyTorch call each with the L2 flushed before every run."""
    seen = []

    def record(fn, runs=None, warmup=None, flush_l2=False):
        seen.append((fn, flush_l2))
        return 1.0

    monkeypatch.setattr(port_timing, "median_ms_device", record)
    monkeypatch.setattr(port_k7_script, "median_ms_device", record)
    xp = torch.ones((3, 8, 4, 2), dtype=torch.bfloat16)

    def kernel():
        return tb.bisect_transposed("v1", xp)

    def plain():
        return tb.k7_reference("v1", xp)

    def library():
        return xp[1:2, :, 1:3, :].contiguous()

    out = port_k7_script.run_case("v1/ones", kernel, plain, True, 64, 0, True, library,
                                  library_exact=True)
    assert sorted(fn.__name__ for fn, _ in seen) == ["kernel", "kernel", "library", "plain",
                                                     "plain"]
    assert all(flush for _, flush in seen)
    assert (out["ms"], out["plain_ms"], out["library_ms"]) == (1.0, 1.0, 1.0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case, want", [
    ("mixed", {"one_call_cases": 2, "ms_on_one_call_cases": 5.0, "library_ms": 0.75}),
    ("none", {"one_call_cases": 0, "ms_on_one_call_cases": 0, "library_ms": None}),
    ("all", {"one_call_cases": 3, "ms_on_one_call_cases": 7.0, "library_ms": 1.75}),
])
def test_one_call_summary_of_the_kernels_line(case, want):
    """chip_smoke.py's K7-K9 records: the one call's ms summed over the cases
    that have one, beside their count and the kernel's ms on them."""
    library = {"mixed": (0.5, None, 0.25), "none": (None, None, None), "all": (0.5, 1.0, 0.25)}
    results = [{"ms": ms, "library_ms": lib} for ms, lib in zip((1.0, 2.0, 4.0), library[case])]
    smoke = _chip_smoke()
    assert smoke.one_call_summary(results) == want
    text = smoke._one_call_sum(results)
    assert text == "none" if case == "none" else text.startswith(
        f"{want['library_ms']:.4f} over {want['one_call_cases']} of 3 cases")


def test_kernel_path_of_a_cpu_tensor_is_the_plain_version():
    xp = torch.zeros((3, 8, 4, 8), dtype=torch.bfloat16)
    assert tb.kernel_path(xp) == "plain" and tb.kernel_path(xp, torch.zeros((8, 24))) == "plain"
    assert tb._lib is None


@pytest.mark.parametrize("case, passes", [("K7:v1", False), ("K7:v4", False), ("K8:a", False),
                                          ("K8:b", False), ("K7:v3", True), ("K8:c", True)])
def test_scripts_hold_copies_and_sums_bit_for_bit(monkeypatch, case, passes):
    """A kernel one bf16 ulp off at one element: a copy or a sum fails the
    scripts' comparison (the same adds in the same order must give the same
    bits), a dot passes it (float32 sums in another order)."""
    kernel, name = case.split(":")
    script, wrapper = ((port_k7_script, "bisect_transposed") if kernel == "K7"
                       else (port_k8_script, "bisect_transposed2"))

    def one_ulp_off(f, *args):
        y = f(*args).clone(memory_format=torch.contiguous_format)
        y.view(torch.int16).view(-1)[0] += 1
        return y

    monkeypatch.setattr(tb, wrapper, functools.partial(one_ulp_off, getattr(tb, wrapper)))
    run = functools.partial(script.run, [name], device=torch.device("cpu"), n=4, h=4, w=16, c=8)
    if passes:
        assert len(run()) == 2
    else:
        with pytest.raises(AssertionError, match="exact=True"):
            run()
