"""The port's CUDA kernels against their plain versions, on a card: the
eval-metrics kernel, the fused-CBR kernel (``fused_conv_stats``), the three
NHWC prototype kernels (``fused_cbr_rows``, ``bn_stats``, ``conv_dw``),
the transposed-layout ones (``transposed_cbr`` v1 and v2, the K7-K9
bisection kernels of ``transposed_bisect``) and the int8 conv (K10,
``int8_conv``).

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports no JAX, so it runs on the card's machine,
which has none, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch.ops import bn_stats as bs
from selectivenet_for_semantic_segmentation_binary_torch.ops import conv_dw as cd
from selectivenet_for_semantic_segmentation_binary_torch.ops import eval_metrics as em
from selectivenet_for_semantic_segmentation_binary_torch.ops import fused_cbr as fc
from selectivenet_for_semantic_segmentation_binary_torch.ops import fused_cbr_rows as fr
from selectivenet_for_semantic_segmentation_binary_torch.ops import int8_conv as ic
from selectivenet_for_semantic_segmentation_binary_torch.ops import transposed_bisect as tb
from selectivenet_for_semantic_segmentation_binary_torch.ops import transposed_cbr as tc
from selectivenet_for_semantic_segmentation_binary_torch.ops.confusion import PAD_LABEL
from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import (CBR_LAYERS,
                                                                               INT8_LAYERS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run this file or chip_smoke.py on the card)")
    return torch.device("cuda", 0)


def _inputs(device, shape, label_dtype, seed=0):
    rng = np.random.default_rng(seed)
    out = rng.standard_normal(shape).astype(np.float32)
    sel = rng.standard_normal(shape).astype(np.float32)
    out.reshape(-1)[::7] = 0.0  # exactly on logit(0.5)
    lab = rng.integers(0, 2, shape).astype(np.int32)
    lab.reshape(-1)[::13] = PAD_LABEL
    lab[-1] = PAD_LABEL
    return (torch.from_numpy(out).to(device), torch.from_numpy(sel).to(device),
            torch.from_numpy(lab.astype(label_dtype)).to(device))


@pytest.mark.parametrize("label_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("selective", [True, False])
@pytest.mark.parametrize("apply_sigmoid", [True, False])
@pytest.mark.parametrize("shape", [(3, 33, 47), (2, 256, 256)])
def test_kernel_equals_plain_version(cuda_device, shape, apply_sigmoid, selective,
                                     label_dtype):
    out, sel, lab = _inputs(cuda_device, shape, label_dtype)
    kw = dict(apply_sigmoid=apply_sigmoid, selective=selective, cut_off=0.3, s_cut_off=0.7)
    before = em.launches
    got = em.fused_eval_metrics(out, lab, sel if selective else None, **kw)
    want = em.eval_metrics_reference(out, lab, sel if selective else None, **kw)
    assert em.launches == before + 1
    for k in ("cm", "n_reject", "n_pix"):
        assert got[k].dtype == torch.int64
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


@pytest.mark.parametrize("label_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 33, 47)], ids=["n%16==0", "n%16!=0"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset_view"])
def test_kernel_paths_equal_plain_version(cuda_device, shape, offset, label_dtype):
    """Views one element into the buffers take the element path, aligned
    tensors the 16-byte path with an element tail where n % 16 != 0."""
    out, sel, lab = _inputs(cuda_device, shape, label_dtype, seed=3)
    t = [v.view(-1)[offset:] for v in (out, lab, sel)]
    assert em.kernel_path(*t) == ("element" if offset else "vector")
    kw = dict(apply_sigmoid=True, selective=True, cut_off=0.5, s_cut_off=0.5)
    got = em.fused_eval_metrics(t[0], t[1], t[2], **kw)
    want = em.eval_metrics_reference(t[0], t[1], t[2], **kw)
    for k in ("cm", "n_reject", "n_pix"):
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def test_kernel_counts_a_batch_of_padding_only(cuda_device):
    out, sel, lab = _inputs(cuda_device, (2, 48, 40), np.uint8)
    lab.fill_(PAD_LABEL)
    got = em.fused_eval_metrics(out, lab, sel, selective=True)
    assert int(got["n_pix"]) == 0 and int(got["n_reject"]) == 0 and int(got["cm"].sum()) == 0


def test_kernel_is_one_launch_a_call(cuda_device):
    """The counts are finished inside the kernel: a warm call runs exactly
    one kernel on the card, and calls in a row stay exact (the kernel's
    ticket counter is left at 0)."""
    out, sel, lab = _inputs(cuda_device, (4, 128, 128), np.uint8)
    kw = dict(apply_sigmoid=True, selective=True)
    want = em.eval_metrics_reference(out, lab, sel, **kw)
    em.fused_eval_metrics(out, lab, sel, **kw)  # warm: the ticket is allocated once
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = em.fused_eval_metrics(out, lab, sel, **kw)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert len(kernels) == 1 and "eval_metrics_kernel" in kernels[0], kernels
    for _ in range(3):
        again = em.fused_eval_metrics(out, lab, sel, **kw)
    for k in ("cm", "n_reject", "n_pix"):
        assert torch.equal(got[k].cpu(), want[k].cpu()) and torch.equal(again[k], got[k]), k


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    out, sel, lab = _inputs(cuda_device, (2, 16, 16), np.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        em.fused_eval_metrics(out.transpose(1, 2), lab.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        em.fused_eval_metrics(out.half(), lab)
    with pytest.raises(ValueError, match="uint8 or int32"):
        em.fused_eval_metrics(out, lab.long())
    with pytest.raises(ValueError, match="selection"):
        em.fused_eval_metrics(out, lab, None, selective=True)
    with pytest.raises(ValueError, match="is on"):
        em.fused_eval_metrics(out, lab.cpu())


# --- fused_conv_stats -------------------------------------------------------
# y in bf16: within 2^-7 |y| (one or two ulps) of a float32 conv of the same
# operands rounded once, as the kernel rounds; within 2^-6 (|y| + |bias|) of
# the plain version, which rounds the conv output before adding the bias;
# plus 2^-16 max|y| near zero. Stats: 1e-5 of [sum |y|, sum y^2] against the
# sums of the kernel's own y (float32 order only).


def _cbr_inputs(device, n, h, w, cin, cout, seed=0, b_scale=0.5):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((n, h, w, cin), generator=g, device=device) * 2 + 0.3).to(torch.bfloat16)
    a = torch.rand((cin,), generator=g, device=device) + 0.5
    b = torch.randn((cin,), generator=g, device=device) * b_scale
    wt = torch.randn((3, 3, cin, cout), generator=g, device=device) * math.sqrt(2 / (9 * cin))
    bias = torch.randn((cout,), generator=g, device=device) * 0.1
    return x, a, b, wt.to(torch.bfloat16), bias


def _exact(x, a, b, w, bias, prologue):
    xn = torch.relu(x.float() * a + b).to(x.dtype) if prologue else x
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = torch.nn.functional.conv2d(xn.float().permute(0, 3, 1, 2),
                                       w.float().permute(3, 2, 0, 1), padding=1)
    return (y.permute(0, 2, 3, 1) + bias).to(x.dtype)


def _check_y(y, inputs, prologue):
    _, _, _, _, bias = inputs
    ye = _exact(*inputs, prologue).float()
    yp = fc.fused_conv_stats_reference(*inputs, prologue)[0].float()
    yk = y.float()
    floor = 2.0 ** -16 * float(ye.abs().max())
    assert bool(((yk - ye).abs() <= 2.0 ** -7 * ye.abs() + floor).all())
    assert bool(((yk - yp).abs() <= 2.0 ** -6 * (yp.abs() + bias.abs()) + floor).all())


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 64, 64), (2, 16, 16, 128, 256),
                                   (1, 8, 8, 512, 512), (3, 33, 47, 64, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_conv_stats_equals_plain_version(cuda_device, shape, prologue):
    n, h, w, cin, cout = shape
    inputs = _cbr_inputs(cuda_device, n, h, w, cin, cout)
    before = fc.launches
    y, s = fc.fused_conv_stats(*inputs, prologue)
    torch.cuda.synchronize()
    assert fc.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (n, h, w, cout) and s.shape == (2, cout)
    _check_y(y, inputs, prologue)
    yf = y.float()
    own = torch.stack([yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
    scale = torch.stack([yf.abs().sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
    assert float(((s - own).abs() / scale).max()) <= 1e-5


def test_fused_conv_stats_halo(cuda_device):
    """A large prologue shift on a small image: most outputs touch the halo,
    which must be zero after the affine."""
    inputs = _cbr_inputs(cuda_device, 1, 4, 5, 64, 64, seed=1, b_scale=3.0)
    y, _ = fc.fused_conv_stats(*inputs, True)
    _check_y(y, inputs, True)


def test_fused_conv_stats_is_deterministic(cuda_device):
    inputs = _cbr_inputs(cuda_device, 4, 64, 64, 128, 128, seed=2)
    y1, s1 = fc.fused_conv_stats(*inputs, True)
    y2, s2 = fc.fused_conv_stats(*inputs, True)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_fused_conv_stats_gradients(cuda_device):
    """Through the autograd.Function against autograd of the plain version:
    2e-2 of the largest |gradient| (bf16 operands and cotangents)."""
    inputs = _cbr_inputs(cuda_device, 2, 32, 32, 64, 128, seed=3)
    grads = []
    for fn in (fc.fused_conv_stats, fc.fused_conv_stats_reference):
        args = [t.detach().clone().requires_grad_(True) for t in inputs]
        y, s = fn(*args, True)
        mean, var = fc.moments_from_stats(s, y.shape[0] * y.shape[1] * y.shape[2])
        ((y.float() ** 2).sum() * 1e-3 + mean.sum() + var.sum()).backward()
        grads.append([t.grad.float() for t in args])
    for gk, gp in zip(*grads):
        assert float((gk - gp).abs().max()) <= 2e-2 * float(gp.abs().max())


def test_fused_conv_stats_rejects_what_it_does_not_take(cuda_device):
    x, a, b, w, bias = _cbr_inputs(cuda_device, 2, 8, 8, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_conv_stats(x.permute(0, 2, 1, 3), a, b, w, bias, True)
    with pytest.raises(ValueError, match="bf16"):
        fc.fused_conv_stats(x.float(), a, b, w, bias, True)
    with pytest.raises(ValueError, match="is on"):
        fc.fused_conv_stats(x, a.cpu(), b, w, bias, True)
    with pytest.raises(ValueError, match="Cout"):
        fc.fused_conv_stats(x, a, b, w[..., :32].contiguous(), bias[:32], True)


# The distinct (Cin, Cout, H = W) of the fused trunk's kernel layers at a
# 256x256 input.
CBR_LAYER_SHAPES = tuple(sorted({(cin, cout, size) for _, cin, cout, size, _ in CBR_LAYERS}))


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("layer", CBR_LAYER_SHAPES, ids=lambda s: "{}to{}at{}".format(*s))
def test_fused_conv_stats_at_every_layer_shape(cuda_device, layer, prologue):
    """Every distinct layer shape of the fused trunk at batch 2: both tile
    widths (Cout 64 and multiples of 128), one to eight channel chunks."""
    cin, cout, size = layer
    inputs = _cbr_inputs(cuda_device, 2, size, size, cin, cout, seed=cin + cout)
    y, s = fc.fused_conv_stats(*inputs, prologue)
    torch.cuda.synchronize()
    _check_y(y, inputs, prologue)
    _check_stats_own(y, s)


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("shape", [(17, 9, 13, 64, 64), (17, 8, 8, 128, 256), (16, 6, 10, 64, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_conv_stats_tiles_past_the_first_samples(cuda_device, shape, prologue):
    """A tile holds 8 samples: at N = 16 and 17 (a ragged tile of one)
    the tiles that start at sample 8 and 16 are held to the references, at
    both tile widths."""
    inputs = _cbr_inputs(cuda_device, *shape, seed=17)
    y, s = fc.fused_conv_stats(*inputs, prologue)
    torch.cuda.synchronize()
    _check_y(y, inputs, prologue)
    _check_stats_own(y, s)


@pytest.mark.parametrize("shape", [(3, 9, 13, 64, 128), (2, 16, 16, 128, 256), (1, 6, 10, 64, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_conv_stats_halo_where_a_is_zero(cuda_device, shape):
    """a = 0 and b > 0 in every other channel: the staged band's in-image
    rows become relu(b) there, its halo must stay zero after the affine."""
    inputs = list(_cbr_inputs(cuda_device, *shape, seed=4))
    inputs[1][::2] = 0.0
    inputs[2][::2] = 0.7
    y, s = fc.fused_conv_stats(*inputs, True)
    _check_y(y, inputs, True)
    _check_stats_own(y, s)


@pytest.mark.parametrize("shape", [(16, 32, 32, 64, 64), (8, 16, 16, 512, 256),
                                   (3, 33, 47, 128, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_conv_stats_runs_agree(cuda_device, shape):
    """Persistent CTAs over many tiles, both tile widths: y and stats the
    same from run to run."""
    inputs = _cbr_inputs(cuda_device, *shape, seed=8)
    y1, s1 = fc.fused_conv_stats(*inputs, True)
    y2, s2 = fc.fused_conv_stats(*inputs, True)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("cout", [64, 256])
def test_fused_conv_stats_gradients_both_widths(cuda_device, cout):
    inputs = _cbr_inputs(cuda_device, 2, 16, 16, 128, cout, seed=9)
    grads = []
    for fn in (fc.fused_conv_stats, fc.fused_conv_stats_reference):
        args = [t.detach().clone().requires_grad_(True) for t in inputs]
        y, s = fn(*args, True)
        mean, var = fc.moments_from_stats(s, y.shape[0] * y.shape[1] * y.shape[2])
        ((y.float() ** 2).sum() * 1e-3 + mean.sum() + var.sum()).backward()
        grads.append([t.grad.float() for t in args])
    for gk, gp in zip(*grads):
        assert float((gk - gp).abs().max()) <= 2e-2 * float(gp.abs().max())


def test_fused_trunk_trains_in_float32(cuda_device):
    """--fused_cbr on --compute_dtype float32: one train step on the card.
    Every layer takes the plain dataflow (the kernel is bf16 only), so the
    kernel is not launched."""
    from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
    from selectivenet_for_semantic_segmentation_binary_torch.models import build_model
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_train_step

    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", batch_size=2,
                      patch_size=32, compute_dtype="float32", fused_cbr="on")
    torch.manual_seed(0)
    model = build_model("UNet_B", selective=True, compute_dtype="float32", fused=True)
    model.to(cuda_device)
    step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    rng = np.random.default_rng(0)
    batch = {"input": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
             "label": torch.from_numpy((rng.random((2, 32, 32)) > 0.5).astype(np.uint8))}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    before = fc.launches
    metrics = step(batch, 1e-3)
    torch.cuda.synchronize()
    assert fc.launches == before
    assert math.isfinite(float(metrics["loss"])) and float(metrics["sel_loss"]) >= 0
    assert int(metrics["cm"].sum()) <= 2 * 32 * 32


def test_train_step_does_not_sync(cuda_device):
    """The fused bf16 train step, counts included, runs under
    set_sync_debug_mode("error"): nothing in it waits for the host."""
    from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
    from selectivenet_for_semantic_segmentation_binary_torch.models import build_model
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_train_step

    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", batch_size=2,
                      patch_size=32, compute_dtype="bfloat16", fused_cbr="on")
    model = build_model("UNet_B", selective=True, compute_dtype="bfloat16", fused=True)
    model.to(cuda_device)
    step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    rng = np.random.default_rng(1)
    batch = {"input": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)),
             "label": torch.from_numpy((rng.random((2, 32, 32)) > 0.5).astype(np.uint8)),
             "flips": torch.from_numpy(rng.integers(0, 2, (2, 2), dtype=np.uint8))}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    step(batch, 1e-3)  # first call: the kernel's build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(batch, 1e-3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(metrics["cm"].sum()) <= 2 * 32 * 32


# --- fused_cbr_rows -----------------------------------------------------------
# The same function as fused_conv_stats, so the same tolerances (above).


def _check_stats_own(y, s):
    yf = y.float()
    own = torch.stack([yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
    scale = torch.stack([yf.abs().sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
    assert float(((s - own).abs() / scale).max()) <= 1e-5


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 64, 64), (2, 16, 16, 128, 256),
                                   (1, 8, 8, 512, 512), (3, 33, 47, 64, 128),
                                   (1, 5, 70, 32, 64), (2, 64, 64, 64, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_cbr_rows_equals_plain_version(cuda_device, shape, prologue):
    n, h, w, cin, cout = shape
    inputs = _cbr_inputs(cuda_device, n, h, w, cin, cout)
    before = fr.launches
    y, s = fr.fused_cbr(*inputs, rows=1, apply_prologue=prologue)
    torch.cuda.synchronize()
    assert fr.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (n, h, w, cout) and s.shape == (2, cout)
    _check_y(y, inputs, prologue)
    _check_stats_own(y, s)


def test_fused_cbr_rows_halo(cuda_device):
    """A large prologue shift on small images, at Cin 64 and 32 (a last
    chunk of 32 channels): most outputs touch the halo, which must be zero
    after the affine."""
    for shape in ((1, 4, 5, 64, 64), (2, 3, 66, 32, 64)):
        inputs = _cbr_inputs(cuda_device, *shape, seed=1, b_scale=3.0)
        y, _ = fr.fused_cbr(*inputs, rows=1)
        _check_y(y, inputs, True)


@pytest.mark.parametrize("cin", [32, 96])
def test_fused_cbr_rows_tail_chunk_ignores_what_lies_past_cin(cuda_device, cin):
    """Cin % 64 == 32: the band kernel's last chunk holds 32 channels and 32
    of TMA's zeros. a = 0, b = 0.7 in every other channel, and NaN after a
    and b in memory: nothing past Cin may reach y or the stats. K3 counts
    its own launch, not fused_conv_stats'."""
    x, a, b, w, bias = _cbr_inputs(cuda_device, 3, 9, 13, cin, 64, seed=4)
    a_mem = torch.full((cin + 64,), float("nan"), device=cuda_device)
    b_mem = torch.full((cin + 64,), float("nan"), device=cuda_device)
    a_mem[:cin], b_mem[:cin] = a, b
    a, b = a_mem[:cin], b_mem[:cin]
    a[::2], b[::2] = 0.0, 0.7
    inputs = (x, a, b, w, bias)
    before_k3, before_k2 = fr.launches, fc.launches
    y, s = fr.fused_cbr(*inputs, rows=1)
    torch.cuda.synchronize()
    assert (fr.launches, fc.launches) == (before_k3 + 1, before_k2)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s).all())
    _check_y(y, inputs, True)
    _check_stats_own(y, s)


def test_fused_cbr_rows_is_deterministic(cuda_device):
    inputs = _cbr_inputs(cuda_device, 4, 64, 64, 128, 128, seed=2)
    y1, s1 = fr.fused_cbr(*inputs, rows=8)
    y2, s2 = fr.fused_cbr(*inputs, rows=16)  # rows does not change the kernel's tiles
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_fused_cbr_rows_rejects_what_it_does_not_take(cuda_device):
    x, a, b, w, bias = _cbr_inputs(cuda_device, 2, 8, 8, 64, 64)
    with pytest.raises(TypeError, match="bf16"):
        fr.fused_cbr(x.float(), a, b, w, bias)
    with pytest.raises(ValueError, match="rows"):
        fr.fused_cbr(x, a, b, w, bias, rows=3)
    with pytest.raises(ValueError, match="is on"):
        fr.fused_cbr(x, a.cpu(), b, w, bias)


# --- bn_stats -------------------------------------------------------------------
# Against float64 sums of the same bf16 values and against the plain version:
# within 1e-5 of sum |x| (sum) and of sum x^2 (sumsq), float32 order only.


def _bn_check(x, s, q):
    xd = x.double().reshape(-1, 64)
    scale_s, scale_q = float(xd.abs().sum()), float((xd * xd).sum())
    ps, pq = bs.bn_stats_reference(x)
    for ws, wq in ((xd.sum(0), (xd * xd).sum(0)), (ps.double(), pq.double())):
        assert float((s.double() - ws).abs().max()) <= 1e-5 * scale_s
        assert float((q.double() - wq).abs().max()) <= 1e-5 * scale_q


@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (1, 50, 41, 64), (3, 33, 47, 64),
                                   (16, 128, 128, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_stats_equals_plain_version(cuda_device, shape):
    """(1, 50, 41): 2050 rows, a tail the TPU grid (1024 row pairs a step)
    would drop; (3, 33, 47): an odd row count."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(torch.bfloat16)
    before = bs.launches
    s, q = bs.bn_stats(x)
    torch.cuda.synchronize()
    assert bs.launches == before + 1
    assert s.shape == q.shape == (64,) and s.dtype == q.dtype == torch.float32
    _bn_check(x, s, q)
    s2, q2 = bs.bn_stats(x)
    assert torch.equal(s, s2) and torch.equal(q, q2)


def test_bn_stats_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 4, 4, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        bs.bn_stats(x.float())
    with pytest.raises(ValueError, match="64"):
        bs.bn_stats(x[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        bs.bn_stats(x.transpose(1, 2))


# --- conv_dw --------------------------------------------------------------------
# Against float64 of the same operands, rounded once: 1e-4 of max |dW| for bf16
# operands (float32 tensor-core sums over up to millions of pixels), 2e-6 for
# float32 (the JAX script's bar, proto_pallas_dw.py:207). Against the plain
# version (cuDNN): 2e-2 for bf16 (the script's bar, :217; cuDNN rounds dW to
# bf16) and 1e-4 for float32, since cuDNN's float32 weight gradient, TF32
# off, is itself 4e-6 to 3.3e-5 of max |dW| from float64 at these shapes
# (NVIDIA H100 80GB HBM3).
DW_EXACT_TOL = {torch.bfloat16: 1e-4, torch.float32: 2e-6}
DW_PLAIN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _dw_rel(got, want):
    return float((got.double() - want.double()).abs().max()) / float(want.abs().max())


def _dw_check(x, g, got):
    exact = cd.conv3x3_dw_reference(x.double(), g.double())
    assert _dw_rel(got, exact) <= DW_EXACT_TOL[x.dtype]
    assert _dw_rel(got, cd.conv3x3_dw_reference(x, g)) <= DW_PLAIN_TOL[x.dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(16, 16, 8, 64, 64, 8, 8), (16, 24, 8, 128, 64, 8, 8),
                                   (8, 8, 16, 64, 128, 4, 4), (32, 16, 4, 128, 128, 8, 16),
                                   (9, 13, 3, 64, 128, 1, 1), (32, 32, 32, 256, 64, 4, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_dw_equals_plain_version(cuda_device, shape, dtype):
    """The JAX script's check shapes (proto_pallas_dw.py:195-200), a ragged
    one (a pixel count no multiple of a K step) and a deeper one."""
    h, w, n, ci, co, th, tw = shape
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((h, w, n, ci), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((h, w, n, co), generator=gen, device=cuda_device).to(dtype)
    before = cd.launches
    got = cd.conv3x3_dw(x, g, TH=th, TW=tw)
    torch.cuda.synchronize()
    assert cd.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (3, 3, ci, co)
    _dw_check(x, g, got)


@pytest.mark.parametrize("key", ["lvl1", "dec1_2", "lvl2", "dec2_2", "lvl3", "dec3_2", "btl"])
def test_conv_dw_at_every_script_width(cuda_device, key):
    """Every (Ci, Co) of proto_pallas_dw.SHAPES at a small image and batch
    (N = 4, 12x10: a ragged stage of 8 x 8 x 2 pixels in N, W and H), one to
    64 CTAs of 64 x 64 channels; run to run identical."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_pallas_dw import (
        SHAPES)

    _, ci, co, _, _, _ = SHAPES[key]
    gen = torch.Generator(device=cuda_device).manual_seed(ci + co)
    x = torch.randn((12, 10, 4, ci), generator=gen, device=cuda_device).to(torch.bfloat16)
    g = torch.randn((12, 10, 4, co), generator=gen, device=cuda_device).to(torch.bfloat16)
    got = cd.conv3x3_dw(x, g, TH=1, TW=1)
    _dw_check(x, g, got)
    assert torch.equal(got, cd.conv3x3_dw(x, g, TH=1, TW=1))


@pytest.mark.parametrize("shape", [(9, 13, 3, 128, 64), (7, 5, 3, 256, 128), (5, 9, 1, 64, 64),
                                   (40, 36, 24, 64, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_dw_bf16_ragged(cuda_device, shape):
    """N = 3 and N = 1 (most of a TMA box zero-filled), odd images, Ci != Co,
    and a shape split over many CTAs; run to run identical."""
    h, w, n, ci, co = shape
    gen = torch.Generator(device=cuda_device).manual_seed(h * w)
    x = torch.randn((h, w, n, ci), generator=gen, device=cuda_device).to(torch.bfloat16)
    g = torch.randn((h, w, n, co), generator=gen, device=cuda_device).to(torch.bfloat16)
    got = cd.conv3x3_dw(x, g, TH=1, TW=1)
    _dw_check(x, g, got)
    assert torch.equal(got, cd.conv3x3_dw(x, g, TH=1, TW=1))


def test_conv_dw_variants_and_runs_agree(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn((64, 64, 16, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    g = torch.randn((64, 64, 16, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    a = cd.conv3x3_dw(x, g, variant="taps9")
    b = cd.conv3x3_dw(x, g, TH=4, TW=16, variant="x3g3")
    assert torch.equal(a, b)


def test_conv_dw_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((8, 8, 2, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError, match="one dtype"):
        cd.conv3x3_dw(x, x.float())
    with pytest.raises(ValueError, match="multiples of 64"):
        cd.conv3x3_dw(x[..., :32].contiguous(), x)
    with pytest.raises(ValueError, match="TH"):
        cd.conv3x3_dw(x, x, TH=3)
    with pytest.raises(ValueError, match="contiguous"):
        cd.conv3x3_dw(x.transpose(0, 1), x.transpose(0, 1))


# --- transposed_cbr (K6, v1 and v2) ----------------------------------------------
# fused_conv_stats' function in the (H, C, W, N) layout: its tolerances, on
# the NHWC views of the same tensors.

_TC = {"v1": tc.transposed_fused_cbr, "v2": tc.transposed_fused_cbr_v2}


def _tc_run(version, inputs, prologue):
    x, a, b, w, bias = inputs
    return _TC[version](tc.from_nhwc(x).contiguous(), a, b, w, bias, rows=1, w_blk=1,
                        apply_prologue=prologue)


@pytest.mark.parametrize("prologue", [True, False], ids=["prologue", "no_prologue"])
@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("shape", [(8, 32, 32, 64, 64), (3, 16, 16, 64, 64),
                                   (16, 8, 24, 128, 256), (20, 5, 11, 64, 128),
                                   (32, 8, 8, 512, 256), (64, 8, 8, 64, 64),
                                   (100, 6, 6, 64, 64), (130, 4, 6, 64, 128),
                                   (104, 6, 6, 64, 64), (136, 4, 6, 64, 128),
                                   (16, 8, 8, 32, 64), (16, 8, 8, 96, 128),
                                   (16, 5, 11, 64, 64), (16, 1, 16, 64, 64),
                                   (16, 1, 5, 128, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_transposed_cbr_equals_plain_version(cuda_device, shape, version, prologue):
    """(3, ...): N % 8 != 0, the element-by-element copy; (20, 5, 11): ragged
    in every dimension of the tile; N = 64, 100 and 130 (the element path:
    N % 8 != 0), 104 (a partial 64-sample block) and 136 (a third block);
    Cin = 32 and 96 (a last chunk of 32 channels); W = 11 (a ragged column
    tile); H = 1 with one chunk and with two."""
    n, h, w, cin, cout = shape
    inputs = _cbr_inputs(cuda_device, n, h, w, cin, cout)
    assert tc.kernel_path(tc.from_nhwc(inputs[0])) == ("element" if n % 8 else "tma")
    before = (tc.launches_v1, tc.launches_v2)
    y, s = _tc_run(version, inputs, prologue)
    torch.cuda.synchronize()
    assert (tc.launches_v1, tc.launches_v2) == (before[0] + (version == "v1"),
                                                before[1] + (version == "v2"))
    assert y.dtype == torch.bfloat16 and y.shape == (h, cout, w, n) and s.shape == (2, cout)
    _check_y(tc.to_nhwc(y), inputs, prologue)
    _check_stats_own(tc.to_nhwc(y), s)
    yp, _ = tc.transposed_fused_cbr_reference(tc.from_nhwc(inputs[0]).contiguous(),
                                              *inputs[1:], apply_prologue=prologue)
    assert yp.shape == y.shape


@pytest.mark.parametrize("shape", [(128, 16, 16, 64, 64), (16, 8, 8, 96, 128), (3, 8, 8, 64, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_transposed_cbr_stats_equal_a_float64_sum_of_its_own_y(cuda_device, shape):
    """The stats of both designs against float64 sums of the kernel's own y:
    only the order of the float32 sums differs (1e-5 of [sum |y|, sum y^2])."""
    inputs = _cbr_inputs(cuda_device, *shape, seed=5)
    for version in ("v1", "v2"):
        y, s = _tc_run(version, inputs, True)
        yd = y.double()
        own = torch.stack([yd.sum((0, 2, 3)), (yd * yd).sum((0, 2, 3))])
        scale = torch.stack([yd.abs().sum((0, 2, 3)), (yd * yd).sum((0, 2, 3))])
        assert float(((s.double() - own).abs() / scale).max()) <= 1e-5


def test_transposed_cbr_v1_equals_v2_and_runs_agree(cuda_device):
    """The two designs add the same products in the same order."""
    inputs = _cbr_inputs(cuda_device, 16, 16, 16, 128, 128, seed=2)
    y1, s1 = _tc_run("v1", inputs, True)
    y2, s2 = _tc_run("v2", inputs, True)
    y3, s3 = _tc_run("v2", inputs, True)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    assert torch.equal(y2, y3) and torch.equal(s2, s3)


def test_transposed_cbr_halo_where_a_is_zero(cuda_device):
    """A channel with a = 0, b > 0 and a large shift elsewhere: the halo is
    zero after the affine in both designs (the JAX v2 leaks relu(b) there)."""
    inputs = list(_cbr_inputs(cuda_device, 8, 4, 5, 64, 64, seed=1, b_scale=3.0))
    inputs[1][5], inputs[2][5] = 0.0, 0.7
    y1, _ = _tc_run("v1", inputs, True)
    y2, _ = _tc_run("v2", inputs, True)
    _check_y(tc.to_nhwc(y2), inputs, True)
    assert torch.equal(y1, y2)


def test_transposed_cbr_rejects_what_it_does_not_take(cuda_device):
    x, a, b, w, bias = _cbr_inputs(cuda_device, 8, 8, 8, 64, 64)
    xt = tc.from_nhwc(x).contiguous()
    with pytest.raises(TypeError, match="bf16"):
        tc.transposed_fused_cbr(xt.float(), a, b, w, bias, w_blk=8)
    with pytest.raises(ValueError, match="w_blk"):
        tc.transposed_fused_cbr_v2(xt, a, b, w, bias, w_blk=16)
    with pytest.raises(ValueError, match="contiguous"):
        tc.transposed_fused_cbr(tc.from_nhwc(x), a, b, w, bias, w_blk=8)
    with pytest.raises(ValueError, match="is on"):
        tc.transposed_fused_cbr(xt, a.cpu(), b, w, bias, w_blk=8)


# --- transposed_bisect (K7-K9) ------------------------------------------------------
# Each script's own comparison (scripts/bisect_transposed*.py ``run``): on
# ones and on a seeded input, copies equal, sums and dots within one bf16
# ulp of |y| + 2^-16 max |y|, K9's stats within 1e-5 of the largest
# per-channel sum of |y| of a float64 sum of its own y; it raises at the
# first disagreement.


def _bisect_scripts():
    from selectivenet_for_semantic_segmentation_binary_torch.scripts import (
        bisect_transposed, bisect_transposed2, bisect_transposed3)

    # (script, its variants, the kernel's counter, launches per variant and
    # input: K9's run launches once for the stats and once for y)
    return {"K7": (bisect_transposed, tb.K7_VARIANTS, "launches_k7", 1),
            "K8": (bisect_transposed2, tb.K8_BODIES, "launches_k8", 1),
            "K9": (bisect_transposed3, tuple(tb.K9_CASES), "launches_k9", 2)}


@pytest.mark.parametrize("size", ["script", "64x64"])
@pytest.mark.parametrize("kernel", ["K7", "K8", "K9"])
def test_bisect_kernels_equal_plain_versions(cuda_device, kernel, size):
    script, names, counter, per_case = _bisect_scripts()[kernel]
    before = getattr(tb, counter)
    kw = {} if size == "script" else dict(n=32, h=64, w=64)
    results = script.run(device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert [r["name"] for r in results] == [f"{n}/{w}" for n in names
                                           for w in ("ones", "seeded")]
    assert getattr(tb, counter) == before + 2 * per_case * len(names)


def test_k9_at_c256(cuda_device):
    """K9's 14 cases at C = 256 (768-term dots): y within one bf16 ulp of the
    plain version, the stats within 1e-5 of the per-channel sum of |y| of a
    float64 sum of the kernel's own y (bisect_transposed3.hold_stats)."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts import bisect_transposed3

    results = bisect_transposed3.run(device=cuda_device, n=16, h=4, w=12, c=256)
    # every case but "statspad", whose (8, 128) layout holds at most 128 channels
    assert len(results) == 2 * (len(tb.K9_CASES) - 1)


def test_k9_at_n17(cuda_device):
    """K9's 14 cases at N = 17 (N % 8 != 0: the element path of the wgmma
    kernel, a ragged sample block, an odd W), held as the script holds
    them."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts import bisect_transposed3

    results = bisect_transposed3.run(device=cuda_device, n=17, h=4, w=5, c=64)
    assert len(results) == 2 * len(tb.K9_CASES)
    assert {r["path"] for r in results} == {"element"}


def test_bisect_kernels_are_deterministic(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    xp = torch.randn((18, 64, 34, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((3, 64, 192), generator=g, device=cuda_device).to(torch.bfloat16)
    a = tb.bisect_transposed3(xp, w, **tb.K9_CASES["all"])
    b = tb.bisect_transposed3(xp, w, **tb.K9_CASES["all"])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_bisect_kernels_reject_what_they_do_not_take(cuda_device):
    xp = torch.zeros((6, 8, 10, 4), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        tb.bisect_transposed("v1", xp.float())
    with pytest.raises(ValueError, match="contiguous"):
        tb.bisect_transposed("v4", xp.transpose(2, 3))
    with pytest.raises(ValueError, match="C % 8"):
        tb.bisect_transposed("v1", xp[:, :4].contiguous())
    with pytest.raises(ValueError, match="shape"):
        tb.bisect_transposed2("c", xp, torch.zeros((8, 16), dtype=torch.bfloat16,
                                                   device=cuda_device))


# The redesigned K7/K8 kernels case by case. (N, H, W, C): the scripts'
# size, 64x64, N = 3 (the element path), C = 72 (a ragged channel tile of the
# dots), W*N = 168 (a ragged column tile of the dots) and C = 256 (too wide
# for the dots' window design: their tile design).
K78_SHAPES = {"script": (tb.N, tb.H, tb.W, tb.C), "64x64": (32, 64, 64, 64),
              "n3": (3, 6, 20, 64), "c72": (16, 6, 20, 72), "ragged_p": (24, 5, 7, 64),
              "c256": (16, 4, 12, 256)}
K78_CASES = [f"K7:{v}" for v in tb.K7_VARIANTS] + [f"K8:{b}" for b in tb.K8_BODIES]
K78_DOTS = ("v3", "c", "d", "e")


def _k78_inputs(device, name, n, h, w, c, seed=11):
    g = torch.Generator(device=device).manual_seed(seed)
    ws = w + 8 if name == "v5" else w + 2
    xp = torch.randn((h + 2, c, ws, n), generator=g, device=device).to(torch.bfloat16)
    wm = torch.randn((c, 3 * c), generator=g, device=device).to(torch.bfloat16)
    return xp, wm


def _k78(case, xp, wm):
    """(the kernel's y, the plain version's y, the launch counter's name)."""
    kernel, name = case.split(":")
    if kernel == "K7":
        w = wm if name == "v3" else None
        return tb.bisect_transposed(name, xp, w), tb.k7_reference(name, xp, w), "launches_k7"
    return tb.bisect_transposed2(name, xp, wm), tb.k8_reference(name, xp, wm), "launches_k8"


@pytest.mark.parametrize("shape", list(K78_SHAPES))
@pytest.mark.parametrize("case", K78_CASES)
def test_k7_k8_kernels_equal_plain_versions(cuda_device, case, shape):
    """Crops and sums equal to the plain version, dots within the scripts'
    bar (one bf16 ulp of |y| + 2^-16 max |y|), dots the same twice, one
    launch a call, the 16-byte path exactly where N % 8 == 0."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.bisect_transposed import (
        hold)

    name = case.split(":")[1]
    n = K78_SHAPES[shape][0]
    xp, wm = _k78_inputs(cuda_device, name, *K78_SHAPES[shape])
    dot = name in K78_DOTS
    got, want, counter = _k78(case, xp, wm)
    before = getattr(tb, counter)
    again = _k78(case, xp, wm)[0]
    torch.cuda.synchronize()
    assert getattr(tb, counter) == before + 1
    assert tb.kernel_path(xp, wm if dot else None) == ("element" if n % 8 else "vector")
    if dot:
        hold(case, got, want, exact=False)
    else:
        assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("case", ["K7:v1", "K7:v3", "K8:a", "K8:b", "K8:d"])
def test_k7_k8_misaligned_input_takes_the_element_path(cuda_device, case):
    """An xp 2 bytes past a 16-byte boundary (N % 8 == 0): the element path
    of the same kernel, with the same results."""
    name = case.split(":")[1]
    xp, wm = _k78_inputs(cuda_device, name, 16, 4, 12, 64)
    buf = torch.empty(xp.numel() + 1, dtype=xp.dtype, device=cuda_device)
    shifted = buf[1:].view(xp.shape)
    shifted.copy_(xp)
    dot = name in K78_DOTS
    assert tb.kernel_path(shifted, wm if dot else None) == "element"
    assert tb.kernel_path(xp, wm if dot else None) == "vector"
    got, want, _ = _k78(case, shifted, wm)
    assert torch.equal(got, _k78(case, xp, wm)[0])
    if not dot:
        assert torch.equal(got, want)


# -- K10: the int8 implicit-GEMM conv ----------------------------------------

@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 3, 64), (2, 8, 8, 2, 64), (3, 9, 7, 32, 64),
                                   (2, 16, 16, 64, 128), (1, 5, 13, 128, 256),
                                   (2, 8, 8, 512, 512), (2, 8, 8, 96, 72)],
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_equals_plain_version(cuda_device, shape, x_dtype, dynamic):
    """Bit for bit: the int32 sums are exact and the epilogue's order is
    fixed. Cin 2 and 3 take the im2col kernel; 72 output channels a ragged
    tile of 64."""
    n, h, w, cin, cout = shape
    g = torch.Generator(device=cuda_device).manual_seed(cin * cout)
    x = torch.randn(n, h, w, cin, device=cuda_device, generator=g).to(x_dtype)
    wq = torch.randint(-127, 128, (cout, 3, 3, cin), device=cuda_device, generator=g,
                       dtype=torch.int8)
    a = torch.tensor(0.02, device=cuda_device)
    ks = torch.rand(cout, device=cuda_device, generator=g) * 1e-3 + 1e-4
    bias = None if dynamic else torch.randn(cout, device=cuda_device, generator=g) * 0.1
    out_dtype = torch.float32 if dynamic or x_dtype == torch.float32 else torch.bfloat16
    before = ic.launches
    got = ic.int8_conv(x, wq, a, ks, bias, out_dtype, dynamic)
    assert ic.launches == before + 1
    want = ic.int8_conv_reference(x, wq, a, ks, bias, out_dtype, dynamic)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_int8_ste_conv_on_the_card_equals_its_plain_version(cuda_device):
    """The QAT conv's forward on the card (K10's dynamic epilogue) against
    the same function on the CPU; its backward runs cuDNN's bf16 convs."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 16, 16, generator=g).to(memory_format=torch.channels_last)
    k = torch.randn(128, 64, 3, 3, generator=g) * 0.05
    want = ic.qat_conv_forward(x, k)
    xc = x.to(cuda_device).requires_grad_()
    kc = k.to(cuda_device).requires_grad_()
    got = ic.Int8STEConv.apply(xc, kc)
    assert torch.equal(got.cpu(), want)
    got.sum().backward()
    assert torch.isfinite(xc.grad).all() and torch.isfinite(kc.grad).all()


def _k10_case(device, shape, x_dtype, dynamic, seed=0):
    n, h, w, cin, cout = shape
    g = torch.Generator(device=device).manual_seed(seed + cin * cout)
    x = torch.randn(n, h, w, cin, device=device, generator=g).to(x_dtype)
    wq = torch.randint(-127, 128, (cout, 3, 3, cin), device=device, generator=g,
                       dtype=torch.int8)
    a = torch.tensor(0.02, device=device)
    ks = torch.rand(cout, device=device, generator=g) * 1e-3 + 1e-4
    bias = None if dynamic else torch.randn(cout, device=device, generator=g) * 0.1
    out_dtype = torch.float32 if dynamic or x_dtype == torch.float32 else torch.bfloat16
    return x, wq, a, ks, bias, out_dtype, dynamic


# the wgmma kernel's tiling: W 32 (a tile of 256 or 512 positions spans
# several rows; H (W + 2) not a multiple of the tile), W 53 and H 38 (the
# verify image's deepest level), W 7, W 300 (a row longer than a raw box of
# 256 pixels), N = 1, Cout 64 (cw 1: two 256-position halves), 72 (a
# ragged channel tile), 128 and 512 (cw 2), Cin 32 (one chunk), 96 (three:
# the weights streamed), 512 (sixteen)
K10_TILING_SHAPES = [(2, 32, 32, 32, 64), (1, 38, 53, 128, 128), (3, 11, 7, 96, 72),
                     (1, 13, 32, 512, 512), (2, 9, 53, 64, 64), (1, 5, 300, 32, 128),
                     (1, 3, 17, 512, 64), (4, 2, 2, 96, 128)]


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", K10_TILING_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_wgmma_tiling_equals_plain_version(cuda_device, shape, x_dtype, dynamic):
    """Every edge of the wgmma kernel's tiling, bit for bit."""
    args = _k10_case(cuda_device, shape, x_dtype, dynamic)
    assert ic.kernel_path(*shape, x_dtype) == "wgmma"
    before = ic.launches
    got = ic.int8_conv(*args)
    assert ic.launches == before + 1
    want = ic.int8_conv_reference(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, 3, 800, 64, 64), (1, 2, 600, 32, 128), (2, 5, 9, 48, 64),
                                   (1, 4, 6, 4, 8)], ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_other_shapes_take_the_mma_sync_kernel(cuda_device, shape):
    """A window too wide for the shared memory, or 3 < Cin, Cin % 32 != 0:
    the mma.sync kernel, by shape."""
    args = _k10_case(cuda_device, shape, torch.bfloat16, False)
    assert ic.kernel_path(*shape) == "mma_sync"
    assert torch.equal(ic.int8_conv(*args), ic.int8_conv_reference(*args))


# the im2col kernel (Cin <= 3): the RGB first layer at batch 2, W 7, 53 and
# 300 (rows longer than a warpgroup's 256 positions), N = 1, Cout 8, 72 and
# 128 (ragged and several 64-channel tiles), Cin 1, 2 and 3
K10_IM2COL_SHAPES = [(2, 64, 64, 3, 64), (3, 11, 7, 3, 72), (1, 38, 53, 2, 64),
                     (1, 5, 300, 1, 128), (2, 9, 13, 2, 8), (1, 1, 1, 3, 64)]


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", K10_IM2COL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_im2col_equals_plain_version(cuda_device, shape, x_dtype, dynamic):
    args = _k10_case(cuda_device, shape, x_dtype, dynamic)
    assert ic.kernel_path(*shape, x_dtype) == "wgmma_im2col"
    before = ic.launches
    got = ic.int8_conv(*args)
    assert ic.launches == before + 1
    want = ic.int8_conv_reference(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_int8_conv_path_in_the_source_equals_kernel_path(cuda_device):
    """The source's int8_conv_path and the wrapper's kernel_path are one rule."""
    lib = ic._kernel()
    names = {0: "mma_sync", 1: "wgmma", 2: "wgmma_im2col"}
    shapes = [(128, s, s, ci, co) for _, ci, co, s in INT8_LAYERS]
    shapes += [(1, 4, w, 64, co) for co in (64, 128) for w in (584, 585, 586, 745, 746)]
    shapes += [(2, 8, 8, ci, 72) for ci in (1, 2, 3, 4, 32, 48, 96)]
    for shape in shapes:
        for x_dtype in (torch.bfloat16, torch.float32):
            in_source = lib.int8_conv_path(*shape, int(x_dtype == torch.bfloat16))
            assert names[in_source] == ic.kernel_path(*shape, x_dtype), shape


@pytest.mark.parametrize("which", ["x", "w_q"])
def test_int8_conv_rejects_a_view_not_16_byte_aligned(cuda_device, which):
    """The tensor maps need 16-byte aligned bases: a view 2 bytes (x) or 1
    byte (w_q) past a boundary raises before any launch."""
    x, wq, a, ks, bias, out_dtype, dynamic = _k10_case(cuda_device, (1, 4, 4, 64, 64),
                                                       torch.bfloat16, False)
    src = x if which == "x" else wq
    buf = torch.empty(src.numel() + 16, dtype=src.dtype, device=cuda_device)
    view = buf[1:1 + src.numel()].view(src.shape)
    view.copy_(src)
    if which == "x":
        x = view
    else:
        wq = view
    before = ic.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ic.int8_conv(x, wq, a, ks, bias, out_dtype, dynamic)
    assert ic.launches == before
