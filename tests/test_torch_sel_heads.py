"""The heads' kernel pair (K11, ``ops/sel_heads.py``, ``kernels/sel_heads.cu``).

On the CPU: the plain version against the model's separate ``Head`` convs
(forward and autograd), the dispatch rule and the wrapper's refusals, and
the models' CPU ``_heads`` unchanged bit for bit. On a card (skipped
without one; the kernels have no CPU mode): the kernels against the plain
version at the train shape and at ragged pixel counts, a deterministic
backward, the launch counters, and a train step against the ``Head``
convs'. The file imports no JAX, so it runs on the card's machine without
the suite's conftest:

    python -m pytest --noconftest tests/test_torch_sel_heads.py -q
"""

import copy

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch.models import (Head, build_model,
                                                                       init_weights)
from selectivenet_for_semantic_segmentation_binary_torch.ops import sel_heads as sh

CIN = 64
# the heads' widths of UNet_B (K = 1), selective UNet_B (K = 3) and selective
# UNet with n_cls 2 (K = 6)
WIDTHS = {1: (1,), 3: (1, 1, 1), 6: (2, 2, 2)}
DTYPES = {"bf16": torch.bfloat16, "float32": torch.float32}
# bf16 outputs: both sides round a float32 sum of the same 64 products once,
# in another order, so they differ by at most one bf16 ulp (2^-8 of the
# value's binade, under 2^-7 of the value)
BF16_ULP = 2.0 ** -7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run this file or chip_smoke.py on the card)")
    return torch.device("cuda", 0)


def _heads(widths, seed=0, device="cpu", cin=CIN):
    g = torch.Generator().manual_seed(seed)
    heads = []
    for kj in widths:
        h = Head(cin, kj)
        with torch.no_grad():
            h.weight.copy_(torch.randn(h.weight.shape, generator=g) * 0.125)
            h.bias.copy_(torch.randn(h.bias.shape, generator=g) * 0.5)
        heads.append(h.to(device))
    return heads


def _feat(shape, dtype, seed=1, device="cpu", cin=CIN):
    n, h, w = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.maximum(rng.standard_normal((n, cin, h, w)), 0).astype(np.float32))
    return x.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)


def _grads(feat, widths, seed=2):
    rng = np.random.default_rng(seed)
    n, _, h, w = feat.shape
    return [torch.from_numpy(rng.standard_normal((n, h, w, kj)).astype(np.float32)).to(
        feat.device) for kj in widths]


def _run(fn, feat, heads, grads):
    """fn's logits and the gradients of sum(logits * grads): dfeat, then
    each head's dW and db."""
    x = feat.detach().requires_grad_(True)
    for h in heads:
        h.zero_grad(set_to_none=True)
    outs = fn(x, heads)
    torch.autograd.backward(outs, grads)
    return ([o.detach() for o in outs], x.grad,
            [t.grad for h in heads for t in (h.weight, h.bias)])


def _head_convs(x, heads):
    """Today's CPU path: each ``Head``'s own conv, (N, H, W, k_j) float32."""
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=x.dtype == torch.bfloat16):
        return [h(x).permute(0, 2, 3, 1).float() for h in heads]


def _plain(x, heads):
    return sh.sel_heads_reference(x, [h.weight for h in heads], [h.bias for h in heads],
                                  x.dtype)


def _max_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# -- CPU ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("k", sorted(WIDTHS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 5, 7), (3, 9, 11)], ids=["70px", "297px"])
def test_plain_version_matches_the_head_convs(shape, dtype, k):
    """The plain version computes what the model's separate ``Head`` convs
    compute (autocast's bf16 on the CPU, or float32): forward within an ulp
    of the output's dtype; the gradients within what the ``Head`` path's own
    bf16 roundings of g and of dW and dfeat (three bf16 sums) leave, 2^-6 of
    the largest, or float32 round-off."""
    widths = WIDTHS[k]
    feat = _feat(shape, DTYPES[dtype])
    heads = _heads(widths)
    grads = _grads(feat, widths)
    got_o, got_dx, got_dp = _run(_plain, feat, heads, grads)
    want_o, want_dx, want_dp = _run(_head_convs, feat, heads, grads)
    fwd_tol, grad_tol = (BF16_ULP, 2.0 ** -6) if dtype == "bf16" else (1e-6, 1e-5)
    for g, w in zip(got_o, want_o):
        assert g.shape == w.shape and g.dtype == torch.float32 and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=fwd_tol, atol=1e-6)
    assert got_dx.dtype == feat.dtype
    assert _max_rel(got_dx, want_dx) <= grad_tol
    for g, w in zip(got_dp, want_dp):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _max_rel(g, w) <= grad_tol


@pytest.mark.parametrize("cin,k,dtype,takes", [
    (64, 3, torch.bfloat16, True), (64, 1, torch.bfloat16, True), (64, 8, torch.bfloat16, True),
    (64, 6, torch.float32, True), (8, 3, torch.bfloat16, True), (256, 3, torch.bfloat16, True),
    (128, 3, torch.float32, True), (256, 3, torch.float32, False), (512, 3, torch.bfloat16, False),
    (24, 3, torch.bfloat16, False), (60, 3, torch.bfloat16, False), (64, 9, torch.bfloat16, False),
    (64, 0, torch.bfloat16, False), (64, 3, torch.float16, False), (64, 3, torch.float64, False),
])
def test_dispatch_rule(cin, k, dtype, takes):
    assert sh.kernel_takes(cin, k, dtype) is takes


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 4, 4, CIN, dtype=torch.bfloat16)
    sh.check_kernel_inputs(x, (1, 1, 1))  # takes it
    for bad, widths, what in [
            (x.half(), (1, 1, 1), "does not take"),
            (x, (4, 4, 1), "does not take"),
            (x[..., :24].contiguous(), (1,), "does not take"),
            (x.permute(0, 2, 1, 3), (1,), "contiguous"),
            (x[:0], (1,), "empty"),
            (x[0], (1,), r"\(N, H, W, Cin\)"),
            (torch.zeros(2 * 4 * 4 * CIN + 1, dtype=torch.bfloat16)[1:].view(2, 4, 4, CIN), (1,),
             "aligned")]:
        with pytest.raises(ValueError, match=what):
            sh.check_kernel_inputs(bad, widths)
    heads = _heads((1,))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sh.sel_heads(_feat((1, 2, 2), torch.bfloat16), heads)
    assert not sh.runs_kernel(_feat((1, 2, 2), torch.bfloat16), heads)


def test_compute_dtype_is_autocasts_or_feats():
    x = torch.zeros(1, CIN, 2, 2)
    assert sh.compute_dtype(x) == torch.float32
    assert sh.compute_dtype(x.bfloat16()) == torch.bfloat16
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert sh.compute_dtype(x) == torch.bfloat16
        assert sh.compute_dtype(x.double()) == torch.float64


@pytest.mark.parametrize("arch,selective", [("UNet_B", True), ("UNet_B", False),
                                            ("UNet", True), ("UNet", False)])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_cpu_heads_unchanged_bit_for_bit(arch, selective, compute_dtype):
    """On the CPU ``_heads`` runs each ``Head``'s own conv, as before K11,
    and the kernel counters and the bypass counter do not move."""
    model = build_model(arch, selective=selective, compute_dtype=compute_dtype)
    init_weights(model, torch.Generator().manual_seed(3))
    feat = _feat((2, 6, 10), torch.float32)
    names = ("conv1x1", "conv_select", "conv_aux") if selective else ("conv1x1",)
    before = (sh.launches_fwd, sh.launches_bwd, sh.bypasses)
    with model._autocast("cpu"):
        got = model._heads(feat)
        raw = [getattr(model, n)(feat) for n in names]
    want = [r.squeeze(1).float() if arch == "UNet_B" else r.permute(0, 2, 3, 1).float()
            for r in raw]
    got = list(got) if selective else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.stride() == w.stride()
        assert torch.equal(g, w)
    assert (sh.launches_fwd, sh.launches_bwd, sh.bypasses) == before


@pytest.mark.parametrize("n_cls", [4, 5])
def test_wide_cpu_heads_run_the_head_convs(n_cls):
    """Selective UNet's heads of more than 8 channels together (n_cls + 2 +
    n_cls), which the kernels do not take: ``apply_heads`` gives each
    ``Head``'s own conv, on the CPU without counting a bypass."""
    model = build_model("UNet", n_cls=n_cls, selective=True)
    init_weights(model, torch.Generator().manual_seed(4))
    heads = (model.conv1x1, model.conv_select, model.conv_aux)
    assert not sh.kernel_takes(CIN, sum(h.out_channels for h in heads), torch.float32)
    feat = _feat((2, 3, 5), torch.float32)
    before = (sh.launches_fwd, sh.launches_bwd, sh.bypasses)
    got = sh.apply_heads(feat, heads)
    for g, h in zip(got, heads):
        assert torch.equal(g, h(feat).permute(0, 2, 3, 1).float())
    assert (sh.launches_fwd, sh.launches_bwd, sh.bypasses) == before


# -- on a card ----------------------------------------------------------------------------------

def _abs_bound(feat, heads, grads):
    """Per dW element and db: the sum of |x g| and |g|, the scale of float32
    round-off in a sum over the pixels in any order."""
    cin = feat.shape[1]
    x = feat.detach().float().permute(0, 2, 3, 1).reshape(-1, cin).abs()
    out = []
    for g in grads:
        ga = g.reshape(-1, g.shape[-1]).abs()
        out += [(ga.t() @ x).reshape(-1, cin, 1, 1), ga.sum(0)]
    return out


# the K = 8 of selective UNet with n_cls 3 (3 + 2 + 3), and Cin at both ends
# of the rule: one 16-byte piece a pixel (8 bf16, 8 float32 in two pieces)
# and 32 (256 bf16, 128 float32)
@pytest.mark.parametrize("k,cin,dtype,shape", [
    *[(k, CIN, dtype, shape) for k in sorted(WIDTHS) for dtype in sorted(DTYPES)
      for shape in [(128, 256, 256), (3, 33, 47)]],
    (8, CIN, "bf16", (3, 33, 47)), (8, CIN, "float32", (3, 33, 47)),
    (3, 8, "bf16", (3, 33, 47)), (3, 256, "bf16", (3, 33, 47)),
    (3, 8, "float32", (3, 33, 47)), (3, 128, "float32", (3, 33, 47))])
def test_kernel_matches_plain_version(cuda_device, shape, dtype, cin, k):
    """Logits and dfeat within an ulp of their dtype (one rounding of a float32
    sum in another order; float32: 1e-5 of the largest); dW and db within
    1e-5 of the sum of |terms| (float32 sums over the pixels in another
    order)."""
    widths = WIDTHS.get(k, (3, 2, 3))
    feat = _feat(shape, DTYPES[dtype], device=cuda_device, cin=cin)
    heads = _heads(widths, device=cuda_device, cin=cin)
    grads = _grads(feat, widths)
    f0, b0 = sh.launches_fwd, sh.launches_bwd
    got_o, got_dx, got_dp = _run(sh.sel_heads, feat, heads, grads)
    torch.cuda.synchronize()
    assert (sh.launches_fwd, sh.launches_bwd) == (f0 + 1, b0 + 1)
    want_o, want_dx, want_dp = _run(_plain, feat, heads, grads)
    rtol = BF16_ULP if dtype == "bf16" else 1e-6
    for g, w in zip(got_o, want_o):
        assert g.shape == w.shape and g.dtype == torch.float32 and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=rtol, atol=1e-5 * float(w.abs().max()))
    assert got_dx.dtype == feat.dtype and got_dx.shape == feat.shape
    assert got_dx.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got_dx.float(), want_dx.float(), rtol=rtol,
                               atol=1e-5 * float(want_dx.float().abs().max()))
    for g, w, s in zip(got_dp, want_dp, _abs_bound(feat, heads, grads)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(((g - w).abs() <= 1e-5 * s + 1e-6).all())
    del feat, got_dx, want_dx
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_is_deterministic(cuda_device, dtype):
    """Fixed-order partial sums, no atomics: two runs, the same bits."""
    feat = _feat((16, 96, 80), DTYPES[dtype], device=cuda_device)
    heads = _heads(WIDTHS[3], device=cuda_device)
    grads = _grads(feat, WIDTHS[3])
    first = _run(sh.sel_heads, feat, heads, grads)
    second = _run(sh.sel_heads, feat, heads, grads)
    assert torch.equal(first[1], second[1])
    for a, b in zip(first[2] + first[0], second[2] + second[0]):
        assert torch.equal(a, b)


def _train_setup(device, compute_dtype="float32", batch=4, side=64):
    from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import InMemoryPatches

    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", batch_size=batch,
                      patch_size=side, compute_dtype=compute_dtype, drop_last=True, seed=0)
    loader = PatchLoader(InMemoryPatches(batch, side, 0), batch, num_workers=1, device=device,
                         shuffle=False, drop_last=True, seed=0, random_flip=True)
    model = build_model("UNet_B", selective=True, compute_dtype=compute_dtype)
    init_weights(model, torch.Generator().manual_seed(0))
    return cfg, next(iter(loader)), model.to(device)


def _one_step(model, cfg, batch):
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_train_step

    step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    metrics = step(batch, cfg.lr)
    return float(metrics["loss"]), {n: p.grad.detach().clone()
                                    for n, p in model.named_parameters()}


def test_train_step_matches_the_head_convs(cuda_device, monkeypatch):
    """One classic float32 train step with the kernels against the same step
    with each ``Head``'s own conv (the path before K11), TF32 off: the same
    float32 arithmetic but for the order of the heads' sums, so the loss and
    every gradient agree within tests/test_torch_train.py's float32
    tolerances (FWD_TOL, GRAD_TOL: set there for sum-order differences
    against JAX). The counters read 1 forward and 1 backward a step."""
    cfg, batch, model = _train_setup(cuda_device)
    parent = copy.deepcopy(model)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        f0, b0, y0 = sh.launches_fwd, sh.launches_bwd, sh.bypasses
        loss, grads = _one_step(model, cfg, batch)
        assert (sh.launches_fwd - f0, sh.launches_bwd - b0, sh.bypasses - y0) == (1, 1, 0)
        monkeypatch.setattr(sh, "runs_kernel", lambda feat, heads: False)
        want_loss, want_grads = _one_step(parent, cfg, batch)
        assert (sh.launches_fwd - f0, sh.launches_bwd - b0, sh.bypasses - y0) == (1, 1, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(loss, want_loss, rtol=5e-4, atol=5e-4)
    for name, g in grads.items():
        torch.testing.assert_close(g, want_grads[name], rtol=3e-3, atol=1e-3, msg=name)


def test_bf16_step_and_inference_launches(cuda_device):
    """A bf16 (autocast) train step takes the kernels once each way; an
    inference forward once forward; the logits are finite."""
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import device_preprocess

    cfg, batch, model = _train_setup(cuda_device, "bfloat16")
    f0, b0 = sh.launches_fwd, sh.launches_bwd
    loss, grads = _one_step(model, cfg, batch)
    assert (sh.launches_fwd - f0, sh.launches_bwd - b0) == (1, 1)
    assert np.isfinite(loss) and all(bool(g.isfinite().all()) for g in grads.values())
    model.eval()
    with torch.inference_mode():
        outs = model(device_preprocess(batch)[0])
    assert (sh.launches_fwd - f0, sh.launches_bwd - b0) == (2, 1)
    assert all(bool(o.isfinite().all()) and o.dtype == torch.float32 for o in outs)


def test_wide_heads_on_a_card_run_the_head_convs_counted(cuda_device):
    """Selective UNet with n_cls 4 (K = 10 > 8) on a card: each ``Head``'s
    own conv, one bypass counted, no kernel launch."""
    model = build_model("UNet", n_cls=4, selective=True, compute_dtype="bfloat16")
    init_weights(model, torch.Generator().manual_seed(4))
    model.to(cuda_device)
    feat = _feat((2, 16, 24), torch.float32, device=cuda_device)
    before = (sh.launches_fwd, sh.launches_bwd, sh.bypasses)
    with model._autocast("cuda"):
        got = model._heads(feat)
        want = [h(feat).permute(0, 2, 3, 1).float()
                for h in (model.conv1x1, model.conv_select, model.conv_aux)]
    assert (sh.launches_fwd, sh.launches_bwd, sh.bypasses) == (before[0], before[1],
                                                                before[2] + 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
