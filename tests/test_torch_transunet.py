"""TransUNet (R50-ViT-B/16 hybrid, ``models/transunet.py``) against its plain
float32 reference (``benchmark/reference/transunet.py``, the benchmark's own)
on seeded random weights, on the CPU at a small size: width 32, hidden 64,
2 heads, 2 layers, units (1, 1, 1), 32x32 inputs, the decoder
(64, 32, 16, 16).

* the float32 forward planes and every leaf's gradient; one
  ``make_train_step`` step's loss terms, counts and BatchNorm running
  statistics; the block-1 skip zero-padded at an odd pooled size; weight
  standardisation; the published dropout sites with their masks from one
  generator; a bf16-autocast forward;
* ``build_model``'s refusals and the rows split's, the parameter count at the
  published widths (on the ``meta`` device), the three spans inside
  ``step.forward``, the attention counters;
* ``--model_arch TransUNet`` through ``config.py``, ``snet-train`` and
  ``snet-predict`` (unfolded by default), and the ``Predictor``.
"""

import contextlib
import importlib.util
import io
import os
import statistics

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch import cli, eval_lib, train_lib
from selectivenet_for_semantic_segmentation_binary_torch.config import (EvalConfig, TrainConfig,
                                                                        parse_train_args)
from selectivenet_for_semantic_segmentation_binary_torch.models import (build_model,
                                                                        load_weights,
                                                                        transunet)
from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
from selectivenet_for_semantic_segmentation_binary_torch.tools import predict, serve
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
    write_synthetic_patch_tree)
from selectivenet_for_semantic_segmentation_binary_torch.utils import tracing


def _reference():
    """The plain reference, loaded from its one file beside the benchmark."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "reference", "transunet.py")
    spec = importlib.util.spec_from_file_location("transunet_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference()
SMALL = {"width": 32, "units": (1, 1, 1), "hidden": 64, "layers": 2, "heads": 2,
         "mlp_dim": 256, "head_channels": 64, "decoder": (64, 32, 16, 16)}
SIDE = 32
# float32 on both sides: the two differ by the order of their roundings
# (GroupNorm, LayerNorm, softmax and the upsampling written out in the
# reference) through ~20 layers; measured ~3e-6 of a plane's largest value
# and ~7e-5 of a leaf's gradient norm, so over 10x that
FWD_TOL = 1e-4
GRAD_TOL = 1e-3


def seeded_weights(seed: int) -> dict:
    """Every leaf of the small model, seeded: conv and linear tensors
    U(+-1/sqrt(fan_in)); norm scales 1 + U(+-0.1), shifts and the position
    embedding U(+-0.1); running mean U(+-0.1), running variance 1 + U(+-0.1)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, role, fan in ref.leaves(SMALL, SIDE):
        u = torch.rand(shape, generator=g) * 2 - 1
        out[name] = {"weight": u / fan ** 0.5 if fan else u, "bias": u / max(fan, 1) ** 0.5,
                     "bn_weight": 1 + 0.1 * u, "bn_bias": 0.1 * u, "running_mean": 0.1 * u,
                     "running_var": 1 + 0.1 * u}[role]
    return out


def images(seed: int, n: int = 4):
    """(n, 32, 32, 3) uint8 images with lesion blobs and their {0, 1} labels."""
    rng = np.random.default_rng(seed)
    field = np.kron(rng.standard_normal((n, 4, 4)), np.ones((8, 8)))
    label = (field > 0.3).astype(np.uint8)
    img = np.where(label[..., None] == 1, [158, 92, 148], [222, 192, 205])
    img = img + rng.integers(-24, 25, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), label


def port(weights=None, dtype: str = "float32", **kw):
    model = build_model("TransUNet", selective=True, compute_dtype=dtype, img_size=SIDE,
                        dims=SMALL, **kw)
    return load_weights(model, weights if weights is not None else seeded_weights(0))


def x_of(x8: np.ndarray) -> torch.Tensor:
    return ref.normalize(torch.from_numpy(x8))


@pytest.fixture
def small_published(monkeypatch):
    """``build_model("TransUNet")`` at the small size, for the entry points
    that build the model themselves."""
    monkeypatch.setattr(transunet, "PUBLISHED", {**transunet.PUBLISHED, **SMALL})


def test_forward_and_every_gradient_match_the_reference():
    w = seeded_weights(1)
    x8, y8 = images(2)
    model = port(w).train()
    cfg = TrainConfig(model_arch="TransUNet", selective=True, loss="BCElogit", s_lamb=2.0)
    outs = model(x_of(x8).contiguous(memory_format=torch.channels_last))
    train_lib._losses(cfg, outs, torch.from_numpy(y8).float())[0].backward()
    p = {k: v.clone().requires_grad_(ref.trainable(k)) for k, v in w.items()}
    want = ref.forward(p, x_of(x8), True, dims=SMALL)
    for got, plane in zip(outs, want):
        assert got.dtype == torch.float32 and got.shape == (4, SIDE, SIDE)
        assert float((got.detach() - plane).abs().max()) < FWD_TOL * float(plane.abs().max())
    total = ref.selective_loss(*want, torch.from_numpy(y8), 2.0, 0.8)[0]
    names = [k for k in p if ref.trainable(k)]
    grads = dict(zip(names, torch.autograd.grad(total, [p[k] for k in names])))
    median = statistics.median(float(g.norm()) for g in grads.values())
    params = dict(model.named_parameters())
    assert set(params) == set(grads)
    for name, g in grads.items():
        gap = float((params[name].grad - g).norm()) / max(float(g.norm()), median)
        assert gap < GRAD_TOL, (name, gap)


def test_one_train_step_matches_the_reference():
    w = seeded_weights(3)
    x8, y8 = images(4)
    cfg = TrainConfig(model_arch="TransUNet", selective=True, loss="BCElogit", s_lamb=2.0,
                      batch_size=4, patch_size=SIDE, compute_dtype="float32")
    model = port(w)
    step = train_lib.make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    m = step({"input": torch.from_numpy(x8), "label": torch.from_numpy(y8)}, 1e-3)
    trainer = ref.Trainer(w, 1e-3, 2.0, 0.8, dims=SMALL)
    res = trainer.step(x_of(x8), torch.from_numpy(y8))
    for k in ("loss", "aux_loss", "sel_loss", "coverage"):
        # float32 sums over 4 x 32 x 32 pixels: agree to ~1e-7
        assert float(m[k]) == pytest.approx(res[k], rel=1e-5)
    assert [int(v) for v in m["cm"].reshape(-1)] == res["cm"]
    assert int(m["n_reject"]) == res["n_reject"]
    buffers = {n: b for n, b in model.named_buffers() if n.endswith(("_mean", "_var"))}
    assert len(buffers) == 18
    for name, b in buffers.items():
        # the batch statistics of conv outputs that agree to ~1e-5
        torch.testing.assert_close(b, trainer.p[name], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("side,pooled", [(32, 7), (48, 11)])
def test_block1_skip_is_zero_padded_at_an_odd_pooled_size(side, pooled):
    resnet = build_model("TransUNet", img_size=side, dims=SMALL).transformer.embeddings \
        .hybrid_model
    seen = []
    resnet.body.block1.register_forward_hook(lambda mod, args, out: seen.append(out))
    x = torch.randn(2, 3, side, side)
    with torch.no_grad():
        out, skips = resnet(x)
    block1 = seen[0]
    assert block1.shape[-1] == pooled and skips[1].shape[-1] == pooled + 1 == side // 4
    assert torch.equal(skips[1][..., :pooled, :pooled], block1)
    assert not skips[1][..., pooled, :].any() and not skips[1][..., :, pooled].any()
    assert skips[0].shape[-1] == side // 8 and skips[2].shape[-1] == side // 2
    assert out.shape[-1] == side // 16


def test_weight_standardisation():
    conv = transunet.StdConv2d(8, 4, kernel_size=3, padding=1, bias=False)
    x = torch.randn(2, 8, 6, 6)
    w = conv.weight.detach().clone()
    mean = w.mean((1, 2, 3), keepdim=True)
    std = ((w - mean) ** 2).mean((1, 2, 3), keepdim=True).add(1e-5).sqrt()
    want = torch.nn.functional.conv2d(x, (w - mean) / std, padding=1)
    with torch.no_grad():
        torch.testing.assert_close(conv(x), want, rtol=1e-5, atol=1e-5)
        # the output cannot see a weight's scale or offset, but for eps: 1e-5
        # against a variance of ~5e-3 (U(+-1/sqrt(72))) moves it by ~1e-3
        conv.weight.mul_(3.0).add_(0.5)
        torch.testing.assert_close(conv(x), want, rtol=3e-3, atol=3e-3)
    torch.testing.assert_close(ref.standardize(w), (w - mean) / std, rtol=1e-6, atol=1e-6)


def test_published_dropout_draws_its_masks_from_one_generator():
    w = seeded_weights(5)
    x8, _ = images(6)
    model = port(w, dropout_rate=0.1).train()
    for m in model.modules():  # the BN statistics the train mode moves stay out of it
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 0.0
    with torch.no_grad():
        got = model(x_of(x8), generator=torch.Generator().manual_seed(11))
        again = model(x_of(x8), generator=torch.Generator().manual_seed(12))
        want = ref.forward(w, x_of(x8), True, dims=SMALL, gen=torch.Generator().manual_seed(11),
                           dropout_rate=0.1)
        plain = ref.forward(w, x_of(x8), True, dims=SMALL)
    for a, b, c, d in zip(got, want, again, plain):
        assert float((a - b).abs().max()) < FWD_TOL * float(b.abs().max())
        assert float((a - c).abs().max()) > 1e-3 and float((b - d).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="generator"):
        model(x_of(x8))
    model.eval()  # eval mode: the sites are off, no generator needed
    with torch.no_grad():
        model(x_of(x8))


def test_a_bf16_autocast_forward():
    w = seeded_weights(7)
    x8, _ = images(8)
    with torch.no_grad():
        got = port(w, "bfloat16").train()(x_of(x8))
        want = ref.forward(w, x_of(x8), True, dims=SMALL)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        # bf16 operands (8 bits of mantissa) through ~20 layers: 2e-2 to 4e-2
        # of the largest logit on three seeds; the reference with float8 e4m3
        # operands reads 0.25 to 0.49, so 0.1 tells the two apart
        assert float((a - b).abs().max()) < 0.1 * float(b.abs().max())


@pytest.mark.parametrize("kw", [{"fused": True}, {"folded": True},
                                {"quantize": "int8", "folded": True},
                                {"quant_calibrate": True, "folded": True},
                                {"train_quant": "int8"}, {"bn_mode": "per_replica"}],
                         ids=["fused", "folded", "int8", "calibrate", "qat", "per_replica"])
def test_build_model_refuses_the_unet_trunk_variants(kw):
    with pytest.raises(ValueError, match="not implemented for TransUNet"):
        build_model("TransUNet", selective=True, img_size=SIDE, dims=SMALL, **kw)


def test_the_rows_split_is_refused():
    with pytest.raises(ValueError, match="--sp_ways 2 is not implemented for TransUNet"):
        train_lib.check_supported(TrainConfig(model_arch="TransUNet", sp_ways=2))
    with pytest.raises(ValueError, match="--sp_ways 2 is not implemented for TransUNet"):
        eval_lib.check_supported(EvalConfig(model_arch=["TransUNet"], sp_ways=2))
    train_lib.check_supported(TrainConfig(model_arch="UNet_B", sp_ways=2))


def test_the_published_widths_have_105321907_parameters():
    with torch.device("meta"):
        model = build_model("TransUNet", selective=True, compute_dtype="bfloat16")
    assert sum(p.numel() for p in model.parameters()) == 105_321_907
    assert model.transformer.embeddings.position_embeddings.shape == (1, 256, 768)
    assert len(model.transformer.encoder.layer) == 12
    assert [len(b) for b in model.transformer.embeddings.hybrid_model.body] == [3, 4, 9]


def test_the_forward_spans_lie_inside_step_forward():
    x8, y8 = images(9)
    cfg = TrainConfig(model_arch="TransUNet", selective=True, loss="BCElogit", batch_size=4,
                      patch_size=SIDE, compute_dtype="float32")
    model = port()
    step = train_lib.make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    tracing.take()
    tracing.enable()
    try:
        step({"input": torch.from_numpy(x8), "label": torch.from_numpy(y8)}, 1e-3)
    finally:
        tracing.disable()
    spans = tracing.take()
    fwd = [s for s in spans if s.name == "step.forward"]
    mine = [s for s in spans if s.name.startswith("transunet.")]
    assert len(fwd) == 1
    assert [s.name for s in mine] == ["transunet.encoder", "transunet.transformer",
                                      "transunet.decoder"]
    for s in mine:
        assert s.parent == fwd[0].id and fwd[0].start_ns <= s.start_ns <= s.end_ns <= \
            fwd[0].end_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(mine, mine[1:]))


def test_the_attention_counters():
    model = port().eval()
    calls, tokens = transunet.attention_calls, transunet.attention_tokens
    with torch.no_grad():
        model(torch.zeros(3, 3, SIDE, SIDE))
    assert transunet.attention_calls - calls == SMALL["layers"]
    assert transunet.attention_tokens - tokens == SMALL["layers"] * 3 * (SIDE // 16) ** 2


def test_model_arch_transunet_through_the_config_and_the_tools(small_published, tmp_path):
    assert parse_train_args(["--model_arch", "TransUNet"]).model_arch == "TransUNet"
    for tool in (predict, serve):
        choices = {a.dest: a.choices for a in tool.build_parser()._actions}["model_arch"]
        assert "TransUNet" in choices
    data_dir, model_dir = str(tmp_path / "data"), str(tmp_path / "model")
    write_synthetic_patch_tree(data_dir, n_slides=2, patches_per_slide=5, patch_size=SIDE)
    with contextlib.redirect_stdout(io.StringIO()) as said:
        cli.main(["train", "--data_dir", data_dir, "--model_dir", model_dir, "--fold", "1",
                  "--patch_size", str(SIDE), "--batch_size", "4", "--n_epoch", "1",
                  "--model_arch", "TransUNet", "--loss", "BCElogit", "--selective", "1",
                  "--compute_dtype", "float32", "--num_workers", "1", "--dropout_rate", "0.1"],
                 device="cpu")
    assert "train_select_loss" in said.getvalue()
    ckpt = os.path.join(model_dir, "1-fold", "checkpoint", "model_epoch1.pth")
    net = torch.load(ckpt, weights_only=False)["net"]
    assert set(net) == set(build_model("TransUNet", selective=True, img_size=SIDE,
                                       dims=SMALL).state_dict())
    assert all(bool(torch.isfinite(v.float()).all()) for v in net.values())
    image = str(tmp_path / "patch.png")
    from PIL import Image

    Image.fromarray(images(10, 1)[0][0]).save(image)
    out = str(tmp_path / "out")
    with contextlib.redirect_stdout(io.StringIO()) as said:
        predict.main([image, "--model_path", ckpt, "--model_arch", "TransUNet", "--selective",
                      "1", "--compute_dtype", "float32", "--save_dir", out, "--save_prob", "1",
                      "--heatmap", "0"], device="cpu")
    assert "fold_bn=False" in said.getvalue()
    assert np.load(os.path.join(out, "patch_prob.npy")).shape == (SIDE, SIDE)


def test_the_predictor_serves_it_unfolded(small_published, tmp_path):
    w = seeded_weights(13)
    path = str(tmp_path / "model_epoch1.pth")
    torch.save({"net": w}, path)
    with pytest.raises(ValueError, match="fold_bn"):
        Predictor(path, "TransUNet", selective=True, compute_dtype="float32", device="cpu")
    p = Predictor(path, "TransUNet", selective=True, compute_dtype="float32", fold_bn=False,
                  device="cpu")
    x8, _ = images(14)
    got = p.predict_compact(x8)
    with torch.no_grad():
        out, sel, _ = ref.forward(w, x_of(x8), False, dims=SMALL)
    # probabilities in 1/255 steps, rounded half to even on both sides
    for key, logits in (("prob_u8", out), ("selection_prob_u8", sel)):
        want = torch.round(torch.sigmoid(logits) * 255).numpy()
        assert np.abs(got[key].astype(int) - want.astype(int)).max() <= 1
