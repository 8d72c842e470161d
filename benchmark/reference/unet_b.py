"""Plain float32 reference of the selective UNet_B (reference repository
yellofi/SelectiveNet_for_semantic_segmentation_binary, ``model.py:18-103``,
``selective_loss.py:58-85``, ``train.py:78-101``), for the benchmark's
comparisons.

Plain PyTorch operations on a dict of tensors, no module of the program
under test: the forward in train mode (batch statistics, biased running
variance with momentum 0.1) or eval mode (running statistics), the
BCE-with-logits selective loss, Adam, the step's batch metrics, BatchNorm
folding, per-channel int8 weight quantisation, activation calibration, the
W8A8 forward and the compact uint8 outputs. Every conv runs with TF32 off
(``precise()``), so float32 means float32 on the card too.

``lowp`` is the control's hook: a function applied to both operands of every
conv and transposed conv (``fp8_operands`` rounds them to float8 e4m3 with a
per-tensor scale). With ``lowp=None`` the reference is float32 throughout.

Parameters use the reference repository's state-dict names
(``encoder_layer_1_1.0.weight``, ``.1.running_var``, ``unpool3.weight``,
``conv1x1.weight``, ...).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]

# (name, Cin, Cout) of the 14 3x3 Conv-BN-ReLU blocks in forward order;
# Cin of the first is the image's channels
CBRS: Tuple[Tuple[str, int, int], ...] = (
    ("encoder_layer_1_1", 3, 64), ("encoder_layer_1_2", 64, 64),
    ("encoder_layer_2_1", 64, 128), ("encoder_layer_2_2", 128, 128),
    ("encoder_layer_3_1", 128, 256), ("encoder_layer_3_2", 256, 256),
    ("decoder_layer_4_2", 256, 512), ("decoder_layer_4_1", 512, 512),
    ("decoder_layer_3_2", 512, 256), ("decoder_layer_3_1", 256, 256),
    ("decoder_layer_2_2", 256, 128), ("decoder_layer_2_1", 128, 128),
    ("decoder_layer_1_2", 128, 64), ("decoder_layer_1_1", 64, 64),
)
# (name, Cin, Cout) of the k2s2 transposed convs
UPCONVS = (("unpool3", 512, 256), ("unpool2", 256, 128), ("unpool1", 128, 64))
# the three 1x1 heads on the last 64 channels: output, selection, auxiliary
HEADS = ("conv1x1", "conv_select", "conv_aux")
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
QMAX = 127.0


def leaves() -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every tensor of the model: (name, shape, role, fan_in); role is
    ``weight``/``bias`` for trainable conv tensors, ``bn_weight``,
    ``bn_bias``, ``running_mean``, ``running_var`` for BatchNorm. fan_in is
    torch's (weight.size(1) * kh * kw) for conv tensors, 0 otherwise."""
    out = []
    for name, cin, cout in CBRS:
        fan = cin * 9
        out += [(f"{name}.0.weight", (cout, cin, 3, 3), "weight", fan),
                (f"{name}.0.bias", (cout,), "bias", fan),
                (f"{name}.1.weight", (cout,), "bn_weight", 0),
                (f"{name}.1.bias", (cout,), "bn_bias", 0),
                (f"{name}.1.running_mean", (cout,), "running_mean", 0),
                (f"{name}.1.running_var", (cout,), "running_var", 0)]
    for name, cin, cout in UPCONVS:
        fan = cout * 4  # ConvTranspose2d weight is (in, out, kh, kw)
        out += [(f"{name}.weight", (cin, cout, 2, 2), "weight", fan),
                (f"{name}.bias", (cout,), "bias", fan)]
    for name in HEADS:
        out += [(f"{name}.weight", (1, 64, 1, 1), "weight", 64),
                (f"{name}.bias", (1,), "bias", 64)]
    return out


def trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var", "num_batches_tracked"))


@contextlib.contextmanager
def precise():
    """TF32 off for cuDNN convs and cuBLAS matmuls while the reference runs."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def fp8_operands(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor (its absmax at
    448, e4m3's largest value), as float32; the gradient passes straight
    through."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def _conv(x, w, b, lowp, **kw):
    if lowp is not None:
        x, w = lowp(x), lowp(w)
    return F.conv2d(x, w, b, **kw)


def _upconv(x, w, b, lowp):
    if lowp is not None:
        x, w = lowp(x), lowp(w)
    return F.conv_transpose2d(x, w, b, stride=2)


def forward(p: Tensors, x: torch.Tensor, train: bool, lowp: Optional[Callable] = None,
            stats: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None):
    """x (N, 3, H, W) float32 normalised -> (output, selection, aux) logits,
    each (N, H, W). In train mode BatchNorm normalises with the batch's
    biased statistics and, when ``stats`` is a dict, records each block's
    (mean, biased var) there; in eval mode it uses the running ones."""

    def cbr(name, t):
        t = _conv(t, p[f"{name}.0.weight"], p[f"{name}.0.bias"], lowp, padding=1)
        if train:
            if stats is not None:
                with torch.no_grad():
                    stats[name] = (t.mean((0, 2, 3)), t.var((0, 2, 3), unbiased=False))
            t = F.batch_norm(t, None, None, p[f"{name}.1.weight"], p[f"{name}.1.bias"],
                             True, 0.0, BN_EPS)
        else:
            t = F.batch_norm(t, p[f"{name}.1.running_mean"], p[f"{name}.1.running_var"],
                             p[f"{name}.1.weight"], p[f"{name}.1.bias"], False, 0.0, BN_EPS)
        return torch.relu(t)

    return _unet(p, x, cbr, lowp)


def _unet(p, x, cbr, lowp):
    pool = lambda t: F.max_pool2d(t, 2)  # noqa: E731
    up = lambda name, t: _upconv(t, p[f"{name}.weight"], p[f"{name}.bias"], lowp)  # noqa: E731
    e1 = cbr("encoder_layer_1_2", cbr("encoder_layer_1_1", x))
    e2 = cbr("encoder_layer_2_2", cbr("encoder_layer_2_1", pool(e1)))
    e3 = cbr("encoder_layer_3_2", cbr("encoder_layer_3_1", pool(e2)))
    b = cbr("decoder_layer_4_1", cbr("decoder_layer_4_2", pool(e3)))
    d3 = cbr("decoder_layer_3_1", cbr("decoder_layer_3_2", torch.cat([up("unpool3", b), e3], 1)))
    d2 = cbr("decoder_layer_2_1", cbr("decoder_layer_2_2", torch.cat([up("unpool2", d3), e2], 1)))
    d1 = cbr("decoder_layer_1_1", cbr("decoder_layer_1_2", torch.cat([up("unpool1", d2), e1], 1)))
    return tuple(_conv(d1, p[f"{h}.weight"], p[f"{h}.bias"], lowp).squeeze(1) for h in HEADS)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, C, H, W) float32 (x / 255 - 0.5) / 0.5."""
    return (images_u8.float() / 255.0 - 0.5).div(0.5).permute(0, 3, 1, 2).contiguous()


# -- training ------------------------------------------------------------------

def selective_loss(out, sel, aux, label, s_lamb: float, target_coverage: float):
    """(total, aux BCE, selective risk term, coverage) over every pixel:
    aux = BCE-with-logits; g = sigmoid(sel); coverage = mean(g); risk =
    -mean(loglik * g) / coverage; term = risk + s_lamb * max(tc - cov, 0)^2."""
    y = label.float()
    aux_loss = F.binary_cross_entropy_with_logits(aux, y)
    g = torch.sigmoid(sel)
    coverage = g.mean()
    loglik = y * F.logsigmoid(out) + (1.0 - y) * F.logsigmoid(-out)
    risk = -(loglik * g).mean() / coverage
    term = risk + s_lamb * torch.clamp(target_coverage - coverage, min=0.0) ** 2
    return aux_loss + term, aux_loss, term, coverage


def batch_metrics(out, sel, label) -> Dict[str, int]:
    """The step's counts: the 2x2 confusion matrix of the selected pixels
    (rows truth, columns prediction at sigmoid > 0.5), the pixel count and
    the rejected count (selection sigmoid <= 0.5)."""
    pred = (torch.sigmoid(out) > 0.5).long()
    keep = torch.sigmoid(sel) > 0.5
    lab = label.long()
    cm = [int(((lab == t) & (pred == q) & keep).sum()) for t in (0, 1) for q in (0, 1)]
    return {"cm": cm, "n_pix": int(lab.numel()), "n_reject": int((~keep).sum())}


class Trainer:
    """Adam (torch's update, no weight decay) on the reference forward and
    loss; keeps the parameters, the moments and the running statistics."""

    def __init__(self, weights: Tensors, lr: float, s_lamb: float, target_coverage: float,
                 lowp: Optional[Callable] = None, update: bool = True,
                 moments: Optional[Tuple[Tensors, Tensors, int]] = None):
        """``moments`` (first, second, steps taken) resumes Adam where a
        training run left it; without it Adam starts from nothing."""
        self.p = {k: v.detach().float().clone() for k, v in weights.items()}
        if moments is None:
            self.m = {k: torch.zeros_like(v) for k, v in self.p.items() if trainable(k)}
            self.v = {k: torch.zeros_like(v) for k, v in self.p.items() if trainable(k)}
            self.t = 0
        else:
            m, v, self.t = moments
            self.m = {k: m[k].detach().float().clone() for k in self.p if trainable(k)}
            self.v = {k: v[k].detach().float().clone() for k in self.p if trainable(k)}
        self.lr, self.s_lamb, self.tc, self.lowp = lr, s_lamb, target_coverage, lowp
        self.update = update  # False: a step that leaves its state unchanged (a fault)

    def step(self, x: torch.Tensor, label: torch.Tensor) -> dict:
        """One step on x (N, 3, H, W) normalised and label (N, H, W) {0, 1};
        returns the loss terms, the counts and the gradients."""
        params = {k: (v.requires_grad_(True) if trainable(k) else v)
                  for k, v in self.p.items()}
        stats: dict = {}
        with precise():
            out, sel, aux = forward(params, x, True, self.lowp, stats)
            total, aux_loss, term, cov = selective_loss(out, sel, aux, label, self.s_lamb,
                                                        self.tc)
            names = [k for k in params if trainable(k)]
            grads = torch.autograd.grad(total, [params[k] for k in names])
        result = {"loss": float(total.detach()), "aux_loss": float(aux_loss.detach()),
                  "sel_loss": float(term.detach()), "coverage": float(cov.detach()), **batch_metrics(out.detach(), sel.detach(), label),
                  "grads": dict(zip(names, grads))}
        if not self.update:
            return result
        self.t += 1
        b1, b2 = ADAM_BETAS
        with torch.no_grad():
            for k, g in result["grads"].items():
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(ADAM_EPS)
                self.p[k] = self.p[k].detach().addcdiv(self.m[k], denom,
                                                       value=-self.lr / (1 - b1 ** self.t))
            for name, (mean, var) in stats.items():
                for key, val in (("running_mean", mean), ("running_var", var)):
                    k = f"{name}.1.{key}"
                    self.p[k] = self.p[k] * (1 - BN_MOMENTUM) + val * BN_MOMENTUM
        return result


# -- serving -------------------------------------------------------------------

def fold(weights: Tensors) -> Tensors:
    """Eval-mode BatchNorm multiplied into each block's conv: W * s and
    (b - mean) * s + beta with s = gamma / sqrt(var + eps); the BN tensors
    dropped."""
    out = {k: v.float() for k, v in weights.items() if ".1." not in k}
    for name, _, _ in CBRS:
        s = weights[f"{name}.1.weight"].float() / torch.sqrt(
            weights[f"{name}.1.running_var"].float() + BN_EPS)
        out[f"{name}.0.weight"] = weights[f"{name}.0.weight"].float() * s[:, None, None, None]
        out[f"{name}.0.bias"] = ((weights[f"{name}.0.bias"].float()
                                  - weights[f"{name}.1.running_mean"].float()) * s
                                 + weights[f"{name}.1.bias"].float())
    return out


def folded_forward(f: Tensors, x: torch.Tensor, lowp: Optional[Callable] = None,
                   absmax: Optional[Dict[str, float]] = None,
                   quant: Optional[Dict[str, tuple]] = None, qmax: float = QMAX):
    """The folded serving forward of x (N, 3, H, W): each block conv + bias +
    ReLU. ``absmax`` (a dict) records each block's input absmax; ``quant``
    ({block: (w_q, w_scale, act_scale)}) runs each block W8A8: the input
    quantised to clamp(round(x / a), +-qmax), the integer conv, the sums times
    a * w_scale, plus bias, ReLU."""

    def cbr(name, t):
        if absmax is not None:
            absmax[name] = max(absmax.get(name, 0.0), float(t.abs().max()))
        if quant is not None:
            wq, ws, a = quant[name]
            q = torch.clamp(torch.round(t / a), -qmax, qmax)
            acc = F.conv2d(q, wq, padding=1)
            return torch.relu(acc * (a * ws)[None, :, None, None]
                              + f[f"{name}.0.bias"][None, :, None, None])
        return torch.relu(_conv(t, f[f"{name}.0.weight"], f[f"{name}.0.bias"], lowp,
                                padding=1))

    with precise():
        return _unet(f, x, cbr, lowp)


def quantize_weights(f: Tensors, qmax: float = QMAX) -> Dict[str, tuple]:
    """Per output channel symmetric weights of each block: (integer levels
    as float32, scale = max(absmax, 1e-12) / qmax)."""
    out = {}
    for name, _, _ in CBRS:
        w = f[f"{name}.0.weight"].float()
        scale = torch.clamp(w.abs().amax((1, 2, 3)), min=1e-12) / qmax
        out[name] = (torch.clamp(torch.round(w / scale[:, None, None, None]), -qmax, qmax),
                     scale)
    return out


def calibrate(f: Tensors, images_u8: torch.Tensor, chunk: int = 8,
              qmax: float = QMAX) -> Dict[str, float]:
    """Each block's activation scale max(absmax, 1e-12) / qmax over the
    float32 folded forward of the images."""
    absmax: Dict[str, float] = {}
    with torch.no_grad():
        for i in range(0, images_u8.shape[0], chunk):
            folded_forward(f, normalize(images_u8[i:i + chunk]), absmax=absmax)
    return {k: max(v, 1e-12) / qmax for k, v in absmax.items()}


def w8a8_forward(f: Tensors, x: torch.Tensor, act_scales: Dict[str, float],
                 qmax: float = QMAX):
    """The W8A8 serving forward: the blocks quantised, the transposed convs
    and heads in float32."""
    qw = quantize_weights(f, qmax)
    quant = {n: (qw[n][0], qw[n][1], torch.tensor(act_scales[n], dtype=torch.float32,
                                                    device=x.device)) for n in qw}
    return folded_forward(f, x, quant=quant, qmax=qmax)


def compact(out: torch.Tensor, sel: torch.Tensor, cut: float = 0.5) -> Dict[str, torch.Tensor]:
    """The compact uint8 answer of logits: masks at sigmoid > cut, the
    probabilities rounded to 1/255 (half to even)."""
    prob, sprob = torch.sigmoid(out), torch.sigmoid(sel)
    c = float(np.float32(cut))
    return {"pred": (prob > c).to(torch.uint8),
            "prob_u8": torch.round(prob * 255.0).to(torch.uint8),
            "selection": (sprob > c).to(torch.uint8),
            "selection_prob_u8": torch.round(sprob * 255.0).to(torch.uint8)}
