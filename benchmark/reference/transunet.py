"""Plain float32 reference of TransUNet (R50-ViT-B/16 hybrid) as a
selective segmenter, for the comparisons with the port.

Source: Chen et al., arXiv:2102.04306, and https://github.com/Beckschen/TransUNet
(``networks/vit_seg_configs.py::get_r50_b16_config``,
``networks/vit_seg_modeling.py``, ``networks/vit_seg_modeling_resnet_skip.py``).
Plain PyTorch operations on a dict of tensors, no module of the program under
test: weight standardisation, GroupNorm, LayerNorm, the softmax and GELU (by
erf) and the align_corners bilinear upsampling are written out; every conv,
linear and attention product runs with TF32 off (``precise()``), so float32
means float32 on the card too.

Departures from the published model, each also made by the port:

* the input is 256x256 (published 224), so the position embedding has 256
  rows (published 196);
* the three selective 1x1 heads (prediction, selection, auxiliary) on the
  decoder's 16 channels replace the published 3x3 ``SegmentationHead``;
* the decoder's BatchNorm moves its running variance by the BIASED batch
  variance (the port's flax semantics; ``nn.BatchNorm2d`` uses the unbiased
  one), momentum 0.1, eps 1e-5;
* the loss is the BCE-with-logits selective risk with an auxiliary BCE head
  and the optimizer Adam (the framework's ``train.sh`` recipe; the paper
  trains with CE + Dice and SGD).

``lowp`` is the control's hook: a function applied to both operands of every
conv, linear and attention product (``fp8_operands`` rounds them to float8
e4m3 with a per-tensor scale). ``recompute=True`` runs each ResNet unit, ViT
block and decoder block under ``torch.utils.checkpoint`` so that a batch of
128 fits on one card; BatchNorm still sees the whole batch, and the
statistics a recomputed block records again are the same.

Parameters use the port's state-dict names (those of the published code,
with the port's heads ``conv1x1``, ``conv_select``, ``conv_aux``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]

PUBLISHED = {"width": 64, "units": (3, 4, 9), "hidden": 768, "layers": 12, "heads": 12,
             "mlp_dim": 3072, "head_channels": 512, "decoder": (256, 128, 64, 16)}
PATCH = 16
HEADS = ("conv1x1", "conv_select", "conv_aux")
GN_GROUPS = 32
GN_EPS = 1e-6
PROJ_EPS = 1e-5  # gn_proj: GroupNorm(cout, cout), torch's default eps
LN_EPS = 1e-6
WS_EPS = 1e-5
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

RESNET = "transformer.embeddings.hybrid_model"
ENCODER = "transformer.encoder"


def sizes(dims: Optional[dict] = None) -> dict:
    return {**PUBLISHED, **(dims or {})}


def _units(d: dict) -> List[Tuple[str, int, int, int, int]]:
    """(prefix, cin, cout, cmid, stride) of every ResNet unit in order."""
    out, cin, w = [], d["width"], d["width"]
    for b, n in enumerate(d["units"]):
        cout, cmid = w * 4 * 2 ** b, w * 2 ** b
        for i in range(n):
            out.append((f"{RESNET}.body.block{b + 1}.unit{i + 1}", cin if i == 0 else cout, cout,
                        cmid, (1 if b == 0 else 2) if i == 0 else 1))
        cin = cout
    return out


def _decoder(d: dict) -> List[Tuple[str, int, int]]:
    """(prefix, cin, cout) of the decoder's conv-BN-ReLU blocks in order."""
    skips = [d["width"] * 8, d["width"] * 4, d["width"]]
    ins = [d["head_channels"]] + list(d["decoder"][:-1])
    out = [("decoder.conv_more", d["hidden"], d["head_channels"])]
    for i, (cin, cout) in enumerate(zip(ins, d["decoder"])):
        skip = skips[i] if i < len(skips) else 0
        out += [(f"decoder.blocks.{i}.conv1", cin + skip, cout),
                (f"decoder.blocks.{i}.conv2", cout, cout)]
    return out


def leaves(dims: Optional[dict] = None, img_size: int = 256, in_ch: int = 3,
           selective: bool = True) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every tensor of the model: (name, shape, role, fan_in); role is
    ``weight``/``bias`` for conv and linear tensors, ``bn_weight`` and
    ``bn_bias`` for the norms' scales and shifts (and ``bn_bias``, zeros in
    torch's default, for the position embedding), ``running_mean`` and
    ``running_var`` for BatchNorm's statistics. fan_in is torch's."""
    d = sizes(dims)
    out = []

    def norm(name, c):
        out.extend([(f"{name}.weight", (c,), "bn_weight", 0), (f"{name}.bias", (c,), "bn_bias", 0)])

    def conv(name, cin, cout, k, bias=False):
        out.append((f"{name}.weight", (cout, cin, k, k), "weight", cin * k * k))
        if bias:
            out.append((f"{name}.bias", (cout,), "bias", cin * k * k))

    def linear(name, cin, cout):
        out.extend([(f"{name}.weight", (cout, cin), "weight", cin),
                    (f"{name}.bias", (cout,), "bias", cin)])

    hidden, w = d["hidden"], d["width"]
    out.append(("transformer.embeddings.position_embeddings",
                (1, (img_size // PATCH) ** 2, hidden), "bn_bias", 0))
    conv(f"{RESNET}.root.conv", in_ch, w, 7)
    norm(f"{RESNET}.root.gn", w)
    for name, cin, cout, cmid, stride in _units(d):
        conv(f"{name}.conv1", cin, cmid, 1)
        norm(f"{name}.gn1", cmid)
        conv(f"{name}.conv2", cmid, cmid, 3)
        norm(f"{name}.gn2", cmid)
        conv(f"{name}.conv3", cmid, cout, 1)
        norm(f"{name}.gn3", cout)
        if stride != 1 or cin != cout:
            conv(f"{name}.downsample", cin, cout, 1)
            norm(f"{name}.gn_proj", cout)
    conv("transformer.embeddings.patch_embeddings", w * 16, hidden, 1, bias=True)
    for i in range(d["layers"]):
        b = f"{ENCODER}.layer.{i}"
        norm(f"{b}.attention_norm", hidden)
        norm(f"{b}.ffn_norm", hidden)
        linear(f"{b}.ffn.fc1", hidden, d["mlp_dim"])
        linear(f"{b}.ffn.fc2", d["mlp_dim"], hidden)
        for proj in ("query", "key", "value", "out"):
            linear(f"{b}.attn.{proj}", hidden, hidden)
    norm(f"{ENCODER}.encoder_norm", hidden)
    for name, cin, cout in _decoder(d):
        conv(f"{name}.0", cin, cout, 3)
        norm(f"{name}.1", cout)
        out.extend([(f"{name}.1.running_mean", (cout,), "running_mean", 0),
                    (f"{name}.1.running_var", (cout,), "running_var", 0)])
    for h in HEADS if selective else HEADS[:1]:
        conv(h, d["decoder"][-1], 1, 1, bias=True)
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


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, C, H, W) float32 (x / 255 - 0.5) / 0.5."""
    return (images_u8.float() / 255.0 - 0.5).div(0.5).permute(0, 3, 1, 2).contiguous()


# -- the pieces ------------------------------------------------------------------

def _low(lowp, *ts):
    return ts if lowp is None else tuple(lowp(t) for t in ts)


def _conv(x, w, b, lowp, stride=1, padding=0):
    x, w = _low(lowp, x, w)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def _linear(x, w, b, lowp):
    x, w = _low(lowp, x, w)
    return x @ w.t() + b


def standardize(w: torch.Tensor) -> torch.Tensor:
    """(w - mean) / sqrt(var + 1e-5) per output channel, the biased variance
    over (Cin, kh, kw)."""
    mean = w.mean((1, 2, 3), keepdim=True)
    var = (w - mean).square().mean((1, 2, 3), keepdim=True)
    return (w - mean) / torch.sqrt(var + WS_EPS)


def group_norm(x: torch.Tensor, groups: int, weight, bias, eps: float) -> torch.Tensor:
    n, c, h, w = x.shape
    g = x.reshape(n, groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = (g - mean).square().mean(-1, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(n, c, h, w)
    return y * weight[None, :, None, None] + bias[None, :, None, None]


def layer_norm(x: torch.Tensor, weight, bias, eps: float = LN_EPS) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def softmax(s: torch.Tensor) -> torch.Tensor:
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def upsample_matrix(n: int, device, dtype=torch.float32) -> torch.Tensor:
    """(2n, n): bilinear x2 along one axis with align_corners=True (output i
    samples input i (n - 1) / (2n - 1))."""
    a = np.zeros((2 * n, n))
    for i in range(2 * n):
        src = i * (n - 1) / (2 * n - 1)
        i0 = int(math.floor(src))
        i1, f = min(i0 + 1, n - 1), src - i0
        a[i, i0] += 1.0 - f
        a[i, i1] += f
    return torch.tensor(a, dtype=dtype, device=device)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    a = upsample_matrix(x.shape[-2], x.device, x.dtype)
    b = upsample_matrix(x.shape[-1], x.device, x.dtype)
    return torch.einsum("ih,nchw,jw->ncij", a, x, b)


def dropout(x: torch.Tensor, gen: Optional[torch.Generator], rate: float) -> torch.Tensor:
    """Each element kept with probability 1 - rate (the mask ``rand < 1 -
    rate`` in x's shape, drawn from ``gen``) and scaled by 1 / (1 - rate)."""
    if gen is None or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


# -- the forward -----------------------------------------------------------------

def forward(p: Tensors, x: torch.Tensor, train: bool, lowp: Optional[Callable] = None,
            stats: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
            dims: Optional[dict] = None, gen: Optional[torch.Generator] = None,
            dropout_rate: float = 0.0, recompute: bool = False, selective: bool = True):
    """x (N, 3, S, S) float32 normalised -> (output, selection, aux) logits,
    each (N, S, S) (the output alone where not ``selective``). In train mode
    BatchNorm normalises with the batch's biased statistics and, when
    ``stats`` is a dict, records each block's (mean, biased var) there; in
    eval mode it uses the running ones. ``gen`` draws the dropout masks at
    ``dropout_rate`` (train mode only)."""
    d = sizes(dims)
    if recompute and gen is not None and dropout_rate > 0:
        raise ValueError("recompute would draw the dropout masks again")
    gen = gen if train else None

    def seg(fn, *args):
        if recompute and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def std_conv(name, t, stride=1, padding=0):
        return _conv(t, standardize(p[f"{name}.weight"]), None, lowp, stride, padding)

    def gn(name, t, groups=GN_GROUPS, eps=GN_EPS):
        return group_norm(t, groups, p[f"{name}.weight"], p[f"{name}.bias"], eps)

    def unit(name, cin, cout, stride, t):
        if stride != 1 or cin != cout:
            r = gn(f"{name}.gn_proj", std_conv(f"{name}.downsample", t, stride), cout, PROJ_EPS)
        else:
            r = t
        y = torch.relu(gn(f"{name}.gn1", std_conv(f"{name}.conv1", t)))
        y = torch.relu(gn(f"{name}.gn2", std_conv(f"{name}.conv2", y, stride, 1)))
        return torch.relu(gn(f"{name}.gn3", std_conv(f"{name}.conv3", y)) + r)

    def lin(name, t):
        return _linear(t, p[f"{name}.weight"], p[f"{name}.bias"], lowp)

    def block(i, t):
        b = f"{ENCODER}.layer.{i}"
        n, length, hidden = t.shape
        heads = d["heads"]
        h = layer_norm(t, p[f"{b}.attention_norm.weight"], p[f"{b}.attention_norm.bias"])

        def split(u):
            return u.reshape(n, length, heads, hidden // heads).transpose(1, 2)

        q, k, v = (split(lin(f"{b}.attn.{m}", h)) for m in ("query", "key", "value"))
        q, k = _low(lowp, q, k)
        probs = softmax((q @ k.transpose(-1, -2)) / math.sqrt(hidden // heads))
        probs, v = _low(lowp, probs, v)
        ctx = (probs @ v).transpose(1, 2).reshape(n, length, hidden)
        t = t + lin(f"{b}.attn.out", ctx)
        h = layer_norm(t, p[f"{b}.ffn_norm.weight"], p[f"{b}.ffn_norm.bias"])
        h = dropout(gelu(lin(f"{b}.ffn.fc1", h)), gen, dropout_rate)
        return t + dropout(lin(f"{b}.ffn.fc2", h), gen, dropout_rate)

    def cbr(name, t):
        t = _conv(t, p[f"{name}.0.weight"], None, lowp, padding=1)
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

    def up_block(i, t, skip):
        t = upsample2x(t)
        if skip is not None:
            t = torch.cat([t, skip], 1)
        return cbr(f"decoder.blocks.{i}.conv2", cbr(f"decoder.blocks.{i}.conv1", t))

    size = x.shape[-1]
    # the hybrid ResNet
    t = torch.relu(gn(f"{RESNET}.root.gn", std_conv(f"{RESNET}.root.conv", x, 2, 3)))
    skips = [t]
    t = F.max_pool2d(t, 3, 2, 0)
    n_blocks = len(d["units"])
    for b in range(1, n_blocks + 1):
        for name, cin, cout, _, stride in (u for u in _units(d) if f".block{b}." in u[0]):
            t = seg(lambda u, a=name, c=cin, o=cout, s=stride: unit(a, c, o, s, u), t)
        if b < n_blocks:
            pad = size // 4 // b - t.shape[-1]
            # the published code copies block 1's 63x63 into a zero 64x64
            skips.append(F.pad(t, (0, pad, 0, pad)))
    # the embeddings
    t = _conv(t, p["transformer.embeddings.patch_embeddings.weight"],
              p["transformer.embeddings.patch_embeddings.bias"], lowp)
    n, hidden, g, _ = t.shape
    t = t.flatten(2).transpose(1, 2) + p["transformer.embeddings.position_embeddings"]
    t = dropout(t, gen, dropout_rate)
    # the encoder
    for i in range(d["layers"]):
        t = seg(lambda u, i=i: block(i, u), t)
    t = layer_norm(t, p[f"{ENCODER}.encoder_norm.weight"], p[f"{ENCODER}.encoder_norm.bias"])
    # the decoder
    t = cbr("decoder.conv_more", t.transpose(1, 2).reshape(n, hidden, g, g))
    skips = skips[::-1]
    for i in range(len(d["decoder"])):
        skip = skips[i] if i < len(skips) else None
        t = seg(lambda u, s, i=i: up_block(i, u, s), t, skip)
    heads = HEADS if selective else HEADS[:1]
    out = tuple(_conv(t, p[f"{h}.weight"], p[f"{h}.bias"], lowp).squeeze(1) for h in heads)
    return out if selective else out[0]


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


def batch_metrics(out, sel, label) -> Dict[str, object]:
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
                 moments: Optional[Tuple[Tensors, Tensors, int]] = None,
                 dims: Optional[dict] = None, recompute: bool = False,
                 gen: Optional[torch.Generator] = None, dropout_rate: float = 0.0):
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
        self.dims, self.recompute = dims, recompute
        self.gen, self.dropout_rate = gen, dropout_rate

    def step(self, x: torch.Tensor, label: torch.Tensor) -> dict:
        """One step on x (N, 3, S, S) normalised and label (N, S, S) {0, 1};
        returns the loss terms, the counts, the gradients and the forward's
        probability planes (``planes``: sigmoid of the prediction and the
        selection logits, each (N, S, S))."""
        params = {k: (v.requires_grad_(True) if trainable(k) else v)
                  for k, v in self.p.items()}
        stats: dict = {}
        with precise():
            out, sel, aux = forward(params, x, True, self.lowp, stats, self.dims, self.gen,
                                    self.dropout_rate, self.recompute)
            total, aux_loss, term, cov = selective_loss(out, sel, aux, label, self.s_lamb,
                                                        self.tc)
            names = [k for k in params if trainable(k)]
            grads = torch.autograd.grad(total, [params[k] for k in names])
        result = {"loss": float(total.detach()), "aux_loss": float(aux_loss.detach()),
                  "sel_loss": float(term.detach()), "coverage": float(cov.detach()),
                  **batch_metrics(out.detach(), sel.detach(), label),
                  "grads": dict(zip(names, grads)),
                  "planes": (torch.sigmoid(out.detach()), torch.sigmoid(sel.detach()))}
        del out, sel, aux, total
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
