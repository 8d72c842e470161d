"""TransUNet, R50-ViT-B/16 hybrid, as a selective segmenter.

Chen et al., "TransUNet: Transformers Make Strong Encoders for Medical Image
Segmentation" (arXiv:2102.04306); the published code is
https://github.com/Beckschen/TransUNet (``networks/vit_seg_configs.py::
get_r50_b16_config``, ``networks/vit_seg_modeling.py``,
``networks/vit_seg_modeling_resnet_skip.py``). Module names follow that
code, so its state-dict keys are this model's (``transformer.embeddings.
hybrid_model.root.conv.weight``, ``transformer.encoder.layer.0.attn.query.
weight``, ``decoder.blocks.0.conv1.0.weight``, ...), and the heads are the
port's (``conv1x1``, ``conv_select``, ``conv_aux``).

* Hybrid encoder: a BiT ResNetV2 of width 64 and units (3, 4, 9), every
  conv weight-standardised (``StdConv2d``) and bias-free, GroupNorm(32, eps
  1e-6) after each, the projection's GroupNorm one group a channel (eps
  1e-5). The root (7x7, stride 2, GN, ReLU) is skip 3; block 1's output,
  zero-padded at the bottom and right to a quarter of the input (63 -> 64
  at 256, as the published code pads it), is skip 2; block 2's is skip 1.
* Embeddings: a 1x1 conv (with bias) 1024 -> hidden, the tokens of the
  16x-downsampled grid, plus a learned position embedding (one row a token:
  ``img_size`` sets the count), then dropout.
* Encoder: ``layers`` pre-LN ViT blocks (LayerNorm eps 1e-6; attention of
  ``heads`` heads on ``F.scaled_dot_product_attention``, scale
  1/sqrt(head size); an MLP with exact GELU and dropout), a final LayerNorm.
* Decoder (the cascaded upsampler): the tokens as a (hidden, g, g) map,
  ``conv_more`` (3x3, BN, ReLU) to 512, then four blocks of bilinear x2
  (align_corners=True), concatenation with the skip, and two 3x3
  conv-BN-ReLU. The convs before a BN have no bias; BN is the port's
  ``BatchNorm2d`` (float32 statistics, global on a fleet).
* Heads: the port's three selective 1x1 heads on the last 16 channels
  (``ops.sel_heads.apply_heads``, K11 on a card) in place of the published
  3x3 ``SegmentationHead``; ``forward`` returns what ``UNetB.forward``
  returns.

``compute_dtype="bfloat16"`` runs the model under ``torch.autocast``: the
convs, linears and attention in bf16, GroupNorm and LayerNorm in float32 (as
autocast runs them), the heads back in float32. On a card, bf16 attention is
held to the flash, cuDNN and memory-efficient kernels: a shape none of them
takes raises instead of falling back to the math path.

Dropout sits at the published sites (after the position embedding, after
the MLP's GELU and after its second linear), each a ``Dropout`` drawing its
mask from the caller's generator, as the U-Nets' sites do.

Traced (``utils/tracing.py``) as three device spans inside the forward:
``transunet.encoder`` (the ResNet and the embeddings),
``transunet.transformer`` (the blocks and the final LayerNorm) and
``transunet.decoder`` (from the reshape to the heads' input). The counters
below count the attention calls since import.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import sel_heads
from ..utils import tracing
from .unet import _DTYPES, BatchNorm2d, Dropout, Head, LowPrecStatsBN

# Calls of the attention and the tokens they took (batch x tokens, a call),
# since import or since the caller last reset them.
attention_calls = 0
attention_tokens = 0

# get_r50_b16_config: ResNet width and units, ViT-B/16, the decoder
PUBLISHED: Dict[str, object] = {
    "width": 64, "units": (3, 4, 9), "hidden": 768, "layers": 12, "heads": 12,
    "mlp_dim": 3072, "head_channels": 512, "decoder": (256, 128, 64, 16),
}
PATCH = 16  # the ResNet's total stride: one token a 16x16 patch
GN_EPS = 1e-6
LN_EPS = 1e-6
WS_EPS = 1e-5  # StdConv2d's weight standardisation


class StdConv2d(nn.Conv2d):
    """A conv whose weight is standardised per output channel before each
    use: (w - mean) / sqrt(var + 1e-5), the biased variance over (Cin, kh,
    kw) (BiT's weight standardisation)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (self.weight - mean) / torch.sqrt(var + WS_EPS)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


def _std_conv(cin: int, cout: int, k: int, stride: int = 1) -> StdConv2d:
    return StdConv2d(cin, cout, kernel_size=k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """One ResNetV2 unit (the published ``PreActBottleneck``, post-activation
    as that code runs it): relu(gn3(conv3(relu(gn2(conv2(relu(gn1(conv1(x)))))))) + r),
    r = gn_proj(downsample(x)) where the stride or the width changes, else x."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = nn.GroupNorm(32, cmid, eps=GN_EPS)
        self.conv1 = _std_conv(cin, cmid, 1)
        self.gn2 = nn.GroupNorm(32, cmid, eps=GN_EPS)
        self.conv2 = _std_conv(cmid, cmid, 3, stride)
        self.gn3 = nn.GroupNorm(32, cout, eps=GN_EPS)
        self.conv3 = _std_conv(cmid, cout, 1)
        if stride != 1 or cin != cout:
            self.downsample = _std_conv(cin, cout, 1, stride)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.gn_proj(self.downsample(x)) if hasattr(self, "downsample") else x
        y = torch.relu(self.gn1(self.conv1(x)))
        y = torch.relu(self.gn2(self.conv2(y)))
        return torch.relu(self.gn3(self.conv3(y)) + r)


class ResNetV2(nn.Module):
    """The hybrid's ResNet: root, max-pool, three blocks. Returns block 3's
    output and the skips (block 2's, block 1's padded, the root's)."""

    def __init__(self, in_ch: int, width: int, units: Sequence[int]):
        super().__init__()
        self.root = nn.Sequential()
        self.root.add_module("conv", StdConv2d(in_ch, width, kernel_size=7, stride=2, padding=3,
                                               bias=False))
        self.root.add_module("gn", nn.GroupNorm(32, width, eps=GN_EPS))
        self.root.add_module("relu", nn.ReLU(inplace=True))
        self.body = nn.Sequential()
        cin = width
        for b, n in enumerate(units):
            cout, cmid, stride = width * 4 * 2 ** b, width * 2 ** b, 1 if b == 0 else 2
            block = nn.Sequential()
            for i in range(n):
                block.add_module(f"unit{i + 1}", Bottleneck(cin if i == 0 else cout, cout, cmid,
                                                            stride if i == 0 else 1))
            self.body.add_module(f"block{b + 1}", block)
            cin = cout

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        size = x.shape[-1]
        x = self.root(x)
        skips = [x]
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=0)
        for i, block in enumerate(self.body[:-1]):
            x = block(x)
            want = size // 4 // (i + 1)
            pad = want - x.shape[-1]
            if not 0 <= pad < 3:
                raise ValueError(f"skip {i + 1}: a {x.shape[-1]}-pixel map for a {want}-pixel "
                                 f"skip (input {size})")
            # the published code copies block 1's 63x63 into a zero 64x64
            skips.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        return self.body[-1](x), skips[::-1]


class Embeddings(nn.Module):
    """The ResNet, the 1x1 patch embedding and the position embedding."""

    def __init__(self, in_ch: int, img_size: int, width: int, units: Sequence[int],
                 hidden: int, dropout_rate: float):
        super().__init__()
        if img_size % PATCH:
            raise ValueError(f"img_size {img_size} is not a multiple of {PATCH}")
        self.img_size = img_size
        self.hybrid_model = ResNetV2(in_ch, width, units)
        self.patch_embeddings = nn.Conv2d(width * 16, hidden, kernel_size=1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, (img_size // PATCH) ** 2, hidden))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator]):
        if tuple(x.shape[-2:]) != (self.img_size, self.img_size):
            raise ValueError(f"TransUNet built for {self.img_size}x{self.img_size} inputs "
                             f"(its position embedding), got {tuple(x.shape[-2:])}")
        x, skips = self.hybrid_model(x)
        x = self.patch_embeddings(x).flatten(2).transpose(1, 2)  # (N, tokens, hidden)
        return self.dropout(x + self.position_embeddings, gen, nhwc=True), skips


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of (N, heads, L, d) tensors, scale 1/sqrt(d). On a
    card in bf16 only the flash, cuDNN and memory-efficient kernels may
    run it."""
    if q.is_cuda and q.dtype == torch.bfloat16:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v)
    return F.scaled_dot_product_attention(q, k, v)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} is not a multiple of heads {heads}")
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        global attention_calls, attention_tokens
        n, length, hidden = x.shape

        def split(t):
            return t.view(n, length, self.heads, hidden // self.heads).transpose(1, 2)

        y = attention(split(self.query(x)), split(self.key(x)), split(self.value(x)))
        attention_calls += 1
        attention_tokens += n * length
        return self.out(y.transpose(1, 2).reshape(n, length, hidden))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, dropout_rate: float):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
        x = self.dropout(F.gelu(self.fc1(x)), gen, nhwc=True)
        return self.dropout(self.fc2(x), gen, nhwc=True)


class Block(nn.Module):
    """x + Attn(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int, dropout_rate: float):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.ffn_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.ffn = Mlp(hidden, mlp_dim, dropout_rate)
        self.attn = Attention(hidden, heads)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x), gen)


class Encoder(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int, mlp_dim: int, dropout_rate: float):
        super().__init__()
        self.layer = nn.ModuleList(Block(hidden, heads, mlp_dim, dropout_rate)
                                   for _ in range(layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
        for block in self.layer:
            x = block(x, gen)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    def __init__(self, embeddings: Embeddings, encoder: Encoder):
        super().__init__()
        self.embeddings = embeddings
        self.encoder = encoder


class Conv2dReLU(nn.Sequential):
    """3x3 conv (no bias) -> BatchNorm -> ReLU (published ``Conv2dReLU``)."""

    def __init__(self, cin: int, cout: int, bn_stats: str):
        bn = (BatchNorm2d(cout, eps=1e-5) if bn_stats == "float32"
              else LowPrecStatsBN(cout, eps=1e-5, stats_dtype=_DTYPES[bn_stats]))
        super().__init__(nn.Conv2d(cin, cout, kernel_size=3, padding=1, bias=False), bn,
                         nn.ReLU(inplace=True))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int, bn_stats: str):
        super().__init__()
        self.conv1 = Conv2dReLU(cin + skip, cout, bn_stats)
        self.conv2 = Conv2dReLU(cout, cout, bn_stats)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        if skip is not None:
            # the skip in the decoder's dtype: the conv would cast it anyway
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        return self.conv2(self.conv1(x))


class DecoderCup(nn.Module):
    def __init__(self, hidden: int, head_channels: int, decoder: Sequence[int],
                 skips: Sequence[int], bn_stats: str):
        super().__init__()
        self.conv_more = Conv2dReLU(hidden, head_channels, bn_stats)
        ins = [head_channels] + list(decoder[:-1])
        self.blocks = nn.ModuleList(
            DecoderBlock(i, o, s, bn_stats)
            for i, o, s in zip(ins, decoder, list(skips) + [0] * (len(decoder) - len(skips))))

    def forward(self, tokens: torch.Tensor, skips: List[torch.Tensor]) -> torch.Tensor:
        n, length, hidden = tokens.shape
        g = math.isqrt(length)
        # (N, g*g, hidden) -> (N, hidden, g, g) as a channels_last view
        x = self.conv_more(tokens.reshape(n, g, g, hidden).permute(0, 3, 1, 2))
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x


class TransUNet(nn.Module):
    """forward(x (N, C, H, W), mc_dropout=False, generator=None) ->
        non-selective: (N, H, W) float32 logits
        selective:     (output, select, aux), each (N, H, W) float32
    with H = W = ``img_size``."""

    def __init__(self, selective: bool = False, in_ch: int = 3, compute_dtype: str = "float32",
                 img_size: int = 256, dropout_rate: float = 0.0, bn_stats: str = "float32",
                 width: int = 64, units: Sequence[int] = (3, 4, 9), hidden: int = 768,
                 layers: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 head_channels: int = 512, decoder: Sequence[int] = (256, 128, 64, 16)):
        super().__init__()
        for name, value in (("compute_dtype", compute_dtype), ("bn_stats", bn_stats)):
            if value not in _DTYPES:
                raise ValueError(f"unknown {name} {value!r} (expected one of {sorted(_DTYPES)})")
        self.selective = selective
        self.compute_dtype = _DTYPES[compute_dtype]
        self.dropout_rate = dropout_rate
        self.transformer = Transformer(
            Embeddings(in_ch, img_size, width, units, hidden, dropout_rate),
            Encoder(hidden, layers, heads, mlp_dim, dropout_rate))
        self.decoder = DecoderCup(hidden, head_channels, decoder,
                                  (width * 8, width * 4, width), bn_stats)
        self.conv1x1 = Head(decoder[-1], 1)
        if selective:
            self.conv_select = Head(decoder[-1], 1)
            self.conv_aux = Head(decoder[-1], 1)

    def _autocast(self, device_type: str):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type=device_type, dtype=self.compute_dtype)

    def forward(self, x: torch.Tensor, mc_dropout: bool = False,
                generator: Optional[torch.Generator] = None):
        gen = None
        if self.dropout_rate > 0 and (self.training or mc_dropout):
            if generator is None:
                raise ValueError(f"dropout_rate {self.dropout_rate} is live here (train mode or "
                                 "mc_dropout=True): pass forward(..., generator=) to draw its "
                                 "masks")
            gen = generator
        t = self.transformer
        with self._autocast(x.device.type):
            with tracing.span("transunet.encoder", device=x.device):
                tokens, skips = t.embeddings(x, gen)
            with tracing.span("transunet.transformer", device=x.device):
                tokens = t.encoder(tokens, gen)
            with tracing.span("transunet.decoder", device=x.device):
                feat = self.decoder(tokens, skips)
            heads = (self.conv1x1, self.conv_select, self.conv_aux) if self.selective else (
                self.conv1x1,)
            out = [y.squeeze(-1) for y in sel_heads.apply_heads(feat, heads)]
        return tuple(out) if self.selective else out[0]

    def reset_weights(self, generator: torch.Generator) -> "TransUNet":
        """torch's default initialisation, drawn from ``generator`` (on the
        parameters' device): conv and linear weights and biases
        U(+-1/sqrt(fan_in)), the norms' scales 1 and shifts 0, BN running
        mean 0 and variance 1, the position embedding 0 (the published
        ``torch.zeros``)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    m.weight.uniform_(-bound, bound, generator=generator)
                    if m.bias is not None:
                        m.bias.uniform_(-bound, bound, generator=generator)
                elif isinstance(m, (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)):
                    m.reset_parameters()
            self.transformer.embeddings.position_embeddings.zero_()
        return self


def img_size_of(state_dict: Dict[str, torch.Tensor]) -> Optional[int]:
    """The input side a TransUNet state dict was built for (from its
    position embedding's rows), or None for another model's."""
    pos = state_dict.get("transformer.embeddings.position_embeddings")
    return None if pos is None else PATCH * math.isqrt(int(pos.shape[1]))


def build_transunet(n_cls: int = 2, selective: bool = False, compute_dtype: str = "float32",
                    fused: bool = False, folded: bool = False, dropout_rate: float = 0.0,
                    in_ch: int = 3, bn_stats: str = "float32", quantize: str = "none",
                    quant_calibrate: bool = False, train_quant: str = "none",
                    bn_mode: str = "global", img_size: int = 256,
                    dims: Optional[dict] = None) -> TransUNet:
    """``models.build_model("TransUNet", ...)``: the published sizes unless
    ``dims`` (keys of ``PUBLISHED``) says otherwise. The U-Nets' trunk
    variants have no TransUNet path and are refused."""
    refused = {"fused": fused, "folded (fold_bn)": folded, "quantize='int8'": quantize != "none",
               "quant_calibrate": quant_calibrate, "train_quant='int8'": train_quant != "none",
               "bn_mode='per_replica'": bn_mode != "global"}
    for name, on in refused.items():
        if on:
            raise ValueError(f"{name} is not implemented for TransUNet: the fused, folded, int8 "
                             "and per-replica paths are the U-Nets' CBR trunk's; serve TransUNet "
                             "unfolded (fold_bn=False) in bf16 or float32")
    sizes = {**PUBLISHED, **(dims or {})}
    unknown = set(sizes) - set(PUBLISHED)
    if unknown:
        raise ValueError(f"unknown TransUNet sizes {sorted(unknown)}")
    return TransUNet(selective=selective, in_ch=in_ch, compute_dtype=compute_dtype,
                     img_size=img_size, dropout_rate=dropout_rate, bn_stats=bn_stats, **sizes)
