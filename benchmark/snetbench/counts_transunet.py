"""The yardstick of TransUNet (R50-ViT-B/16 hybrid, selective heads) at a
256x256 input: model FLOPs of a forward and of a train step, counted layer
by layer from the published equations, frozen here so that a change to the
program cannot move it.

Counted: every conv (the weight-standardised ResNet convs and projections,
the 1x1 patch embedding, the decoder's 3x3 convs, the three 1x1 heads), every
linear of the ViT blocks, and attention's two products (Q K^T and P V), at 2
FLOPs a multiply-accumulate. Not counted: norms, activations, softmax,
pooling, upsampling and the weight standardisation (memory-bound or tiny).
"""

from __future__ import annotations

SIDE = 256
WIDTH = 64
UNITS = (3, 4, 9)
HIDDEN = 768
LAYERS = 12
MLP = 3072
HEAD_CHANNELS = 512
DECODER = (256, 128, 64, 16)
SKIPS = (512, 256, 64, 0)
HEADS = 3


def _conv(side: int, cin: int, cout: int, k: int) -> int:
    return side * side * cin * cout * k * k


def resnet_macs() -> int:
    """Root 7x7 at 128x128, then the bottleneck units from the 63x63 pool."""
    macs = _conv(SIDE // 2, 3, WIDTH, 7)
    side, cin = (SIDE // 2 - 3) // 2 + 1, WIDTH  # max-pool 3, stride 2, no padding: 63
    for b, n in enumerate(UNITS):
        cout, cmid = WIDTH * 4 * 2 ** b, WIDTH * 2 ** b
        for i in range(n):
            stride = 2 if (b > 0 and i == 0) else 1
            out = side if stride == 1 else (side - 1) // 2 + 1
            c_in = cin if i == 0 else cout
            macs += _conv(side, c_in, cmid, 1) + _conv(out, cmid, cmid, 3) + _conv(out, cmid,
                                                                                cout, 1)
            if stride != 1 or c_in != cout:
                macs += _conv(out, c_in, cout, 1)
            side = out
        cin = cout
    return macs


def transformer_macs() -> int:
    """The 1x1 patch embedding and the ViT blocks on 256 tokens."""
    tokens = (SIDE // 16) ** 2
    per_layer = (4 * tokens * HIDDEN * HIDDEN + 2 * tokens * HIDDEN * MLP
                 + 2 * tokens * tokens * HIDDEN)
    return tokens * WIDTH * 16 * HIDDEN + LAYERS * per_layer


def decoder_macs() -> int:
    """conv_more at 16x16, the four blocks' two 3x3 convs, the heads."""
    macs = _conv(SIDE // 16, HIDDEN, HEAD_CHANNELS, 3)
    ins = (HEAD_CHANNELS,) + DECODER[:-1]
    for i, (cin, cout, skip) in enumerate(zip(ins, DECODER, SKIPS)):
        side = SIDE // 16 * 2 ** (i + 1)
        macs += _conv(side, cin + skip, cout, 3) + _conv(side, cout, cout, 3)
    return macs + HEADS * SIDE * SIDE * DECODER[-1]


def forward_flops() -> float:
    """One forward of one patch: 76.76e9."""
    return 2.0 * (resnet_macs() + transformer_macs() + decoder_macs())


def train_step_flops(batch: int) -> float:
    """Forward plus backward of a train step, 3x the forward, nothing
    counted for recompute: 29.47e12 at batch 128."""
    return 3.0 * forward_flops() * batch
