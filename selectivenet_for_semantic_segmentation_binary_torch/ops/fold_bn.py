"""BatchNorm folding for the serving path.

Counterpart of the JAX package's ``ops/fold_bn.py`` (``_fold_one`` :25,
``fold_batchnorm`` :49). In eval mode BatchNorm is a per-channel affine map
with frozen statistics, so it folds into the conv before it:

    BN(conv(x, W) + b) = conv(x, W * s) + (b - mean) * s + beta,
    s = gamma / sqrt(var + eps),

which drops one read and one write of every CBR output from the forward.
The JAX version works on the flax tree, whose conv kernels lie (kh, kw, in,
out), and scales the last axis; this one works on the port's state dict,
whose conv weights lie (out, in, kh, kw), and scales the first. The folded
state dict has no BatchNorm keys and loads into ``build_model(...,
folded=True)``, whose CBR blocks are conv -> ReLU with the same ``.0``
index (tests/test_torch_fold_bn.py pins both packages together).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

BN_EPS = 1e-5  # models/unet.py CBR epsilon (torch's default)
_BN_KEYS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _fold_one(weight: torch.Tensor, bias: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One conv (out, in, kh, kw) and the BN after it -> the folded conv,
    in float32 as the JAX version computes it in numpy."""
    s = gamma.float() / torch.sqrt(var.float() + BN_EPS)
    return ((weight.float() * s[:, None, None, None]).to(weight.dtype),
            ((bias.float() - mean.float()) * s + beta.float()).to(bias.dtype))


def fold_batchnorm(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's state dict -> the same with every CBR's BN folded into its
    conv and the BN keys dropped. A CBR is a prefix with ``.0.weight`` (the
    conv) and ``.1.running_var`` (its BN); heads and transposed convs pass
    through."""
    cbrs = [k[:-len(".1.running_var")] for k in state_dict if k.endswith(".1.running_var")]
    dropped = {f"{p}.1.{n}" for p in cbrs for n in _BN_KEYS}
    out = {k: v for k, v in state_dict.items() if k not in dropped}
    for p in cbrs:
        out[f"{p}.0.weight"], out[f"{p}.0.bias"] = _fold_one(
            state_dict[f"{p}.0.weight"], state_dict[f"{p}.0.bias"],
            state_dict[f"{p}.1.weight"], state_dict[f"{p}.1.bias"],
            state_dict[f"{p}.1.running_mean"], state_dict[f"{p}.1.running_var"])
    return out
