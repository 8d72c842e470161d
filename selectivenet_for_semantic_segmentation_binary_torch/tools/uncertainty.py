"""MC-dropout uncertainty: many stochastic forwards and their spread.

Counterpart of the JAX package's ``tools/uncertainty.py`` (``mc_uncertainty``
:21-45, ``_mc_run`` :48-66), after reference
jupyters/check_MC_dropout.ipynb cells 0-4: ``n_iter`` forwards with the
model's dropout live (``mc_dropout=True``), the per-element variance across
them, averaged over the class axis and negated as a confidence.

The JAX version maps the forwards over ``n_iter`` keys split from one
``PRNGKey``; here they run in a loop under ``torch.inference_mode()`` and
draw their masks in turn from one ``torch.Generator`` on the input's device
(seed 0 when none is given). The masks are therefore not JAX's: the maps
match the JAX ones in distribution, and exactly at dropout rate 0.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def aggregate(probs: torch.Tensor):
    """(T, N, H, W, C) probabilities -> (mean, variance, confidence), as the
    JAX ``_mc_run`` computes them: the mean and the population variance
    (``jnp.var``, ddof 0) over the T forwards, and the variance averaged
    over the classes and negated."""
    mean = probs.mean(0)
    var = probs.var(0, unbiased=False)
    return mean, var, -var.mean(-1)


def _probabilities(out, selective: bool) -> torch.Tensor:
    if selective:
        out = out[0]
    if out.ndim == 3:  # binary logits -> (N, H, W, 1)
        return torch.sigmoid(out)[..., None]
    return torch.softmax(out, dim=-1)


def mc_uncertainty(model: torch.nn.Module, x: torch.Tensor, n_iter: int = 100,
                   generator: Optional[torch.Generator] = None,
                   selective: bool = False) -> Dict[str, torch.Tensor]:
    """``n_iter`` MC-dropout forwards of ``x`` ((N, C, H, W) model input on
    the model's device) and their aggregation. The model is in eval mode
    (running BN statistics), as the JAX forwards run with ``train=False``.

    Returns {'mean_prob' (N, H, W, C), 'variance' (N, H, W, C),
    'confidence' (N, H, W)}, float32 tensors on the input's device. A model
    with ``dropout_rate`` 0 gives n_iter identical forwards and variance 0.
    """
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    with torch.inference_mode():
        probs = torch.stack([
            _probabilities(model(x, mc_dropout=True, generator=generator), selective).float()
            for _ in range(n_iter)])
        mean, var, conf = aggregate(probs)
    return {"mean_prob": mean, "variance": var, "confidence": conf}
