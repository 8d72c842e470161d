"""Segmentation losses and SelectiveNet coverage-constrained risks.

Counterpart of the JAX package's ``ops/losses.py:40-177`` (reference
train.py:78-80, selective_loss.py:6-85):

* ``bce_with_logits``       <- torch.nn.BCEWithLogitsLoss
* ``softmax_cross_entropy`` <- torch.nn.CrossEntropyLoss
* ``selective_risk_b``      <- calc_selective_risk_image_b
* ``selective_risk_ce``     <- calc_selective_risk_image

Every function reduces in float32 whatever the activations' dtype, and
takes ``mask`` (True on valid pixels): the padded pixels of a static-shape
last batch carry ``PAD_LABEL`` and drop out of every mean. log(p) and
log(1 - p) are the stable ``logsigmoid(x)`` and ``logsigmoid(-x)``, where
the reference takes log(sigmoid(x)), which is -inf for very negative x.
Outputs are channels-last as in the JAX package: binary (N, H, W), n-class
(N, H, W, C).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over all elements, or over mask == True elements."""
    if mask is None:
        return x.mean()
    m = mask.float()
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross-entropy on logits (== torch BCEWithLogitsLoss), in
    the max(x, 0) - x*y + log1p(exp(-|x|)) form."""
    x = logits.float()
    y = targets.float()
    per_elem = torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return _masked_mean(per_elem, mask)


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          class_axis: int = -1,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy with integer targets (== torch
    CrossEntropyLoss); padded targets are clipped into range and masked."""
    logp = torch.log_softmax(torch.movedim(logits.float(), class_axis, -1), dim=-1)
    safe = torch.clamp(targets.long(), 0, logp.shape[-1] - 1)
    picked = torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    return -_masked_mean(picked, mask)


def _coverage_constraint(coverage: torch.Tensor, target_coverage: float) -> torch.Tensor:
    """max(target_coverage - coverage, 0)^2 (selective_loss.py:51-52, 81-83)."""
    return torch.square(torch.clamp(target_coverage - coverage, min=0.0))


def selective_risk_b(output: torch.Tensor, selection: torch.Tensor, target: torch.Tensor,
                     target_coverage: float = 0.8, lamb: float = 8.0,
                     hard_selection: bool = False,
                     mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SelectiveNet risk of binary segmentation with BCE (selective_loss.py:58-85).

    ``g = sigmoid(selection)``; ``coverage = mean(g)``;
    ``risk = -mean((y log p + (1 - y) log(1 - p)) * g) / coverage`` with
    ``p = sigmoid(output)``; returns ``(risk + lamb * max(tc - coverage, 0)^2,
    coverage)``."""
    x = output.float()
    y = target.float()
    if mask is not None:
        y = torch.clamp(y, 0.0, 1.0)  # padded labels carry PAD_LABEL; masked below
    g = torch.sigmoid(selection.float())
    coverage = _masked_mean(g, mask)
    if hard_selection:
        # reference selective_loss.py:74-77: detach, then binarise at 0.5
        g = (g > 0.5).float()
        coverage = coverage.detach()
    log_lik = y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x)
    risk = -_masked_mean(log_lik * g, mask) / coverage
    return risk + lamb * _coverage_constraint(coverage, target_coverage), coverage


def selective_risk_ce(output: torch.Tensor, selection: torch.Tensor, target: torch.Tensor,
                      target_coverage: float = 0.8, lamb: float = 8.0,
                      hard_selection: bool = False,
                      mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SelectiveNet risk of n-class segmentation with CE (selective_loss.py:24-56).

    output (N, H, W, C) logits; selection (N, H, W, 2), ``g = softmax[..., 1]``;
    target (N, H, W) integer labels or (N, H, W, C) one-hot."""
    f = output.float()
    if target.ndim == 3:
        t = target.long()
        if mask is not None:
            t = torch.clamp(t, 0, f.shape[-1] - 1)  # padded labels masked below
        target = F.one_hot(t, f.shape[-1])
    target = target.float()
    g = torch.softmax(selection.float(), dim=-1)[..., 1]
    coverage = _masked_mean(g, mask)
    if hard_selection:
        g = (g > 0.5).float()
        coverage = coverage.detach()
    nll = (torch.log_softmax(f, dim=-1) * target).sum(-1)
    risk = -_masked_mean(nll * g, mask) / coverage
    return risk + lamb * _coverage_constraint(coverage, target_coverage), coverage
