"""Optimizers and per-epoch learning-rate schedulers.

Counterpart of the JAX package's ``optim.py:31-163`` (reference
train.py:88-101, 246-250):

* ``build_optimizer``: ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8) or
  ``torch.optim.SGD`` with torch's L2 ``weight_decay`` (added to the gradient
  before the moments: not AdamW), the chain the JAX package builds from
  optax (add_decayed_weights -> scale_by_adam / trace). The learning rate is
  set on the optimizer before every step (``set_lr``), as the JAX step takes
  it as an argument.
* The schedulers are the JAX package's host-side classes, copied: ``lr``,
  ``step(metric)`` once per epoch, and a ``state_dict`` that a checkpoint
  carries (ReduceLROnPlateau's ``best`` and ``num_bad_epochs`` included).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """Adam or SGD over ``params`` (lr is set per step by ``set_lr``)."""
    params = list(params)
    if cfg.optim == "Adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.w_decay)
    if cfg.optim == "SGD":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.w_decay)
    raise ValueError(f"unknown optimizer {cfg.optim!r} (expected 'Adam' or 'SGD')")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class LRScheduler:
    """Base: ``lr`` property + per-epoch ``step(metric)`` (torch-style)."""

    def __init__(self, lr0: float):
        self.lr0 = lr0
        self._lr = lr0
        self.last_epoch = 0

    @property
    def lr(self) -> float:
        return self._lr

    def step(self, metric: Optional[float] = None) -> None:
        self.last_epoch += 1
        self._update(metric)

    def _update(self, metric):
        pass

    def state_dict(self) -> dict:
        return {"lr": self._lr, "last_epoch": self.last_epoch}

    def load_state_dict(self, d: dict) -> None:
        self._lr = float(d["lr"])
        self.last_epoch = int(d["last_epoch"])


class ConstantLR(LRScheduler):
    pass


class StepLR(LRScheduler):
    """lr = lr0 * gamma^(last_epoch // step_size) (torch StepLR)."""

    def __init__(self, lr0: float, step_size: int, gamma: float = 0.5):
        super().__init__(lr0)
        self.step_size = step_size
        self.gamma = gamma

    def _update(self, metric):
        self._lr = self.lr0 * self.gamma ** (self.last_epoch // self.step_size)


class CosineAnnealingLR(LRScheduler):
    """lr = eta_min + (lr0 - eta_min) * (1 + cos(pi * t / T_max)) / 2."""

    def __init__(self, lr0: float, T_max: int, eta_min: float = 0.0):
        super().__init__(lr0)
        self.T_max = T_max
        self.eta_min = eta_min

    def _update(self, metric):
        t = self.last_epoch
        self._lr = self.eta_min + (self.lr0 - self.eta_min) * (
            1 + math.cos(math.pi * t / self.T_max)
        ) / 2


class ReduceLROnPlateau(LRScheduler):
    """mode='min': multiply lr by ``factor`` after ``patience`` epochs without
    improvement (torch semantics incl. the 1e-4 relative threshold)."""

    def __init__(self, lr0: float, patience: int = 10, factor: float = 0.5,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        super().__init__(lr0)
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad_epochs = 0

    def _update(self, metric):
        if metric is None:
            raise ValueError("ReduceLROnPlateau.step requires the epoch metric")
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self._lr = max(self._lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0

    def state_dict(self) -> dict:
        d = super().state_dict()
        d.update(best=self.best, num_bad_epochs=self.num_bad_epochs)
        return d

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        self.best = float(d.get("best", math.inf))
        self.num_bad_epochs = int(d.get("num_bad_epochs", 0))


def build_scheduler(cfg) -> LRScheduler:
    """Factory matching reference train.py:96-101."""
    if cfg.lr_sche is None:
        return ConstantLR(cfg.lr)
    if cfg.lr_sche == "StepLR":
        return StepLR(cfg.lr, step_size=cfg.patience, gamma=cfg.factor)
    if cfg.lr_sche == "ReduceLR":
        return ReduceLROnPlateau(cfg.lr, patience=cfg.patience, factor=cfg.factor)
    if cfg.lr_sche == "CosineAnnealingLR":
        return CosineAnnealingLR(cfg.lr, T_max=cfg.patience, eta_min=cfg.lr_min)
    raise ValueError(f"unknown lr_sche {cfg.lr_sche!r}")
