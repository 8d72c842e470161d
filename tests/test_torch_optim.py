"""The port's optimizers and schedulers against the JAX package's.

Optimizers: five steps from the same parameters with the same gradients and
a learning rate that changes each step, torch.optim against the optax chain
of the JAX ``optim.py:42-55`` (lr applied as ``p - lr * update``, as the JAX
train step does). Tolerance rtol 1e-5, atol 1e-7 (float32 arithmetic in
another order). Schedulers: the per-epoch lr sequence must be identical,
and ``state_dict`` must round-trip and equal the JAX one.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu import optim as jo
from selectivenet_for_semantic_segmentation_binary_torch import optim as po

SHAPES = {"conv": (8, 4, 3, 3), "bias": (8,), "head": (1, 8, 1, 1)}
LRS = [1e-3, 1e-3, 5e-4, 2.5e-4, 1e-3]


def _cfg(**kw):
    base = dict(optim="Adam", momentum=0.0, w_decay=0.0, lr=1e-3, lr_sche=None,
                patience=2, factor=0.5, lr_min=1e-5)
    base.update(kw)
    return SimpleNamespace(**base)


OPTIMS = {
    "adam": dict(optim="Adam"),
    "adam_l2": dict(optim="Adam", w_decay=1e-2),
    "sgd": dict(optim="SGD"),
    "sgd_momentum_l2": dict(optim="SGD", momentum=0.9, w_decay=5e-4),
}


@pytest.mark.parametrize("name", list(OPTIMS))
def test_optimizer_steps_match_optax(name):
    cfg = _cfg(**OPTIMS[name])
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in LRS]

    tx = jo.build_optimizer(cfg)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = po.build_optimizer(cfg, torch_params.values())
    assert type(opt) is (torch.optim.Adam if cfg.optim == "Adam" else torch.optim.SGD)

    for step, (lr, g) in enumerate(zip(LRS, grads)):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p - lr * u, params, updates)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k])
        po.set_lr(opt, lr)
        opt.step()
        for k, p in torch_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} at step {step}")


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="optimizer"):
        po.build_optimizer(_cfg(optim="RMSprop"), [torch.nn.Parameter(torch.zeros(1))])


SCHEDULES = {
    "constant": dict(lr_sche=None),
    "step": dict(lr_sche="StepLR", patience=3, factor=0.5),
    "cosine": dict(lr_sche="CosineAnnealingLR", patience=6, lr_min=1e-5),
    "reduce": dict(lr_sche="ReduceLR", patience=1, factor=0.5),
}
METRICS = [1.0, 0.9, 0.95, 0.97, 0.96, 0.5, 0.6, 0.7, 0.8, 0.4, 0.41, 0.42]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_scheduler_sequence_and_state_match_jax(name):
    cfg = _cfg(**SCHEDULES[name])
    mine, theirs = po.build_scheduler(cfg), jo.build_scheduler(cfg)
    assert type(mine).__name__ == type(theirs).__name__
    lrs = []
    for epoch, metric in enumerate(METRICS):
        arg = metric if cfg.lr_sche == "ReduceLR" else None
        mine.step(arg)
        theirs.step(arg)
        assert mine.lr == theirs.lr, f"epoch {epoch}"
        assert mine.state_dict() == theirs.state_dict()
        lrs.append(mine.lr)
        if epoch == 5:
            # a resumed run continues from the saved state
            resumed = po.build_scheduler(cfg)
            resumed.load_state_dict(mine.state_dict())
            assert resumed.state_dict() == mine.state_dict()
            mine = resumed
    if name != "constant":
        assert len(set(lrs)) > 1, "the schedule never changed the lr"


def test_reduce_lr_state_carries_best_and_bad_epochs():
    sched = po.build_scheduler(_cfg(lr_sche="ReduceLR", patience=2))
    for m in (1.0, 1.5, 1.5):
        sched.step(m)
    d = sched.state_dict()
    assert (d["best"], d["num_bad_epochs"], d["last_epoch"]) == (1.0, 2, 3)
    fresh = po.build_scheduler(_cfg(lr_sche="ReduceLR", patience=2))
    fresh.load_state_dict(d)
    fresh.step(2.0)  # the third bad epoch in a row: patience 2 exceeded
    assert fresh.lr == 0.5e-3 and fresh.num_bad_epochs == 0
    assert math.isinf(po.build_scheduler(_cfg(lr_sche="ReduceLR")).state_dict()["best"])
