"""``--remat``: the port's rematerialised train step (``train_lib.remat_forward``).

(a) On the CPU in float32, with ``dropout_rate`` 0.1 drawing from the step's
    generator, a remat step equals the step without remat within 1e-6: the
    loss, every gradient, the updated parameters and the BatchNorm running
    statistics, which move once a step (``num_batches_tracked`` 1 a step),
    on both trunks, over two steps. The forward runs twice a remat step.
(b) The two hazards the guard exists for: a plain ``torch.utils.checkpoint``
    updates the running statistics twice, and a recompute that draws from
    the advanced generator draws other masks.
(c) The fused trunk's recompute is counted apart (``recomputing`` is set
    during the second forward only).
(d) The port's remat step against the JAX package's (``remat=True``), at
    ``LOCK_TOL`` of tests/test_torch_train.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from selectivenet_for_semantic_segmentation_binary_tpu.config import TrainConfig as JaxTrainConfig
from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.optim import build_optimizer as jax_optimizer
from selectivenet_for_semantic_segmentation_binary_tpu.train_lib import (
    TrainState, make_train_step as jax_train_step)
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
from selectivenet_for_semantic_segmentation_binary_torch.models import (
    BatchNorm2d, build_model, init_weights)
from selectivenet_for_semantic_segmentation_binary_torch.ops import fused_cbr
from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
    check_supported, make_train_step, remat_forward)

SIZE, BATCH, LR = 32, 2, 1e-3
TOL = dict(rtol=1e-6, atol=1e-6)
LOCK_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_torch_train.py:78
TRUNKS = {"classic": False, "fused": True}


def _model(fused=False, dropout_rate=0.0, compute_dtype="float32", seed=0):
    model = build_model("UNet_B", selective=True, fused=fused, dropout_rate=dropout_rate,
                        compute_dtype=compute_dtype)
    g = torch.Generator().manual_seed(seed)
    init_weights(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model


def _batches(seed, n=2):
    rng = np.random.default_rng(seed)
    return [{"input": torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                                    dtype=np.uint8)),
             "label": torch.from_numpy((rng.random((BATCH, SIZE, SIZE)) > 0.5)
                                       .astype(np.uint8)),
             "flips": torch.from_numpy(rng.integers(0, 2, (BATCH, 2)).astype(np.uint8))}
            for _ in range(n)]


def _cfg(**kw):
    base = dict(model_arch="UNet_B", selective=True, loss="BCElogit", s_lamb=2.0,
                compute_dtype="float32", batch_size=BATCH, patch_size=SIZE, lr=LR)
    base.update(kw)
    return TrainConfig(**base)


def _run(model, cfg, batches):
    """Steps on ``batches``; per step: metrics, gradients, state after."""
    step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    calls = []
    # a pre-hook: the recompute stops once it has what the backward needs,
    # before the forward returns
    model.register_forward_pre_hook(lambda *a: calls.append(1))
    traj = []
    for b in batches:
        metrics = step(b, LR)
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        traj.append((metrics, grads, state, len(calls)))
    return traj


@pytest.fixture(scope="module", params=list(TRUNKS))
def remat_pair(request):
    fused = TRUNKS[request.param]
    model = _model(fused, dropout_rate=0.1, seed=1)
    batches = _batches(2)
    plain = _run(copy.deepcopy(model), _cfg(dropout_rate=0.1), batches)
    remat = _run(copy.deepcopy(model), _cfg(dropout_rate=0.1, remat=True), batches)
    return plain, remat


def test_remat_step_equals_the_plain_step(remat_pair):
    plain, remat = remat_pair
    for (pm, pg, ps, _), (rm, rg, rs, _) in zip(plain, remat):
        for k in ("loss", "aux_loss", "sel_loss", "coverage"):
            np.testing.assert_allclose(float(rm[k]), float(pm[k]), **TOL, err_msg=k)
        assert torch.equal(rm["cm"], pm["cm"]) and torch.equal(rm["n_reject"], pm["n_reject"])
        assert set(rg) == set(pg)
        for k in pg:
            np.testing.assert_allclose(rg[k].numpy(), pg[k].numpy(), **TOL, err_msg=k)
        for k in ps:
            np.testing.assert_allclose(rs[k].numpy(), ps[k].numpy(), **TOL, err_msg=k)


def test_running_statistics_move_once_a_step(remat_pair):
    _, remat = remat_pair
    for i, (_, _, state, _) in enumerate(remat):
        counters = [int(v) for k, v in state.items() if k.endswith("num_batches_tracked")]
        assert counters == [i + 1] * 14


def test_remat_runs_the_forward_twice(remat_pair):
    plain, remat = remat_pair
    assert [c for *_, c in plain] == [1, 2]
    assert [c for *_, c in remat] == [2, 4]  # the forward, then its recompute


def test_a_plain_checkpoint_would_update_bn_twice_and_redraw_dropout():
    """What remat_forward guards against: without ``recomputing`` and the
    generator's replay, the recompute moves the running statistics a second
    time and draws other dropout masks, so the gradients differ."""
    model = _model(dropout_rate=0.1, seed=3)
    x = torch.randn(BATCH, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(4))
    results = {}
    for name in ("guarded", "naive", "plain"):
        m = copy.deepcopy(model).train()
        gen = torch.Generator().manual_seed(5)
        if name == "guarded":
            out = remat_forward(m, x, gen)
        elif name == "naive":
            out = checkpoint(lambda inp: m(inp, generator=gen), x, use_reentrant=False)
        else:
            out = m(x, generator=gen)
        sum(o.float().square().mean() for o in out).backward()
        results[name] = (m, gen.get_state())
    plain, guarded, naive = results["plain"][0], results["guarded"][0], results["naive"][0]
    key = "decoder_layer_1_1.1.num_batches_tracked"
    assert int(guarded.state_dict()[key]) == int(plain.state_dict()[key]) == 1
    assert int(naive.state_dict()[key]) == 2
    assert torch.equal(results["guarded"][1], results["plain"][1])  # one draw, as plain
    w = "decoder_layer_4_1.0.weight"
    g_plain = dict(plain.named_parameters())[w].grad
    assert torch.allclose(dict(guarded.named_parameters())[w].grad, g_plain, **TOL)
    assert not torch.allclose(dict(naive.named_parameters())[w].grad, g_plain, **TOL)


def test_fused_recompute_is_counted_apart(monkeypatch):
    """On the fused trunk in bf16 the 13 kernel layers' wrapper runs again in
    the recompute, under ``fused_cbr.recomputing`` (on the card its launches
    add to ``launches_recompute`` too; here the plain version runs)."""
    seen = []
    real = fused_cbr._forward
    monkeypatch.setattr(fused_cbr, "_forward",
                        lambda *a: seen.append(fused_cbr.recomputing) or real(*a))
    model = _model(fused=True, compute_dtype="bfloat16", seed=6).train()
    x = torch.randn(BATCH, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(7))
    out = remat_forward(model, x)
    assert seen == [False] * 13
    sum(o.float().mean() for o in out).backward()
    assert seen == [False] * 13 + [True] * 13
    assert fused_cbr.recomputing is False


def test_check_supported_takes_remat():
    check_supported(_cfg(remat=True))


# ---------------------------------------------------------------------------
# (d) against the JAX remat step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_remat_step_matches_jax(trunk):
    fused = TRUNKS[trunk]
    model = _model(fused, seed=8)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = torch_state_dict_to_variables(sd)
    kw = dict(model_arch="UNet_B", selective=True, loss="BCElogit", s_lamb=2.0,
              compute_dtype="float32", batch_size=BATCH, patch_size=SIZE, lr=LR, remat=True)
    jcfg = JaxTrainConfig(**kw)
    tx = jax_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params))
    jstep = jax_train_step(jax_build_model("UNet_B", selective=True, compute_dtype="float32",
                                           fused=fused, fused_interpret=fused), jcfg, tx)
    cfg = TrainConfig(**kw)
    pstep = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    got, want = [], []
    for b in _batches(9, n=3):
        state, jm = jstep(state, {k: jnp.asarray(v.numpy()) for k, v in b.items()}, LR,
                          jax.random.PRNGKey(0))
        pm = pstep(b, LR)
        keys = ("loss", "aux_loss", "sel_loss", "coverage")
        want.append([float(jm[k]) for k in keys])
        got.append([float(pm[k]) for k in keys])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)  # same parameters
    np.testing.assert_allclose(got, want, **LOCK_TOL)
