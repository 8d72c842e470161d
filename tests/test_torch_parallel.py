"""The port's data-parallel semantics on the CPU, in one process.

(a) The global loss and coverage from per-rank sums: the port's losses run
    once a rank on each rank's rows, with ``all_reduce_sum`` simulated in
    process (each call returns the sum over the ranks of what they passed
    at that call), against the JAX package's loss jitted over its
    batch-sharded 8-device CPU mesh and its train step on that mesh; and a
    mean of per-rank losses is shown not to be the objective (the analog of
    the JAX tests/test_parallel.py:84-117).
(b) ``GroupedBatchNorm`` (``--bn_mode per_replica``) against the JAX
    ``GroupedBatchNorm`` at G = 2 and 3: forward, gradients, running
    statistics; and against the port's plain per-group loop.
(c) ``resolve_bn_groups``, ``resolve_fused``, ``make_mesh_dp_sp``,
    ``check_supported`` and ``build_model``'s refusals, each with its
    message, against the JAX functions where JAX has them.
(d) The collectives under a one-rank gloo group in this process
    (``all_reduce_sum``'s forward and backward, ``mean_gradients``,
    ``agree``, ``broadcast_flag``), global BatchNorm on it (the plain
    version against local BN; on a card, the native path against the plain
    version), ``initialize()``'s launcher rules, ``shard_apply``'s pad,
    split and gather, and ``replicas``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch.config import (
    EvalConfig, TrainConfig)
from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import (
    check_supported as eval_check_supported)
from selectivenet_for_semantic_segmentation_binary_torch.models import (
    BatchNorm2d, GroupedBatchNorm, build_model, grouped_batch_norm_reference, init_weights)
from selectivenet_for_semantic_segmentation_binary_torch.ops import losses
from selectivenet_for_semantic_segmentation_binary_torch.parallel import mesh as port_mesh
from selectivenet_for_semantic_segmentation_binary_torch.parallel import multihost
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
    _losses, check_supported, device_preprocess, resolve_bn_groups, resolve_fused)

RANKS = 8


# ---------------------------------------------------------------------------
# (a) global coverage from per-rank sums
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _patched_all_reduce(fn):
    saved = losses.all_reduce_sum
    losses.all_reduce_sum = fn
    try:
        yield
    finally:
        losses.all_reduce_sum = saved


def simulated_ranks(per_rank, n_ranks):
    """``[per_rank(r) for r in ranks]`` where each ``losses.all_reduce_sum``
    call returns the sum over the ranks of the tensors passed at that call:
    a first pass records every rank's sums, the second replays the totals."""
    recorded = [[] for _ in range(n_ranks)]
    for r in range(n_ranks):
        with _patched_all_reduce(lambda x, pg, r=r: recorded[r].append(x.detach()) or x):
            per_rank(r)
    totals = [sum(rec[i] for rec in recorded) for i in range(len(recorded[0]))]
    outs = []
    for r in range(n_ranks):
        calls = iter(range(len(totals)))
        with _patched_all_reduce(lambda x, pg: totals[next(calls)].clone()):
            outs.append(per_rank(r))
    return outs


def _risk_data(rng, n=16):
    """The JAX test's data: selection logits that vary wildly by sample, so
    that each rank's coverage differs."""
    out = rng.standard_normal((n, 8, 8)).astype(np.float32)
    sel = (rng.standard_normal((n, 8, 8)) * 4
           + np.linspace(-4, 4, n)[:, None, None]).astype(np.float32)
    y = (rng.random((n, 8, 8)) > 0.5).astype(np.float32)
    return out, sel, y


@pytest.fixture(scope="module")
def jax_mesh():
    from selectivenet_for_semantic_segmentation_binary_tpu.parallel import make_mesh

    m = make_mesh(RANKS)
    assert m.devices.size == RANKS, "needs the conftest's 8-device CPU mesh"
    return m


def test_per_rank_sums_give_the_sharded_jax_loss(jax_mesh):
    """selective_risk_b and the plain BCE from 8 ranks' sums == the JAX
    functions jitted over arrays sharded on the 8-device mesh (1e-6)."""
    from selectivenet_for_semantic_segmentation_binary_tpu.ops import (
        bce_with_logits as jax_bce, selective_risk_b as jax_risk)
    from selectivenet_for_semantic_segmentation_binary_tpu.parallel import batch_sharding

    out, sel, y = _risk_data(np.random.default_rng(0))
    s = batch_sharding(jax_mesh)
    put = lambda a: jax.device_put(a, s)  # noqa: E731
    want_loss, want_cov = jax.jit(jax_risk)(put(out), put(sel), put(y))
    want_bce = jax.jit(jax_bce)(put(out), put(y))
    per = len(out) // RANKS

    def rank(r):
        rows = slice(r * per, (r + 1) * per)
        o, g, t = (torch.from_numpy(a[rows]) for a in (out, sel, y))
        loss, cov = losses.selective_risk_b(o, g, t, pg=object())
        return loss, cov, losses.bce_with_logits(o, t, pg=object())

    got = simulated_ranks(rank, RANKS)
    for loss, cov, bce in got:  # every rank holds the same global values
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
        assert float(cov) == pytest.approx(float(want_cov), rel=1e-6)
        assert float(bce) == pytest.approx(float(want_bce), rel=1e-6)


def test_per_rank_average_is_not_the_objective():
    """A mean of per-rank selective losses is another objective when the
    coverage varies (JAX test_per_shard_average_is_not_the_objective)."""
    out, sel, y = _risk_data(np.random.default_rng(0))
    t = [torch.from_numpy(a) for a in (out, sel, y)]
    global_loss = float(losses.selective_risk_b(*t)[0])
    per = len(out) // RANKS
    shard_mean = np.mean([float(losses.selective_risk_b(*(a[r * per:(r + 1) * per]
                                                          for a in t))[0])
                          for r in range(RANKS)])
    assert shard_mean != pytest.approx(global_loss, rel=1e-3)


def test_train_step_loss_from_per_rank_sums_matches_jax_mesh_step(jax_mesh):
    """The JAX train step over the 8-device mesh against the port: the
    model's train-mode forward on the whole batch (the global BatchNorm of
    a fleet), then ``train_lib._losses`` once a rank on its row, the sums
    summed over the simulated ranks; loss, its terms and coverage to 1e-6
    (the same weights: step 0)."""
    from selectivenet_for_semantic_segmentation_binary_tpu.config import (
        TrainConfig as JaxTrainConfig)
    from selectivenet_for_semantic_segmentation_binary_tpu.models import (
        build_model as jax_build_model)
    from selectivenet_for_semantic_segmentation_binary_tpu.optim import (
        build_optimizer as jax_optimizer)
    from selectivenet_for_semantic_segmentation_binary_tpu.parallel import replicate, shard_batch
    from selectivenet_for_semantic_segmentation_binary_tpu.train_lib import (
        TrainState, make_train_step as jax_train_step)
    from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
        torch_state_dict_to_variables)

    kw = dict(model_arch="UNet_B", selective=True, loss="BCElogit", s_lamb=2.0,
              compute_dtype="float32", batch_size=RANKS, patch_size=32)
    model = build_model("UNet_B", selective=True)
    init_weights(model, torch.Generator().manual_seed(5))
    variables = torch_state_dict_to_variables(
        {k: v.numpy().copy() for k, v in model.state_dict().items()
         if not k.endswith("num_batches_tracked")})
    rng = np.random.default_rng(6)
    batch = {"input": rng.integers(0, 256, (RANKS, 32, 32, 3), dtype=np.uint8),
             "label": (rng.random((RANKS, 32, 32)) > 0.5).astype(np.uint8),
             "flips": rng.integers(0, 2, (RANKS, 2)).astype(np.uint8)}

    jcfg = JaxTrainConfig(**kw)
    tx = jax_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(params=params, batch_stats=jax.tree_util.tree_map(
        jnp.asarray, variables["batch_stats"]), opt_state=tx.init(params))
    _, want = jax_train_step(jax_build_model("UNet_B", selective=True,
                                             compute_dtype="float32"), jcfg, tx)(
        replicate(state, jax_mesh), shard_batch(batch, jax_mesh), 1e-3, jax.random.PRNGKey(0))

    cfg = TrainConfig(**kw)
    x, label = device_preprocess({k: torch.from_numpy(v) for k, v in batch.items()})
    model.train()
    with torch.no_grad():
        outputs = model(x)
    target = label.float()

    def rank(r):
        rows = slice(r, r + 1)
        loss, extras, _, _ = _losses(cfg, tuple(o[rows] for o in outputs), target[rows],
                                     pg=object())
        return {"loss": loss, **extras}

    for got in simulated_ranks(rank, RANKS):
        for k in ("loss", "aux_loss", "sel_loss", "coverage"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


# ---------------------------------------------------------------------------
# (b) GroupedBatchNorm against JAX's
# ---------------------------------------------------------------------------

def _jax_grouped(groups, x, scale, bias, mean, var):
    from selectivenet_for_semantic_segmentation_binary_tpu.models.unet import (
        GroupedBatchNorm as JaxGroupedBatchNorm)

    m = JaxGroupedBatchNorm(groups=groups, dtype=jnp.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}

    def f(p, xx):
        y, mut = m.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                         use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * jnp.cos(y)), (y, mut["batch_stats"])

    (_, (y, stats)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    return y, stats, grads


@pytest.mark.parametrize("groups", [2, 3])
def test_grouped_batch_norm_matches_jax(groups):
    """Forward and gradients (1e-5), running statistics (1e-6): group 0's
    mean and UNBIASED variance, momentum 0.1 (flax 0.9)."""
    rng = np.random.default_rng(groups)
    n, c = 2 * groups, 5
    x = (rng.standard_normal((n, 6, 6, c)) * 2 + 1.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    mean = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jy, jstats, (jg_params, jg_x) = _jax_grouped(groups, x, scale, bias, mean, var)

    bn = GroupedBatchNorm(c, groups).train()
    with torch.no_grad():
        for name, a in (("weight", scale), ("bias", bias), ("running_mean", mean),
                        ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(a))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    y = bn(xt)
    (y * torch.cos(y)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg_x), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jg_params["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jg_params["bias"]), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jstats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jstats["var"]), atol=1e-6)

    # the port's plain per-group loop on the same input
    ry, rmean, rvar = grouped_batch_norm_reference(
        xt.detach(), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(mean), torch.from_numpy(var), groups)
    np.testing.assert_allclose(y.detach().numpy(), ry.numpy(), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), rmean.numpy(), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), rvar.numpy(), atol=1e-6)


def test_grouped_batch_norm_refusals_and_eval_mode():
    bn = GroupedBatchNorm(3, 3).train()
    with pytest.raises(ValueError, match=r"batch size \(4\) divisible by the replica count \(3\)"):
        bn(torch.zeros(4, 3, 4, 4))
    with pytest.raises(ValueError, match="bn_groups must be >= 1"):
        GroupedBatchNorm(3, 0)
    # eval mode is BatchNorm2d's: running statistics, same state dict
    plain = BatchNorm2d(3)
    assert set(bn.state_dict()) == set(plain.state_dict())
    x = torch.randn(4, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(bn.eval()(x), plain.eval()(x), rtol=0, atol=0)


def test_per_replica_model_state_dict_is_the_global_one():
    g = build_model("UNet_B", selective=True)
    p = build_model("UNet_B", selective=True, bn_mode="per_replica", bn_groups=4)
    assert list(g.state_dict()) == list(p.state_dict())
    assert sum(isinstance(m, GroupedBatchNorm) for m in p.modules()) == 14


# ---------------------------------------------------------------------------
# (c) the resolvers and refusals, with their messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bn_mode, replicas, batch, world", [
    ("global", 0, 16, 1), ("per_replica", 0, 16, 1), ("per_replica", 0, 16, 4),
    ("per_replica", 8, 128, 1), ("per_replica", 3, 16, 1), ("per_replica", 0, 6, 4),
    ("per_replica", -2, 16, 1),
], ids=lambda v: str(v))
def test_resolve_bn_groups_matches_jax(bn_mode, replicas, batch, world):
    from selectivenet_for_semantic_segmentation_binary_tpu.config import (
        TrainConfig as JaxTrainConfig)
    from selectivenet_for_semantic_segmentation_binary_tpu.parallel import make_mesh
    from selectivenet_for_semantic_segmentation_binary_tpu.train_lib import (
        resolve_bn_groups as jax_resolve)

    kw = dict(bn_mode=bn_mode, bn_replicas=replicas, batch_size=batch)
    try:
        want = jax_resolve(JaxTrainConfig(**kw), make_mesh(world))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_bn_groups(TrainConfig(**kw), world)
        assert str(got.value) == str(e)
        return
    assert resolve_bn_groups(TrainConfig(**kw), world) == want


def test_refusals_name_their_roadmap_item_and_jax_reason():
    """``--sp_ways`` (A9) is ported: the config checks take it, and one
    process, one rank, refuses it with JAX's message for one device
    (tests/test_torch_spatial_train.py runs it on four ranks)."""
    check_supported(TrainConfig(sp_ways=2))
    eval_check_supported(EvalConfig(sp_ways=2))
    with pytest.raises(ValueError, match=r"^sp_ways 2 must divide the device count 1$"):
        port_mesh.make_mesh_dp_sp(None, 2, 16, 256)
    # several ranks and no spatial sharding pass
    check_supported(TrainConfig(local_rank=[0, 1, 2, 3], bn_mode="per_replica"))
    eval_check_supported(EvalConfig(local_rank=[0, 1]))
    assert port_mesh.make_mesh_dp_sp(4, 1, 16, 256) == port_mesh.Grid(1, 1)  # one rank
    with pytest.raises(ValueError, match="single-chip only"):
        resolve_fused(TrainConfig(fused_cbr="on"), torch.device("cuda"), world=2)
    with pytest.raises(ValueError, match="requires a CUDA device"):
        resolve_fused(TrainConfig(fused_cbr="on"), torch.device("cpu"), world=2)


@pytest.mark.parametrize("kw", [
    dict(bn_mode="per_replica", fused=True),
    dict(bn_mode="per_replica", bn_stats="bfloat16"),
    dict(bn_mode="per_replica", bn_groups=0),
    dict(bn_mode="bogus"),
], ids=["fused", "bf16_stats", "groups0", "unknown"])
def test_build_model_refusals_match_jax(kw):
    from selectivenet_for_semantic_segmentation_binary_tpu.models import (
        build_model as jax_build_model)

    with pytest.raises(ValueError) as want:
        jax_build_model("UNet_B", **kw)
    with pytest.raises(ValueError) as got:
        build_model("UNet_B", **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# (d) the collectives, initialize() and shard_apply
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo group of one rank in this process, left again afterwards."""
    multihost.initialize(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0,
                         backend="gloo")
    try:
        yield multihost.group()
    finally:
        multihost.shutdown()
    assert multihost.group() is None


def test_collectives_on_a_one_rank_group(one_rank_group):
    pg = one_rank_group
    assert multihost.process_info() == (0, 1) and multihost.is_writer()
    x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    y = port_mesh.all_reduce_sum(x * 2.0, pg)
    (y * torch.tensor([1.0, 10.0, 100.0])).sum().backward()
    assert y.tolist() == [2.0, 4.0, 6.0] and x.grad.tolist() == [2.0, 20.0, 200.0]
    lin = torch.nn.Linear(3, 2)
    lin(torch.ones(4, 3)).sum().backward()
    before = [p.grad.clone() for p in lin.parameters()]
    port_mesh.mean_gradients(list(lin.parameters()), pg)
    for b, p in zip(before, lin.parameters()):
        assert torch.equal(b, p.grad)  # one rank: the mean is the gradient, exactly
    assert multihost.agree(True) and not multihost.agree(False)
    assert multihost.broadcast_flag(True) and not multihost.broadcast_flag(False)
    multihost.barrier()
    counts = torch.tensor([3, 4], dtype=torch.int64)
    assert port_mesh.all_reduce_(counts, pg, "max").tolist() == [3, 4]


def test_without_a_group_the_helpers_are_one_process():
    assert multihost.group() is None and multihost.process_info() == (0, 1)
    x = torch.ones(2)
    assert port_mesh.all_reduce_sum(x, None) is x
    assert multihost.agree(False) is False and multihost.broadcast_flag(True) is True


_LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                  "SLURM_NTASKS", "SLURM_PROCID", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


@pytest.mark.parametrize("env, joins", [
    ({}, False), ({"SLURM_NTASKS": "1"}, False), ({"OMPI_COMM_WORLD_SIZE": "1"}, False),
    ({"WORLD_SIZE": "2", "RANK": "0"}, True), ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1"}, True),
    ({"OMPI_COMM_WORLD_SIZE": "4"}, True), ({"PMI_SIZE": "2"}, True),
], ids=["none", "slurm1", "mpi1", "torchrun", "slurm2", "ompi4", "pmi2"])
def test_initialize_joins_only_under_a_launcher_and_never_degrades(env, joins, monkeypatch):
    """No launcher: a no-op. A launcher's fleet without its rendezvous
    (``MASTER_ADDR`` missing here) raises instead of running alone."""
    for k in _LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if not joins:
        multihost.initialize()
        assert multihost.group() is None
        return
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.initialize(backend="gloo")
    assert multihost.group() is None


def test_shard_apply_pads_splits_and_gathers():
    """Two CPU entries: 5 rows padded to 6 with the last row, 3 a card, each
    part through its own function, gathered and cut back to 5."""
    cpu = torch.device("cpu")
    mesh = port_mesh.Mesh((cpu, cpu))
    seen = []

    def fn(tag):
        def run(x):
            seen.append((tag, x.clone()))
            return x * 2.0, x.sum((1, 2)) + tag
        return run

    x = torch.arange(5 * 2 * 2, dtype=torch.float32).reshape(5, 2, 2)
    a, b = port_mesh.shard_apply([fn(0), fn(100)], x, mesh)
    assert [t for t, _ in seen] == [0, 100]
    torch.testing.assert_close(seen[0][1], x[:3])
    torch.testing.assert_close(seen[1][1], torch.cat([x[3:], x[4:]]))  # the padded row
    torch.testing.assert_close(a, x * 2.0)
    torch.testing.assert_close(b, x.sum((1, 2)) + torch.tensor([0, 0, 0, 100, 100.0]))
    one = port_mesh.Mesh((cpu,))
    torch.testing.assert_close(port_mesh.shard_apply([lambda t: t + 1], x, one), x + 1)
    assert port_mesh.make_mesh(8, device="cpu").devices == (cpu,)


def test_replicas_share_the_model_on_its_device_and_copy_once():
    """The model itself on its own device; a copy elsewhere (the meta device
    stands in for a second card), made once where a cache is given."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    model = torch.nn.Linear(3, 2)
    assert port_mesh.replicas(model, cpu, port_mesh.Mesh((cpu, cpu))) == [model, model]
    cache = {}
    first = port_mesh.replicas(model, cpu, port_mesh.Mesh((cpu, meta)), cache)
    again = port_mesh.replicas(model, cpu, port_mesh.Mesh((cpu, meta)), cache)
    assert first[0] is model and first[1] is again[1] is cache[meta]
    assert first[1].weight.device == meta and model.weight.device == cpu


def _bn_runs(fn, x, w, b):
    xi, wi, bi = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    y, mean, var = fn(xi, wi, bi)
    y.backward(torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape).to(y.dtype))
    return {"y": y, "mean": mean, "var": var, "dx": xi.grad, "dw": wi.grad, "db": bi.grad}


def _bn_inputs(device):
    g = torch.Generator().manual_seed(5)
    x = (torch.randn((4, 6, 5, 7), generator=g) * 2 + 0.5).to(device)
    return (x.contiguous(memory_format=torch.channels_last),
            (torch.rand(6, generator=g) + 0.5).to(device), torch.randn(6, generator=g).to(device))


def test_global_batch_norm_on_one_rank_is_local_batch_norm(one_rank_group):
    """On the CPU ``global_batch_norm`` is its plain version; over a group of
    one rank it is BatchNorm of the rank's batch with the biased variance."""
    from selectivenet_for_semantic_segmentation_binary_torch.models import unet

    x, w, b = _bn_inputs("cpu")
    got = _bn_runs(lambda *t: unet.global_batch_norm(*t, 1e-5, one_rank_group), x, w, b)

    def local(xi, wi, bi):
        y, mean, invstd = torch.native_batch_norm(xi, wi, bi, None, None, True, 0.0, 1e-5)
        return y, mean, x.var((0, 2, 3), unbiased=False)

    want = _bn_runs(local, x, w, b)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, msg=k)


def test_global_batch_norm_native_path_equals_plain_version(one_rank_group):
    """On a card, the native sync-BatchNorm path against the plain version,
    both over the one-rank gloo group (CUDA tensors): output, statistics and
    gradients, float32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the native sync-BatchNorm kernels have no CPU "
                    "version (chip_smoke.py phase 21(a) holds them on the card)")
    from selectivenet_for_semantic_segmentation_binary_torch.models import unet

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)):
        x, w, b = _bn_inputs("cuda")
        x = x.to(dtype)
        got = _bn_runs(lambda *t: unet._GlobalBatchNorm.apply(*t, 1e-5, one_rank_group),
                       x, w, b)
        want = _bn_runs(lambda *t: unet.global_batch_norm_reference(*t, 1e-5, one_rank_group),
                        x, w, b)
        for k in want:
            torch.testing.assert_close(got[k].float(), want[k].float(), rtol=tol, atol=tol,
                                       msg=f"{dtype} {k}")


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_mesh.make_mesh()
