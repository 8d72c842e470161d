"""``--sp_ways`` training and evaluation (ROADMAP A9b), and QAT's global
activation scale on a fleet, on the CPU: a fleet of four gloo processes
against one process and the JAX package.

The fleet is four processes running this file as a worker, joined through
a ``file://`` store under the test's ``tmp_path`` and killed together past
their timeout, as tests/test_torch_fleet.py runs its two. With ``--sp_ways
2`` the four ranks are JAX ``make_mesh_dp_sp(4, 2, ...)``'s (dp 2, sp 2)
layout: rank r holds rows block ``r % 2`` of the examples of data-parallel
group ``r // 2``. The data tree has 2 slides of 12 patches of 32x32: at
``--batch_size 8`` one step an epoch.

* ``train()`` for 2 epochs from carried weights: losses, terms and
  coverage, and step 1's BN running statistics and every step's
  variances, against one process within ``FLEET_TOL`` (rtol 1e-3, atol
  1e-5; step 1's loss to 1e-5), and the epochs' losses against the JAX
  package's ``train()`` on its (dp 2, sp 2) mesh (JAX's own bound, rel
  1e-3, tests/test_spatial_train.py); ``evaluate()`` of its checkpoint
  with ``--sp_ways 2`` against one process (the counts) and JAX's
  ``evaluate()`` on its (2, 2) mesh (accuracy and mIoU 2e-3, confusion
  counts atol 64);
* ``--remat`` with dropout, ``--bn_mode per_replica`` and ``--train_quant
  int8`` (K10's plain version on the halo'd blocks) under ``--sp_ways 2``,
  one epoch each, against one process; ``evaluate()`` with ``--quantize
  int8`` under ``--sp_ways 2`` against one process;
* one CBR under the sp groups, with float32 and with bf16 BN statistics:
  outputs, input gradients (the halo's backward) and parameter gradients of
  one process's CBR on the whole input;
* QAT's activation scale on a fleet of two ranks (a group of ranks 0 and
  1; rank 1 holds the absmax): a ``QATCBR``'s train-mode forward and
  gradients against one process and JAX ``_qat_fwd_math`` on the whole
  batch, and a ``--train_quant int8`` step against one process, step 1's
  loss to 1e-5 (each rank's own absmax, the fault this pins, misses both);
* in this process: each rank's loader rows with up-down flips, after the
  device's flips, bit-equal to one process's flipped batch; the dp/sp
  checks and the rank layout against JAX's.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch.config import EvalConfig, TrainConfig
from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import evaluate
from selectivenet_for_semantic_segmentation_binary_torch.models import (
    CBR, QATCBR, build_model, init_weights, set_process_group)
from selectivenet_for_semantic_segmentation_binary_torch.parallel import multihost
from selectivenet_for_semantic_segmentation_binary_torch.parallel.mesh import (
    Grid, dp_sp_ways, make_mesh_dp_sp)
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import train

SIZE, BATCH, EPOCHS, WORLD, SP = 32, 8, 2, 4, 2
FLEET_TOL = dict(rtol=1e-3, atol=1e-5)  # JAX's fleet tolerance, tests/test_multihost.py:91-96
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
STE_TOL = dict(rtol=2e-2, atol=2e-2)  # the QAT backward's bf16 convs (tests/test_torch_qat.py)
# QAT's BN statistics: a float32 sum taken in another order moves activations
# across int8 rounding boundaries, one quantization step each, and the steps
# add up layer after layer: one process on 1 and on 8 threads leaves step 1's
# running means up to 3.8e-4 apart (so do fleets of 4 ranks, sp 1 or 2)
QAT_STATS_TOL = dict(rtol=1e-3, atol=1e-3)
FLEET_TIMEOUT = 300
# evaluate() with --sp_ways 2: the float model, and the W8A8 trunk (K10's plain
# version on the halo'd blocks) calibrated on the test fold's first 4 patches
EVALS = {"eval": {}, "eval_int8": dict(quantize="int8", calib_patches=4)}
# one CBR under the sp groups: float32 BN, and --bn_stats bfloat16's, whose
# summed statistics are rounded to bf16 after the all-reduce where one process
# rounds one sum: a mean one bf16 ulp apart moves its outputs by up to ~1e-2
# (tests/test_torch_fleet.py's atol for it), and its parameter gradients, sums
# over every pixel, by as much of their largest magnitude
CBR_STATS = {"float32": LAYER_TOL, "bfloat16": dict(rtol=0, atol=2e-2)}


def _train_cfg(data_dir, model_dir, **kw):
    base = dict(data_dir=data_dir, model_dir=model_dir, fold=1, patch_size=SIZE,
                batch_size=BATCH, n_epoch=EPOCHS, model_arch="UNet_B", loss="BCElogit",
                selective=True, s_lamb=2.0, compute_dtype="float32", num_workers=2)
    base.update(kw)
    return TrainConfig(**base)


def _eval_cfg(data_dir, model_dir, **kw):
    # select_eval 0: after 2 steps the selection head may still reject every
    # pixel (JAX tests/test_spatial_train.py's reason)
    base = dict(data_dir=data_dir, test_fold=1, model_dir=model_dir, model_arch=["UNet_B"],
                selective=True, select_eval=False, batch_size=BATCH, patch_size=SIZE,
                compute_dtype="float32", num_workers=2)
    base.update(kw)
    return EvalConfig(**base)


def _seeded(model_dir, seed_pth):
    """A model_dir whose checkpoint dir holds the carried weights as epoch 0."""
    ckpt_dir = os.path.join(model_dir, "1-fold", "checkpoint")
    os.makedirs(ckpt_dir, exist_ok=True)
    os.link(seed_pth, os.path.join(ckpt_dir, "model_epoch0.pth"))
    return model_dir


def _stats(model):
    return {k: v.numpy().tolist() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _train(cfg):
    """train() on the CPU, with the BN running statistics each step's
    train-mode forward left (``result["steps"]``)."""
    from selectivenet_for_semantic_segmentation_binary_torch.models import UNetB

    steps = []

    def after(module, args, output):  # not --remat's recompute, whose BNs are frozen
        if (isinstance(module, UNetB) and module.training
                and not module.encoder_layer_1_1[1].frozen):
            steps.append(_stats(module))

    hook = torch.nn.modules.module.register_module_forward_hook(after)
    try:
        result = train(cfg, verbose=False, device="cpu")
    finally:
        hook.remove()
    return {"history": [{"loss": tr.per_step["loss"].tolist(),
                         "coverage": tr.per_step["coverage"].tolist(),
                         "aux_loss": tr.aux_loss, "sel_loss": tr.sel_loss,
                         "valid_loss": va.loss} for _, tr, va in result["history"]],
            "steps": steps, "stats": _stats(result["model"])}


def _counts(results):
    return {"cm": np.asarray(results["confusion_matrix"]).tolist(),
            "accuracy": results["accuracy"], "mIoU": results["mIoU"]}


# ---------------------------------------------------------------------------
# layers: one CBR under the sp groups, and QAT's activation scale
# ---------------------------------------------------------------------------

def _cbr_input(bn_stats="float32"):
    """4 examples of 16 rows: a CBR (5 -> 6 channels) and its input."""
    g = torch.Generator().manual_seed(21)
    x = torch.randn(4, 5, 16, 8, generator=g).to(memory_format=torch.channels_last)
    layer = CBR(5, 6, bn_stats=bn_stats).train()
    init_weights(layer, g)
    return x, layer


def _qat_input():
    """4 examples of 8x8, 4 -> 8 channels; rows 2-3 (rank 1's) three times
    as large, so that the absmax lies on rank 1."""
    g = torch.Generator().manual_seed(22)
    x = torch.randn(4, 4, 8, 8, generator=g)
    x[2:] *= 3.0
    layer = QATCBR(4, 8, torch.float32).train()
    init_weights(layer, g)
    return x.to(memory_format=torch.channels_last), layer


def _layer_run(x, layer, rows=slice(None), cols=slice(None)):
    """``layer`` on ``x[rows, :, cols]``: its output, the input's gradient,
    the conv weight's and the BN scale's gradients and the running
    statistics (the gradient of the conv bias before a BN is 0 in exact
    arithmetic: rounding noise, not compared)."""
    xr = x[rows, :, cols].clone().requires_grad_(True)
    y = layer(xr)
    (y * torch.cos(y)).sum().backward()
    bn = layer[1]
    return {"y": y.detach().tolist(), "x_grad": xr.grad.tolist(),
            "w_grad": layer[0].weight.grad.tolist(), "bn_w_grad": bn.weight.grad.tolist(),
            **{k: getattr(bn, k).tolist() for k in ("running_mean", "running_var")}}


def _qat_step_inputs():
    g = np.random.default_rng(23)
    batch = {"input": torch.from_numpy(g.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)),
             "label": torch.from_numpy((g.random((4, 16, 16)) > 0.5).astype(np.uint8))}
    model = build_model("UNet_B", selective=True, train_quant="int8")
    init_weights(model, torch.Generator().manual_seed(24))
    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", batch_size=4,
                      patch_size=16, compute_dtype="float32", train_quant="int8")
    return batch, model, cfg


def _qat_step(pg=None, rows=slice(None)):
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_train_step

    batch, model, cfg = _qat_step_inputs()
    set_process_group(model, pg)
    step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()), pg)
    metrics = step({k: v[rows] for k, v in batch.items()}, cfg.lr)
    return {k: float(metrics[k]) for k in ("loss", "aux_loss", "sel_loss", "coverage")}


# ---------------------------------------------------------------------------
# the worker: one rank of the fleet
# ---------------------------------------------------------------------------

def _worker(rank: int, store: str, root: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    multihost.initialize(init_method=f"file://{store}", world_size=WORLD, rank=rank,
                         backend="gloo")
    out = {"rank": rank}
    # QAT on a fleet of two: ranks 0 and 1 (every rank makes the group)
    pair = dist.new_group([0, 1])
    if rank < 2:
        x, layer = _qat_input()
        set_process_group(layer, pair)
        out["qat_layer"] = _layer_run(x, layer, slice(2 * rank, 2 * rank + 2))
        out["qat_step"] = _qat_step(pair, slice(2 * rank, 2 * rank + 2))
    multihost.barrier()

    grid = make_mesh_dp_sp(None, SP, BATCH, SIZE)
    out["grid"] = [grid.dp, grid.sp, grid.dp_index, grid.sp_index]
    for bn_stats in CBR_STATS:
        x, layer = _cbr_input(bn_stats)
        set_process_group(layer, multihost.group(), grid.sp_group)
        out[f"cbr_{bn_stats}"] = _layer_run(x, layer,
                                            slice(2 * grid.dp_index, 2 * grid.dp_index + 2),
                                            slice(8 * grid.sp_index, 8 * grid.sp_index + 8))

    data, seed = os.path.join(root, "data"), os.path.join(root, "seed.pth")
    runs = {"sp": dict(n_epoch=EPOCHS),
            "remat": dict(n_epoch=1, remat=True, dropout_rate=0.3),
            "per_replica": dict(n_epoch=1, bn_mode="per_replica"),
            "qat": dict(n_epoch=1, train_quant="int8")}
    for name, kw in runs.items():
        model_dir = os.path.join(root, f"fleet_{name}")
        if rank == 0:
            _seeded(model_dir, seed)
        multihost.barrier()
        out[name] = _train(_train_cfg(data, model_dir, sp_ways=SP, **kw))

    eval_dir = os.path.join(root, "fleet_eval")
    if rank == 0:
        os.makedirs(eval_dir)
        os.link(os.path.join(root, "fleet_sp", "1-fold", "checkpoint", "model_epoch2.pth"),
                os.path.join(eval_dir, "model_epoch2.pth"))
    multihost.barrier()
    for name, kw in EVALS.items():
        out[name] = _counts(evaluate(_eval_cfg(data, eval_dir, sp_ways=SP, **kw),
                                     verbose=False, device="cpu"))
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()


def _communicate_all(procs, timeout: float = FLEET_TIMEOUT):
    """communicate() with every rank, killing the whole fleet on a timeout."""
    try:
        return [p.communicate(timeout=timeout)[0].decode() for p in procs]
    except BaseException:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise


def _run_fleet(root: str) -> list:
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    store = os.path.join(root, "store")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "worker", str(r),
                               store, root],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    logs = _communicate_all(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-3000:]}"
    results = []
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        write_synthetic_patch_tree)

    root = str(tmp_path_factory.mktemp("torch_spatial_train"))
    data = os.path.join(root, "data")
    write_synthetic_patch_tree(data, n_slides=2, patches_per_slide=12, patch_size=SIZE)
    model = build_model("UNet_B", selective=True)
    init_weights(model, torch.Generator().manual_seed(3))
    seed = os.path.join(root, "seed.pth")
    torch.save({"net": model.state_dict()}, seed)
    fleet = _run_fleet(root)

    single = {}
    for name, kw in {"sp": dict(n_epoch=EPOCHS), "remat": dict(n_epoch=1, dropout_rate=0.3),
                     "per_replica": dict(n_epoch=1, bn_mode="per_replica", bn_replicas=WORLD),
                     "qat": dict(n_epoch=1, train_quant="int8")}.items():
        single[name] = _train(_train_cfg(data, _seeded(os.path.join(root, f"one_{name}"), seed),
                                         **kw))
    for name, kw in EVALS.items():
        single[name] = _counts(evaluate(_eval_cfg(data, os.path.join(root, "fleet_eval"), **kw),
                                        verbose=False, device="cpu"))
    for bn_stats in CBR_STATS:
        x, layer = _cbr_input(bn_stats)
        single[f"cbr_{bn_stats}"] = _layer_run(x, layer)
    x, layer = _qat_input()
    single["qat_layer"] = _layer_run(x, layer)
    single["qat_step"] = _qat_step()
    return {"root": root, "data": data, "seed": seed, "fleet": fleet, "single": single}


def _history_close(got, want, tol=FLEET_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **tol, err_msg=k)


@pytest.mark.parametrize("run", ["sp", "remat", "per_replica", "qat"])
def test_sp_train_matches_one_process(runs, run):
    """Every rank's losses, terms and coverage, step 1's BN running
    statistics and every step's running variances against one process
    (after step 1 Adam's first step moves each parameter whose gradient is
    rounding noise by up to lr, and the running means near 0 follow: see
    tests/test_torch_fleet.py); step 1's loss to 1e-5; the ranks' final
    statistics equal. Under QAT a sum taken in another order moves
    activations across int8 rounding boundaries: its step 1 is held to
    ``FLEET_TOL`` and its statistics to ``QAT_STATS_TOL``."""
    want = runs["single"][run]
    for rank in runs["fleet"]:
        got = rank[run]
        _history_close(got["history"], want["history"])
        if run != "qat":
            np.testing.assert_allclose(got["history"][0]["loss"][0],
                                       want["history"][0]["loss"][0], rtol=1e-5)
        assert len(got["steps"]) == len(want["steps"]) == len(want["history"])
        tol = QAT_STATS_TOL if run == "qat" else FLEET_TOL
        for s, (g, w) in enumerate(zip(got["steps"], want["steps"]), 1):
            for k, v in w.items():
                if s == 1 or k.endswith("running_var"):
                    np.testing.assert_allclose(g[k], v, **tol, err_msg=f"step {s}: {k}")
        assert got["stats"] == runs["fleet"][0][run]["stats"]


def test_sp_train_matches_jax_train(runs, tmp_path):
    """The JAX package's ``train()`` with ``--sp_ways 2`` on 4 of its 8
    virtual devices, (dp 2, sp 2), from the same ``.pth``: its epochs'
    TensorBoard losses against the fleet's (JAX's bound, rel 1e-3)."""
    from selectivenet_for_semantic_segmentation_binary_tpu.config import (
        TrainConfig as JaxTrainConfig)
    from selectivenet_for_semantic_segmentation_binary_tpu.train_lib import train as jax_train
    from selectivenet_for_semantic_segmentation_binary_torch.utils.tb_reader import read_scalars

    model_dir = _seeded(str(tmp_path), runs["seed"])
    fields = {f.name for f in dataclasses.fields(JaxTrainConfig)}
    kw = {k: v for k, v in vars(_train_cfg(runs["data"], model_dir, sp_ways=SP,
                                           local_rank=list(range(WORLD)))).items()
          if k in fields}
    jax_train(JaxTrainConfig(**kw), verbose=False)
    log = os.path.join(model_dir, "1-fold", "log")
    fleet = runs["fleet"][0]["sp"]["history"]
    for key, (split, tag) in {"loss": ("train", "loss"), "aux_loss": ("train", "aux loss"),
                              "sel_loss": ("train", "selection loss"),
                              "valid_loss": ("valid", "loss")}.items():
        want = [v for _, v in read_scalars(os.path.join(log, split))[tag]]
        got = [np.mean(e[key]) for e in fleet]
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("case", list(EVALS))
def test_sp_evaluate_matches_one_process(runs, case):
    """``evaluate()`` with ``--sp_ways 2`` of the fleet's checkpoint, float
    and ``--quantize int8``: one process's counts within 1e-3 of the pixels
    (the forward differs by float reduction order only)."""
    want = runs["single"][case]
    total = np.sum(want["cm"])
    for rank in runs["fleet"]:
        got = rank[case]
        assert np.abs(np.asarray(got["cm"]) - np.asarray(want["cm"])).sum() <= 1e-3 * total
        np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)


def test_sp_evaluate_matches_jax(runs):
    """JAX's ``evaluate()`` with ``--sp_ways 2`` on its (2, 2) mesh, the same
    checkpoint: the fleet's scores within JAX's bounds
    (tests/test_spatial_train.py: accuracy and mIoU 2e-3, counts atol 64)."""
    from selectivenet_for_semantic_segmentation_binary_tpu.config import (
        EvalConfig as JaxEvalConfig)
    from selectivenet_for_semantic_segmentation_binary_tpu.eval_lib import (
        evaluate as jax_evaluate)

    fields = {f.name for f in dataclasses.fields(JaxEvalConfig)}
    cfg = _eval_cfg(runs["data"], os.path.join(runs["root"], "fleet_eval"), sp_ways=SP,
                    local_rank=list(range(WORLD)))
    jax_res = jax_evaluate(JaxEvalConfig(**{k: v for k, v in vars(cfg).items() if k in fields}),
                           verbose=False)
    got = runs["fleet"][0]["eval"]
    assert np.isfinite(got["accuracy"])
    assert got["accuracy"] == pytest.approx(jax_res["accuracy"], abs=2e-3)
    assert got["mIoU"] == pytest.approx(jax_res["mIoU"], abs=2e-3)
    np.testing.assert_allclose(got["cm"], jax_res["confusion_matrix"], atol=64)


def _blocks(rank_values, key):
    """The four ranks' (2 examples x 8 rows) blocks of ``key`` put back in
    their places of the (4, C, 16, W) whole."""
    rows = []
    for d in range(2):
        rows.append(np.concatenate([np.asarray(rank_values[2 * d + s][key])
                                    for s in range(2)], axis=2))
    return np.concatenate(rows)


@pytest.mark.parametrize("bn_stats", list(CBR_STATS))
def test_cbr_halo_exchange_gradients(runs, bn_stats):
    """One CBR under the (dp 2, sp 2) groups, float32 and bf16 BN
    statistics: the ranks' outputs and input gradients are one process's
    blocks (the halo rows' gradients reach their owners), their parameter
    gradients sum to one process's, and each rank holds its running
    statistics; the ranks sit at JAX ``make_mesh_2d``'s row-major places."""
    fleet = [r[f"cbr_{bn_stats}"] for r in runs["fleet"]]
    want, tol = runs["single"][f"cbr_{bn_stats}"], CBR_STATS[bn_stats]
    assert [r["grid"] for r in runs["fleet"]] == [[2, 2, r // 2, r % 2] for r in range(4)]
    for k in ("y", "x_grad"):
        np.testing.assert_allclose(_blocks(fleet, k), want[k], **tol, err_msg=k)
    for k in ("w_grad", "bn_w_grad"):
        scale = 1.0 if bn_stats == "float32" else max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(np.sum([r[k] for r in fleet], 0), want[k], rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, err_msg=k)
    for r in fleet:
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[k], want[k], **tol, err_msg=k)


def test_qat_scale_is_global_on_a_fleet(runs):
    """Two ranks' ``QATCBR`` in train mode (rank 1 holds the absmax): their
    outputs and gradients are one process's, whose forward is JAX
    ``_qat_fwd_math`` on the whole batch with the conv's bias, flax's
    train-mode BatchNorm and ReLU; and a ``--train_quant int8`` step's loss
    and terms on the two ranks are one process's (step 1 to 1e-5)."""
    from selectivenet_for_semantic_segmentation_binary_tpu.models.unet import _qat_fwd_math

    fleet = [r for r in runs["fleet"] if "qat_layer" in r]
    assert len(fleet) == 2
    want = runs["single"]["qat_layer"]
    np.testing.assert_allclose(np.concatenate([np.asarray(r["qat_layer"]["y"]) for r in fleet]),
                               want["y"], **LAYER_TOL)
    np.testing.assert_allclose(np.concatenate([np.asarray(r["qat_layer"]["x_grad"])
                                               for r in fleet]), want["x_grad"], **STE_TOL)
    for k, tol in (("w_grad", STE_TOL), ("bn_w_grad", LAYER_TOL)):
        np.testing.assert_allclose(np.sum([r["qat_layer"][k] for r in fleet], 0), want[k],
                                   **tol, err_msg=k)
    x, layer = _qat_input()
    conv = np.asarray(_qat_fwd_math(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                    jnp.asarray(layer[0].weight.detach().permute(2, 3, 1, 0)
                                                .numpy())), np.float64)
    conv += layer[0].bias.detach().numpy()
    mean, var = conv.mean((0, 1, 2)), conv.var((0, 1, 2))
    jax_y = np.maximum((conv - mean) / np.sqrt(var + 1e-5), 0.0).transpose(0, 3, 1, 2)
    got = np.concatenate([np.asarray(r["qat_layer"]["y"]) for r in fleet])
    np.testing.assert_allclose(got, jax_y, rtol=1e-4, atol=1e-4)
    for r in fleet:
        for k, v in runs["single"]["qat_step"].items():
            np.testing.assert_allclose(r["qat_step"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_loader_rows_with_flips_are_one_process_rows(runs):
    """Each (dp 2, sp 2) rank's batches from the raw feed with random flips,
    after the device's flips, are its block of one process's flipped
    batch, bit for bit (a sample whose up-down bit is set hands its rank
    the mirrored block); the flip bits and ``nvalid`` are the group's."""
    from selectivenet_for_semantic_segmentation_binary_torch.data.dataset import PatchDataset
    from selectivenet_for_semantic_segmentation_binary_torch.data.folds import (
        construct_train_valid)
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import device_preprocess

    cfg = _train_cfg(runs["data"], "unused")
    train_list, _ = construct_train_valid(cfg.data_dir, test_fold=cfg.fold, seed=cfg.seed)
    ds = PatchDataset(cfg.data_dir, train_list, cfg.patch_mag, cfg.patch_size, cfg.input_type)

    def batches(**fleet):
        loader = PatchLoader(ds, 4, num_workers=1, shuffle=True, seed=cfg.seed,
                             random_flip=True, **fleet)
        loader.set_epoch(1)
        return list(loader)

    whole = batches()
    ud = sum(int(b["flips"][:, 1].sum()) for b in whole)
    assert 0 < ud < sum(len(b["flips"]) for b in whole)  # both kinds of sample
    for r in range(WORLD):
        g = Grid(2, 2, r)
        h = SIZE // 2
        mine = batches(process_index=g.dp_index, process_count=2, spatial_index=g.sp_index,
                       spatial_count=2)
        assert len(mine) == len(whole)
        for b, w in zip(mine, whole):
            ex = slice(2 * g.dp_index, 2 * g.dp_index + 2)
            rows = slice(h * g.sp_index, h * g.sp_index + h)
            assert b["nvalid"] == w["nvalid"]
            assert torch.equal(b["flips"], w["flips"][ex])
            x, label = device_preprocess(b)
            want_x, want_label = device_preprocess(w)
            assert torch.equal(x, want_x[ex, :, rows])
            assert torch.equal(label, want_label[ex, rows])


@pytest.mark.parametrize("world,sp,batch,patch", [
    (8, 1, 16, 32), (8, 2, 16, 32), (8, 4, 16, 32), (8, 3, 16, 48), (8, 2, 7, 32),
    (8, 2, 16, 24), (8, 1, 7, 32), (1, 2, 16, 32), (4, 2, 8, 32),
])
def test_dp_sp_checks_match_jax(world, sp, batch, patch):
    """``dp_sp_ways`` against JAX ``make_mesh_dp_sp`` on ``world`` of its
    devices: the (dp, sp) shape, or the same ``ValueError`` message; and
    the rank layout, JAX ``make_mesh_2d``'s row-major device grid."""
    from selectivenet_for_semantic_segmentation_binary_tpu.parallel.mesh import (
        make_mesh_dp_sp as jax_make_mesh_dp_sp)

    try:
        mesh = jax_make_mesh_dp_sp(world, sp, batch, patch)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            dp_sp_ways(world, sp, batch, patch)
        assert str(got.value) == str(e)
        return
    dp, s = dp_sp_ways(world, sp, batch, patch)
    assert (dp, s) == tuple(mesh.devices.shape if mesh.devices.ndim == 2
                            else (mesh.devices.size, 1))
    ids = np.vectorize(lambda d: d.id)(mesh.devices).reshape(dp, s)
    for r in range(world):
        g = Grid(dp, s, r)
        assert ids[g.dp_index, g.sp_index] == jax.devices()[r].id


def test_one_process_refuses_sp_as_jax_with_one_device():
    """One process is one rank: ``make_mesh_dp_sp`` refuses ``--sp_ways 2``
    with JAX's message for one device, and returns the trivial grid for
    ``--sp_ways 1``."""
    with pytest.raises(ValueError, match=r"^sp_ways 2 must divide the device count 1$"):
        make_mesh_dp_sp(None, 2, 16, 256)
    assert make_mesh_dp_sp(4, 1, 16, 256) == Grid(1, 1, 0, None)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
