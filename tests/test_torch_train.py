"""The port's training slice against the JAX package's, on the CPU in float32.

(a) Train-mode BatchNorm: both trunks (classic; fused, with the JAX Pallas
    kernel interpreted) at batch 2, 32x32, full widths: outputs, updated
    running statistics and gradients. At the bottleneck N*H*W = 2*4*4 = 32,
    so an unbiased running variance (nn.BatchNorm2d's) would be off by 1/31.
(b) Lockstep: four train steps (Adam, BCElogit selective risk, flip bits)
    from the same variables on the same uint8 batches, both trunks.
(c) The valid step on a padded last batch.
(d) ``train()`` end to end on a synthetic patch tree: checkpoints that the
    JAX package and the port's ``evaluate()`` read, resume, retention, async
    writes, and the flags the port refuses.
(e) Loader order and flip bits, and the train/valid split, against JAX.

Variables are made on the port's side from a seed and carried to JAX with
the JAX package's own importer (``torch_state_dict_to_variables``).
"""

import contextlib
import dataclasses
import gc
import io
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.config import TrainConfig as JaxTrainConfig
from selectivenet_for_semantic_segmentation_binary_tpu.data import (
    PatchLoader as JaxPatchLoader,
    construct_train_valid as jax_construct_train_valid,
    write_synthetic_patch_tree,
)
from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.optim import build_optimizer as jax_optimizer
from selectivenet_for_semantic_segmentation_binary_tpu.train_lib import (
    TrainState,
    make_train_step as jax_train_step,
    make_valid_step as jax_valid_step,
)
from selectivenet_for_semantic_segmentation_binary_tpu.utils import tb_writer as jax_tb
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    import_torch_checkpoint,
    torch_state_dict_to_variables,
)
from selectivenet_for_semantic_segmentation_binary_torch import cli
from selectivenet_for_semantic_segmentation_binary_torch.config import EvalConfig, TrainConfig
from selectivenet_for_semantic_segmentation_binary_torch.data.folds import construct_train_valid
from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import evaluate
from selectivenet_for_semantic_segmentation_binary_torch.models import (
    BatchNorm2d, build_model, init_weights, load_weights)
from selectivenet_for_semantic_segmentation_binary_torch.ops.confusion import PAD_LABEL
from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
    make_train_step, make_valid_step, train)
from selectivenet_for_semantic_segmentation_binary_torch.utils import tb_writer as port_tb
from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
    load_checkpoint, load_latest_checkpoint, state_dict_from_jax_variables)

TRUNKS = {"classic": False, "fused": True}
SIZE = 32
# (a), as tests/test_fused_cbr.py:149-186 holds the JAX fused trunk to the classic one
FWD_TOL = dict(rtol=5e-4, atol=5e-4)
GRAD_TOL = dict(rtol=3e-3, atol=1e-3)
# the running statistics are float32 means of the same activations (measured
# <= 2e-7 apart): held tighter, so that the unbiased update, 2e-4 to 7e-4
# away at the bottleneck, fails
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
# (b): the tolerance of the JAX package's own lockstep against a torch oracle
# (tests/test_lockstep.py:190). Step 0 agrees to ~1e-7; from the first Adam
# step on, parameters whose gradient is float noise (the conv biases before
# BN have a zero gradient in exact arithmetic) move by +-lr in directions
# that differ between the two, and the losses drift apart by up to ~4e-4.
LOCK_TOL = dict(rtol=1e-3, atol=1e-4)


def _port_model(fused: bool, seed: int = 0):
    """A seeded port UNet_B (float32, selective) with nontrivial running
    statistics, and the same variables in the JAX layout."""
    model = build_model("UNet_B", selective=True, fused=fused)
    g = torch.Generator().manual_seed(seed)
    init_weights(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    return model, torch_state_dict_to_variables(sd)


def _jax_model(fused: bool):
    return jax_build_model("UNet_B", selective=True, compute_dtype="float32", fused=fused,
                           fused_interpret=fused)


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _toy_loss_jax(outputs, yb):
    out, sel, aux = outputs
    return (-jnp.mean(yb * jax.nn.log_sigmoid(out) + (1 - yb) * jax.nn.log_sigmoid(-out))
            + 0.1 * jnp.mean(jax.nn.sigmoid(sel)) + 0.1 * jnp.mean(aux))


def _toy_loss_port(outputs, yb):
    out, sel, aux = outputs
    f = torch.nn.functional.logsigmoid
    return (-(yb * f(out) + (1 - yb) * f(-out)).mean()
            + 0.1 * torch.sigmoid(sel).mean() + 0.1 * aux.mean())


# ---------------------------------------------------------------------------
# (a) train-mode BatchNorm and the two trunks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(TRUNKS))
def train_mode(request):
    """One train-mode forward + backward of each side, same variables."""
    fused = TRUNKS[request.param]
    model, variables = _port_model(fused, seed=1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    yb = (rng.random((2, SIZE, SIZE)) > 0.5).astype(np.float32)

    jmodel = _jax_model(fused)
    params, stats = _as_jax(variables["params"]), _as_jax(variables["batch_stats"])

    def loss(p):
        outputs, mutated = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                        train=True, mutable=["batch_stats"])
        return _toy_loss_jax(outputs, jnp.asarray(yb)), (outputs, mutated["batch_stats"])

    (_, (j_out, j_stats)), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want_stats = state_dict_from_jax_variables(
        {"params": variables["params"], "batch_stats": jax.device_get(j_stats)})
    want_grads = state_dict_from_jax_variables(
        {"params": jax.device_get(j_grads), "batch_stats": variables["batch_stats"]})

    model.train()
    outputs = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    _toy_loss_port(outputs, torch.from_numpy(yb)).backward()
    return dict(model=model, variables=variables, outputs=outputs, j_out=j_out,
                want_stats=want_stats, want_grads=want_grads)


def test_train_forward_matches_jax(train_mode):
    for got, want in zip(train_mode["outputs"], train_mode["j_out"]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)


def test_running_statistics_match_flax(train_mode):
    """flax's update: momentum 0.9, the BIASED fast variance."""
    sd = train_mode["model"].state_dict()
    n_buffers = 0
    for k, want in train_mode["want_stats"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), **STATS_TOL, err_msg=k)
            n_buffers += 1
    assert n_buffers == 28  # 14 BN layers x 2 buffers
    assert all(int(v) == 1 for k, v in sd.items() if k.endswith("num_batches_tracked"))


def test_an_unbiased_running_variance_would_fail(train_mode):
    """The bottleneck's batch variance over 32 elements: torch's unbiased
    update would move the running variance by more than the tolerance."""
    key = "decoder_layer_4_1.1.running_var"
    before = state_dict_from_jax_variables(train_mode["variables"])[key].numpy()
    after = train_mode["want_stats"][key].numpy()
    batch_var = (after - 0.9 * before) / 0.1
    unbiased = 0.9 * before + 0.1 * batch_var * 32 / 31
    tol = STATS_TOL["atol"] + STATS_TOL["rtol"] * np.abs(after)
    assert np.all(np.abs(unbiased - after) > tol)  # every channel would fail


def test_train_gradients_match_jax(train_mode):
    model = train_mode["model"]
    named = dict(model.named_parameters())
    assert set(named) == set(k for k in train_mode["want_grads"]
                             if not k.endswith(("running_mean", "running_var")))
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), train_mode["want_grads"][k].numpy(),
                                   **GRAD_TOL, err_msg=k)


def test_fused_and_classic_share_the_state_dict():
    classic, fused = build_model("UNet_B", selective=True), build_model("UNet_B", selective=True,
                                                                       fused=True)
    assert list(classic.state_dict()) == list(fused.state_dict())
    assert "decoder_layer_1_1.1.num_batches_tracked" in fused.state_dict()


# ---------------------------------------------------------------------------
# (b) lockstep against the JAX train step
# ---------------------------------------------------------------------------

LOCK_STEPS, LOCK_BATCH, LR = 4, 2, 1e-3
LOCK_KEYS = ("loss", "aux_loss", "sel_loss", "coverage")


def _cfg_kw(**kw):
    base = dict(model_arch="UNet_B", selective=True, loss="BCElogit", s_lamb=2.0,
                compute_dtype="float32", batch_size=LOCK_BATCH, patch_size=SIZE, lr=LR,
                log_img=True)
    base.update(kw)
    return base


def _uint8_batches(seed, n, batch, pad=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        inp = rng.integers(0, 256, (batch, SIZE, SIZE, 3), dtype=np.uint8)
        lab = (rng.random((batch, SIZE, SIZE)) > 0.5).astype(np.uint8)
        flips = rng.integers(0, 2, (batch, 2)).astype(np.uint8)
        if pad:
            inp[-pad:] = 0
            lab[-pad:] = PAD_LABEL
            flips[-pad:] = 0
        out.append({"input": inp, "label": lab, "flips": flips})
    return out


@pytest.fixture(scope="module", params=list(TRUNKS))
def lockstep(request):
    fused = TRUNKS[request.param]
    model, variables = _port_model(fused, seed=2)
    jcfg = JaxTrainConfig(**_cfg_kw())
    tx = jax_optimizer(jcfg)
    params = _as_jax(variables["params"])
    state = TrainState(params=params, batch_stats=_as_jax(variables["batch_stats"]),
                       opt_state=tx.init(params))
    jstep = jax_train_step(_jax_model(fused), jcfg, tx)
    cfg = TrainConfig(**_cfg_kw())
    pstep = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
    logits = []  # the port's (output, selection) logits of each step's forward
    model.register_forward_hook(lambda m, a, out: logits.append(
        (out[0].detach().numpy().copy(), out[1].detach().numpy().copy())))
    traj = []
    for b in _uint8_batches(3, LOCK_STEPS, LOCK_BATCH):
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in b.items()}, LR,
                          jax.random.PRNGKey(0))
        pm = pstep({k: torch.from_numpy(v) for k, v in b.items()}, LR)
        traj.append((jax.device_get(jm), pm, logits[-1]))
    return traj


def test_lockstep_losses_and_coverage(lockstep):
    want = np.array([[float(j[k]) for k in LOCK_KEYS] for j, _, _ in lockstep])
    got = np.array([[float(p[k]) for k in LOCK_KEYS] for _, p, _ in lockstep])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)  # same parameters
    np.testing.assert_allclose(got, want, **LOCK_TOL)
    assert np.all(got[:, 2] >= 0.0)


# a logit this close to the threshold (0) may flip once the parameters have
# drifted apart (see LOCK_TOL): the flipped pixels measured lie within 0.08
NEAR = 0.1


def test_lockstep_counts(lockstep):
    """n_pix exactly; the prediction and selection maps and the counts
    exactly at step 0 (same parameters); after it, the maps agree on every
    pixel whose logit is farther than NEAR from the threshold, and the counts
    differ by no more than the flipped pixels move them."""
    for step, (j, p, (out, sel)) in enumerate(lockstep):
        assert int(j["n_pix"]) == int(p["n_pix"]) == LOCK_BATCH * SIZE * SIZE
        flip_pred = np.asarray(j["pred"]) != p["pred"].numpy()
        flip_sel = np.asarray(j["selection"]) != p["selection"].numpy()
        assert np.all(np.abs(out[flip_pred]) <= NEAR), step
        assert np.all(np.abs(sel[flip_sel]) <= NEAR), step
        cm_diff = int(np.abs(np.asarray(j["cm"]) - p["cm"].numpy()).sum())
        rej_diff = abs(int(j["n_reject"]) - int(p["n_reject"]))
        assert cm_diff <= 2 * flip_pred.sum() + flip_sel.sum() and rej_diff <= flip_sel.sum()
        if step == 0:
            assert cm_diff == rej_diff == flip_pred.sum() == flip_sel.sum() == 0


# ---------------------------------------------------------------------------
# (c) the valid step on a padded last batch
# ---------------------------------------------------------------------------

def test_valid_step_masks_the_padding():
    model, variables = _port_model(False, seed=4)
    cfg_kw = _cfg_kw(batch_size=4, drop_last=False)
    batch = _uint8_batches(5, 1, 4, pad=1)[0]
    del batch["flips"]
    jstate = TrainState(params=_as_jax(variables["params"]),
                        batch_stats=_as_jax(variables["batch_stats"]), opt_state=None)
    want = jax.device_get(jax_valid_step(_jax_model(False), JaxTrainConfig(**cfg_kw))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
    step = make_valid_step(model, TrainConfig(**cfg_kw))
    got = step({k: torch.from_numpy(v) for k, v in batch.items()})
    unpadded = step({k: torch.from_numpy(v[:3]) for k, v in batch.items()})
    assert int(got["n_pix"]) == int(want["n_pix"]) == 3 * SIZE * SIZE
    assert int(got["cm"].sum() + got["n_reject"]) == 3 * SIZE * SIZE
    np.testing.assert_array_equal(got["cm"].numpy(), np.asarray(want["cm"]))
    assert int(got["n_reject"]) == int(want["n_reject"])
    for k in LOCK_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6)
        # eval-mode BN treats samples independently: the padding changes nothing
        np.testing.assert_allclose(float(got[k]), float(unpadded[k]), rtol=1e-6)
    assert float(got["sel_loss"]) >= 0.0
    assert not model.training


# ---------------------------------------------------------------------------
# (d) train() end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_train_data"))
    write_synthetic_patch_tree(d, n_slides=2, patches_per_slide=15, patch_size=SIZE)
    return d


def _train_cfg(data_dir, model_dir, **kw):
    base = dict(data_dir=data_dir, model_dir=model_dir, fold=1, patch_size=SIZE, batch_size=8,
                n_epoch=2, model_arch="UNet_B", loss="BCElogit", selective=True,
                compute_dtype="float32", num_workers=2)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def trained(data_dir, tmp_path_factory):
    """Two epochs through the CLI, then one more through train() (a resume)."""
    model_dir = str(tmp_path_factory.mktemp("torch_train_model"))
    cfg = _train_cfg(data_dir, model_dir)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["train", "--data_dir", data_dir, "--model_dir", model_dir, "--fold", "1",
                  "--patch_size", str(SIZE), "--batch_size", "8", "--n_epoch", "2",
                  "--model_arch", "UNet_B", "--loss", "BCElogit", "--selective", "1",
                  "--compute_dtype", "float32", "--num_workers", "2"], device="cpu")
    files_after_cli = sorted(os.listdir(cfg.ckpt_dir))
    resume_out = io.StringIO()
    with contextlib.redirect_stdout(resume_out):
        result = train(dataclasses.replace(cfg, n_epoch=1), device="cpu")
    return dict(cfg=cfg, cli_out=out.getvalue(), files_after_cli=files_after_cli,
                resume_out=resume_out.getvalue(), result=result)


def test_train_writes_checkpoints_and_logs(trained):
    cfg = trained["cfg"]
    assert trained["files_after_cli"] == ["model_epoch1.pth", "model_epoch2.pth"]
    assert "train_select_loss" in trained["cli_out"]
    for split in ("train", "valid"):
        assert any(f.startswith("events.out.tfevents")
                   for f in os.listdir(os.path.join(cfg.log_dir, split)))
    ckpt = load_checkpoint(os.path.join(cfg.ckpt_dir, "model_epoch2.pth"))
    assert ckpt["epoch"] == 2 and set(ckpt) == {"net", "optim", "scheduler", "epoch"}
    assert ckpt["scheduler"] == {"lr": cfg.lr, "last_epoch": 0}


def test_train_resumes_with_finite_losses(trained):
    cfg, result = trained["cfg"], trained["result"]
    assert f"Load weights from {cfg.ckpt_dir}/model_epoch2.pth" in trained["resume_out"]
    assert result["epoch"] == 3
    for stats in (result["train"], result["valid"]):
        for v in (stats.loss, stats.aux_loss, stats.sel_loss):
            assert np.isfinite(v)
        assert stats.sel_loss >= 0.0 and 0.0 <= stats.rejection <= 1.0
    path, epoch, ckpt = load_latest_checkpoint(cfg.ckpt_dir)
    assert (os.path.basename(path), epoch, ckpt["epoch"]) == ("model_epoch3.pth", 3, 3)


def test_jax_reads_the_checkpoint(trained):
    """The JAX package imports the port's .pth, and its forward equals the
    port's at 1e-4 (float32 convs summed in different orders)."""
    path = os.path.join(trained["cfg"].ckpt_dir, "model_epoch3.pth")
    variables = import_torch_checkpoint(path)
    x = np.random.default_rng(6).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    want = _jax_model(False).apply(_as_jax(variables), jnp.asarray(x), train=False)
    model = build_model("UNet_B", selective=True)
    load_weights(model, load_checkpoint(path)["net"])
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_port_evaluate_reads_the_checkpoint(trained, data_dir, tmp_path):
    shutil.copy(os.path.join(trained["cfg"].ckpt_dir, "model_epoch3.pth"), tmp_path)
    res = evaluate(EvalConfig(data_dir=data_dir, test_fold=1, model_dir=str(tmp_path),
                              model_arch=["UNet_B"], selective=True, select_eval=True,
                              batch_size=4, patch_size=SIZE, compute_dtype="float32",
                              num_workers=2), verbose=False, device="cpu")
    assert np.isfinite(res["accuracy"]) and 0.0 <= res["rejection_ratio"] <= 1.0


def test_keep_ckpt_with_async_writes(data_dir, tmp_path):
    cfg = _train_cfg(data_dir, str(tmp_path), keep_ckpt=1, ckpt_async=True, selective=False,
                     lr_sche="ReduceLR", patience=0)
    train(cfg, verbose=False, device="cpu")
    assert os.listdir(cfg.ckpt_dir) == ["model_epoch2.pth"]
    ckpt = load_checkpoint(os.path.join(cfg.ckpt_dir, "model_epoch2.pth"))
    assert ckpt["epoch"] == 2 and set(ckpt["scheduler"]) == {"lr", "last_epoch", "best",
                                                             "num_bad_epochs"}


def test_set_up_objects_stay_frozen_through_the_epochs(data_dir, tmp_path, monkeypatch):
    """train() moves what set-up left alive out of the collector's reach for
    its epochs (``freeze_heap``) and hands it back when it returns."""
    from selectivenet_for_semantic_segmentation_binary_torch import train_lib

    real, frozen = train_lib._run_epoch, []

    def run_epoch(*a, **k):
        frozen.append(gc.get_freeze_count())
        return real(*a, **k)

    monkeypatch.setattr(train_lib, "_run_epoch", run_epoch)
    train(_train_cfg(data_dir, str(tmp_path), n_epoch=1), verbose=False, device="cpu")
    assert len(frozen) == 2 and min(frozen) > 0  # the train and the valid epoch
    assert gc.get_freeze_count() == 0


@pytest.mark.parametrize("entry", ["train", "cli"])
def test_no_device_and_no_card_raises(data_dir, tmp_path, monkeypatch, entry):
    """Without a device the entry points take the card; with none they raise
    before any work instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "train":
            train(_train_cfg(data_dir, str(tmp_path)), verbose=False)
        else:
            cli.main(["train", "--data_dir", data_dir, "--model_dir", str(tmp_path),
                      "--model_arch", "UNet_B", "--patch_size", str(SIZE)])
    assert not os.path.exists(os.path.join(str(tmp_path), "1-fold"))


def test_fused_cbr_on_without_a_card_raises(data_dir, tmp_path):
    with pytest.raises(ValueError, match="CUDA"):
        train(_train_cfg(data_dir, str(tmp_path), fused_cbr="on"), device="cpu")


@pytest.mark.parametrize("flags", [
    {"local_rank": [0, 1]}, {"sp_ways": 2}, {"bn_mode": "per_replica"},
], ids=lambda f: next(iter(f)))
def test_uncovered_flags_raise(flags, data_dir, tmp_path):
    """Refused until several devices (ROADMAP A8) and ``--sp_ways`` (A9)
    were ported. Outside a fleet ``--sp_ways 2`` is refused with JAX's
    message for one device, before anything is written
    (tests/test_torch_spatial_train.py trains on four ranks). ``--local_rank
    0 1`` outside a fleet is one rank, as JAX's mesh on one chip is one
    device: the same steps as ``--local_rank 0``. ``--bn_mode per_replica`` trains through
    ``GroupedBatchNorm`` (one group a rank, here one);
    tests/test_torch_parallel.py holds it to JAX's."""
    cfg = _train_cfg(data_dir, str(tmp_path / "flags"), n_epoch=1, **flags)
    if "sp_ways" in flags:
        with pytest.raises(ValueError, match=r"^sp_ways 2 must divide the device count 1$"):
            train(cfg, device="cpu")
        assert not os.path.exists(cfg.model_dir)
        return
    got = train(cfg, verbose=False, device="cpu")
    want = train(_train_cfg(data_dir, str(tmp_path / "plain"), n_epoch=1), verbose=False,
                 device="cpu")
    from selectivenet_for_semantic_segmentation_binary_torch.models import GroupedBatchNorm

    grouped = [m for m in got["model"].modules() if isinstance(m, GroupedBatchNorm)]
    assert len(grouped) == (14 if "bn_mode" in flags else 0)
    for k, v in want["train"].per_step.items():
        if "local_rank" in flags:  # the same run
            np.testing.assert_array_equal(got["train"].per_step[k], v, err_msg=k)
        else:  # one group of the whole batch normalises as global BN does
            np.testing.assert_allclose(got["train"].per_step[k], v, **LOCK_TOL, err_msg=k)


def test_train_quant_int8_trains_and_its_checkpoint_interchanges(data_dir, tmp_path):
    """``--train_quant int8`` (QAT), refused until the int8 path was ported
    (JAX test_qat.py::test_train_end_to_end_and_ckpt_interchange): finite
    losses, and the checkpoint loads into the plain float model of both
    packages. tests/test_torch_qat.py holds the step to JAX's."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = train(_train_cfg(data_dir, str(tmp_path), train_quant="int8"), device="cpu")
    assert "train_quant=int8: QAT int8 W8A8 forward convs" in out.getvalue()
    assert np.isfinite(result["train"].loss) and np.isfinite(result["valid"].loss)
    path = os.path.join(str(tmp_path), "1-fold", "checkpoint", "model_epoch2.pth")
    net = load_checkpoint(path)["net"]
    model = load_weights(build_model("UNet_B", selective=True), net)
    with torch.no_grad():
        assert model(torch.zeros(1, 3, SIZE, SIZE))[0].shape == (1, SIZE, SIZE)
    v = import_torch_checkpoint(path)
    jax_model = jax_build_model("UNet_B", selective=True, compute_dtype="float32")
    assert jax_model.apply(v, jnp.zeros((1, SIZE, SIZE, 3)), train=False)[0].shape == (
        1, SIZE, SIZE)


@pytest.mark.parametrize("flags", [
    {"input_type": "GH"}, {"pnt_aug": True}, {"blankfield": True}, {"device_preproc": False},
], ids=lambda f: next(iter(f)))
def test_host_feed_flags_train(flags, data_dir, tmp_path, monkeypatch):
    """The host float feed's flags, refused until the feed was ported, train:
    the loaders ``train()`` builds give the JAX ``make_loaders``' batches
    bit for bit (float32 inputs, GH with 2 channels), the epoch's losses are
    finite, and the JAX package imports the checkpoint, whose forward on a
    C-channel input equals the port's at 1e-4 (as test_jax_reads_the_checkpoint).
    Both decode with PIL, the port's default."""
    from selectivenet_for_semantic_segmentation_binary_tpu.data import native_decoder
    from selectivenet_for_semantic_segmentation_binary_tpu.parallel.mesh import make_mesh
    from selectivenet_for_semantic_segmentation_binary_tpu.train_lib import (
        make_loaders as jax_make_loaders)
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import make_loaders

    monkeypatch.setattr(native_decoder, "available", lambda: False)
    cfg = _train_cfg(data_dir, str(tmp_path), n_epoch=1, drop_last=False, **flags)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    channels = 2 if cfg.input_type == "GH" else 3
    for port, want in zip(make_loaders(cfg, "cpu"),
                          jax_make_loaders(JaxTrainConfig(**kw), make_mesh(1))):
        assert not port.device_preproc and not want.device_preproc
        port.set_epoch(1)
        want.set_epoch(1)
        for g, w in zip(port, want, strict=True):
            assert g["input"].dtype == torch.float32
            assert tuple(g["input"].shape) == (8, SIZE, SIZE, channels)
            assert np.array_equal(g["input"].numpy(), np.asarray(w["input"]))
            assert np.array_equal(g["label"].numpy(), np.asarray(w["label"]))
            assert g["nvalid"] == w["nvalid"] and "flips" not in g
    with contextlib.redirect_stdout(io.StringIO()):
        result = train(cfg, device="cpu")
    for stats in (result["train"], result["valid"]):
        assert np.isfinite([stats.loss, stats.aux_loss, stats.sel_loss]).all()
    path = os.path.join(cfg.ckpt_dir, "model_epoch1.pth")
    variables = import_torch_checkpoint(path)
    assert variables["params"]["trunk"]["enc1_1"]["conv"]["kernel"].shape == (3, 3, channels, 64)
    x = np.random.default_rng(7).standard_normal((2, SIZE, SIZE, channels)).astype(np.float32)
    want = _jax_model(False).apply(_as_jax(variables), jnp.asarray(x), train=False)
    model = build_model("UNet_B", selective=True, in_ch=channels)
    load_weights(model, load_checkpoint(path)["net"])
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_dropout_rate_trains(data_dir, tmp_path):
    """--dropout_rate 0.3, refused until the dropout sites were ported, trains:
    finite losses, a checkpoint of the same keys as at rate 0, and the model
    built with the rate."""
    cfg = _train_cfg(data_dir, str(tmp_path), n_epoch=1, dropout_rate=0.3)
    with contextlib.redirect_stdout(io.StringIO()):
        result = train(cfg, device="cpu")
    assert result["model"].drop_bottom.rate == result["model"].drop3.rate == 0.3
    assert np.isfinite(result["train"].loss) and np.isfinite(result["valid"].loss)
    ckpt = load_checkpoint(os.path.join(cfg.ckpt_dir, "model_epoch1.pth"))
    assert set(ckpt["net"]) == set(build_model("UNet_B", selective=True).state_dict())


# ---------------------------------------------------------------------------
# (e) loader order and flips, folds, the TB writer copy
# ---------------------------------------------------------------------------

class _Patches:
    """Raw patches whose first pixel is the sample's index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):  # the JAX loader's float path; unused in raw mode
        raise NotImplementedError

    def get_raw(self, i):
        inp = np.full((4, 4, 3), i, np.uint8)
        inp[0, 1] = [1, 2, 3]
        return inp, (np.arange(16).reshape(4, 4) % 2).astype(np.uint8)


@pytest.mark.parametrize("drop_last", [True, False], ids=["drop_last", "padded"])
def test_loader_order_and_flips_match_jax(drop_last):
    ds = _Patches(21)
    port = PatchLoader(ds, 4, num_workers=2, shuffle=True, drop_last=drop_last, seed=9,
                       random_flip=True)
    jax_loader = JaxPatchLoader(ds, 4, shuffle=True, num_workers=2, drop_last=drop_last,
                                seed=9, device_preproc=True, random_flip=True)
    orders = []
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) == len(port) == (5 if drop_last else 6)
        for g, w in zip(got, want):
            for k in ("input", "label", "flips"):
                np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
            assert g["nvalid"] == w["nvalid"]
        orders.append([int(i) for g in got for i in g["input"][:g["nvalid"], 0, 0, 0]])
    assert orders[0] != orders[1]  # a new permutation each epoch
    assert any(b["flips"].any() for b in got)


def test_construct_train_valid_matches_jax(data_dir):
    for fold, seed in ((1, 42), (3, 7)):
        got = construct_train_valid(data_dir, test_fold=fold, seed=seed)
        want = jax_construct_train_valid(data_dir, test_fold=fold, seed=seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_tb_writer_copy_writes_the_same_records():
    t = 1_700_000_000.5
    assert port_tb.masked_crc32c(b"selectivenet") == jax_tb.masked_crc32c(b"selectivenet")
    assert (port_tb._event(t, 3, summary=port_tb._scalar_summary("loss", 0.25))
            == jax_tb._event(t, 3, summary=jax_tb._scalar_summary("loss", 0.25)))
