"""Training: the train and valid steps and the epoch loop.

Counterpart of the JAX package's ``train_lib.py:87-768`` (reference
train.py:57-357):

* ``make_train_step``: device preprocessing (normalisation and the loader's
  per-sample flips of a raw batch; a float batch arrives normalised and
  flipped by the host), the train-mode forward, the composite selective loss,
  backward, the optimizer step with the epoch's learning rate, prediction
  thresholding and the confusion and rejection counts; only device tensors
  come back, and the epoch loop syncs with the host once per epoch;
* ``make_valid_step``: eval-mode forward (running BN statistics), the loss
  masked to the valid pixels of a padded last batch, and the counts;
* ``train``: folds, loaders, seeded initialisation, digit-sorted
  auto-resume, per-epoch scheduler step, TensorBoard scalars (and image
  panels with ``--log_img``), stdout lines, and reference-format
  ``model_epoch{N}.pth`` checkpoints (``--keep_ckpt``, ``--ckpt_async``).

``--fused_cbr on`` builds the fused-CBR trunk, whose 13 convs after the
first run the hand-written CUDA kernel ``kernels/fused_conv_stats.cu``; it
needs a CUDA device and raises without one, as the JAX package raises off a
TPU. ``auto`` resolves to off there, and here too.

The feed (``make_loaders``) is the raw uint8 one where the host has no
colour math to do (``--device_preproc 1``, RGB, no ``--blankfield``, no
``--pnt_aug``), and else the float one: ``--input_type GH|H_RGB`` (GH
builds a 2-channel first conv), ``--blankfield``, ``--pnt_aug`` and
``--device_preproc 0`` run the host transforms of ``data/transforms.py``.

``--bn_stats bfloat16`` builds ``models.LowPrecStatsBN`` (bf16 batch
statistics; the classic trunk only, as in the JAX package). ``--remat``
saves only the step's inputs and runs the forward again in the backward
(``remat_forward``). ``--profile_dir`` traces epoch ``start_epoch + 2`` with
``torch.profiler`` (``_profile``).

``--train_quant int8`` (QAT, classic trunk only) builds ``models.QATCBR``:
the train step's 14 convs run the dynamic-scale int8 forward (K10,
``kernels/int8_conv.cu``, on the card) with a bf16 straight-through
backward; the valid step runs the float graph; the parameters and the
checkpoints are the float ones. ``--fused_cbr on`` with it raises, as in
JAX.

Several cards (JAX ``train_lib.py:180-236, 508-620, 738-768``): one process
per card, launched by torchrun or by ``cli``'s ``--local_rank a b ...``
(``parallel/multihost.py``). ``train()`` then runs on ``cuda:LOCAL_RANK``
with the global ``--batch_size``, each rank decoding its slice of every
batch; the losses, the coverage and the BatchNorm statistics are means over
the global batch (``ops/losses.py``, ``models.set_process_group``), the
gradients are averaged over the ranks after the backward
(``parallel.mesh.mean_gradients``), and every rank runs the same Adam step
on the same parameters. The epoch's counts are summed over the ranks once
an epoch. Rank 0 alone writes checkpoints and TensorBoard events (and
prints); every rank restores. After each epoch's write every rank agrees
that it landed, so a failed write on rank 0 aborts every rank
(``_fleet_checkpoint_agreement``), and ``train()`` ends with a barrier.
``--fused_cbr on`` is refused on a fleet, as in JAX (K2 is a single-card
kernel, as its Pallas original is). ``--bn_mode per_replica`` builds
``models.GroupedBatchNorm`` with ``resolve_bn_groups`` groups, on one card
or on a fleet.

``--sp_ways s`` (JAX train_lib.py:575, where GSPMD partitions the step)
lays the fleet's ranks out as (dp, sp) (``parallel.mesh.make_mesh_dp_sp``):
each rank decodes the examples of its data-parallel group and keeps its
block of their rows (``make_loaders``), and every 3x3 block of the classic
trunk (the QAT one too) swaps one-row halos with its neighbours within the
sp group before its conv (``models.set_process_group``,
``parallel.spatial.exchange_halo``). The sums behind the losses, the
coverage and BatchNorm are over the world, each rank counting its own rows,
so they stay the global batch's; dropout masks are the global batch's
rows. ``--remat`` runs the halo exchanges again in the recompute, on every
rank in step.

``--dropout_rate > 0`` builds the model's two dropout sites
(``models/unet.py``); the train step draws their masks from one
``torch.Generator`` on the model's device, seeded with ``--seed`` and
advanced by every step, where the JAX step takes a key split from
``PRNGKey(seed)`` (train_lib.py:287, 426, 590): the same rate and the same
determinism by seed, not the same masks. The valid step runs no dropout.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .config import TrainConfig, validate_output_dim
from .data.dataset import PatchDataset
from .data.folds import construct_train_valid
from .data.loader import PatchLoader
from .data.transforms import (BlankfieldCorrection, Compose, Normalization,
                              PartialNonTissue, RandomFlip, ToArray)
from .models import build_model, init_weights, load_weights, set_process_group
from .ops.confusion import PAD_LABEL, confusion_matrix_update
from .ops.ingest import normalize_raw
from .ops.losses import (bce_with_logits, selective_risk_b, selective_risk_ce,
                         softmax_cross_entropy)
from .optim import build_optimizer, build_scheduler, set_lr
from .parallel import multihost
from .parallel.mesh import Grid, all_reduce_, dp_sp_ways, make_mesh_dp_sp, mean_gradients
from .utils import tracing
from .utils.checkpoint import (AsyncCheckpointWriter, load_latest_checkpoint,
                               prune_checkpoints, save_checkpoint)
from .utils.metrics import Evaluator
from .utils.tb_writer import SummaryWriter


def device_preprocess(batch: Dict[str, torch.Tensor]):
    """(N, H, W, C) -> (N, C, H, W) float32 in channels_last memory (the
    permute copies nothing). A raw uint8 batch is normalised as /255 then
    (x - 0.5) / 0.5, the JAX op order in float32 (``ops.ingest.normalize_raw``);
    a float batch of the host feed passes through as it is, normalised and
    flipped by the host's transforms. With ``"flips"`` ((N, 2) uint8 from
    the raw loader) each sample is flipped left-right (width) and up-down
    (height) as its bits say, input and label alike; the flips run on the
    uint8 tensors, before the elementwise normalisation. Labels stay
    uint8."""
    x, label = batch["input"], batch["label"]
    if "flips" in batch:
        lr, ud = batch["flips"].bool().unbind(1)
        x = torch.where(lr[:, None, None, None], x.flip(2), x)
        x = torch.where(ud[:, None, None, None], x.flip(1), x)
        label = torch.where(lr[:, None, None], label.flip(2), label)
        label = torch.where(ud[:, None, None], label.flip(1), label)
    x = x.permute(0, 3, 1, 2)
    if x.dtype == torch.uint8:
        x = normalize_raw(x)
    return x, label


def check_supported(cfg: TrainConfig) -> None:
    """Refuse a configuration the port would not run as its flags say, before
    anything is built: an inert ``--output_dim``
    (``config.validate_output_dim``), and ``--sp_ways`` > 1 for TransUNet.
    Every flag of the JAX ``TrainConfig`` is covered."""
    validate_output_dim(cfg)
    check_rows_split(cfg.model_arch, cfg.sp_ways)


def check_rows_split(model_arch: str, sp_ways: int) -> None:
    """``--sp_ways`` > 1 splits each image's rows over ranks with the 3x3
    blocks' halo exchange (``parallel.spatial``), which does not cover
    TransUNet's attention across row blocks: refused for it."""
    if model_arch == "TransUNet" and int(sp_ways) > 1:
        raise ValueError(f"--sp_ways {sp_ways} is not implemented for TransUNet: the rows "
                         "split exchanges the 3x3 convs' halos, and attention spans every "
                         "row block; use --sp_ways 1")


def resolve_fused(cfg: TrainConfig, device: torch.device, world: int = 1) -> bool:
    """Whether to build the fused-CBR trunk: 'on' needs a CUDA device and
    raises without one (a flag that silently does nothing corrupts an
    experiment's conclusions), and one card (JAX train_lib.py:203-208);
    'auto' is off, as in the JAX package."""
    mode = cfg.fused_cbr
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown --fused_cbr {mode!r} (expected auto, on or off)")
    if mode == "on":
        if device.type != "cuda":
            raise ValueError("--fused_cbr on requires a CUDA device (the fused-CBR "
                             f"kernel has no {device.type} path); use --fused_cbr "
                             "auto/off here")
        if world != 1:
            raise ValueError(
                "--fused_cbr on is single-chip only (the fused-CBR kernel computes "
                f"one card's BatchNorm sums); got a {world}-device mesh — use "
                "--fused_cbr auto/off or --local_rank with one device")
        return True
    return False


def resolve_bn_groups(cfg: TrainConfig, world: int = 1) -> int:
    """``--bn_mode per_replica``'s emulated replica count (JAX
    train_lib.py:213-236): ``--bn_replicas 0`` (the default) is one group a
    rank, the literal DataParallel analog of the run; an explicit N lets one
    card reproduce the reference's 8-GPU recipe (train.sh: an effective BN
    batch of 128/8). The global batch must split into equal groups, as
    DataParallel's dim-0 scatter does; 1 for global BatchNorm."""
    if cfg.bn_mode != "per_replica":
        return 1
    groups = int(cfg.bn_replicas) or int(world)
    if groups < 1:
        raise ValueError(f"--bn_replicas must be >= 0, got {groups}")
    if cfg.batch_size % groups:
        raise ValueError(
            f"--bn_mode per_replica needs --batch_size ({cfg.batch_size}) "
            f"divisible by the replica count ({groups}, from "
            f"--bn_replicas {cfg.bn_replicas} / mesh size "
            f"{world}) — DataParallel scatters equal sub-batches "
            "(reference train.py:132-134)")
    return groups


def _predictions(cfg, output, selection):
    """Class maps from the logits (reference train.py:216-236): binary
    outputs through the optional sigmoid, then > 0.5; n-class by argmax."""
    if output.ndim == 3:
        prob = torch.sigmoid(output) if cfg.output_scale == "sigmoid" else output
        pred = (prob > 0.5).long()
    else:
        pred = output.argmax(-1)
    sel_mask = None
    if selection is not None:
        if selection.ndim == 3:
            s = torch.sigmoid(selection) if cfg.output_scale == "sigmoid" else selection
            sel_mask = (s > 0.5).long()
        else:
            sel_mask = selection.argmax(-1)
    return pred, sel_mask


def _losses(cfg, outputs, label, mask=None, pg=None):
    """Composite objective (reference train.py:193-204). ``mask`` marks the
    valid pixels when a padded last batch can occur; with the fleet's ``pg``
    every term is a mean over the global batch."""
    use_bce = "BCE" in cfg.loss
    if cfg.selective:
        output, selection, aux = outputs
        if use_bce:
            aux_loss = bce_with_logits(aux, label, mask=mask, pg=pg)
            sel_loss, coverage = selective_risk_b(
                output, selection, label, target_coverage=cfg.target_coverage,
                lamb=cfg.s_lamb, mask=mask, pg=pg)
        else:
            aux_loss = softmax_cross_entropy(aux, label, mask=mask, pg=pg)
            sel_loss, coverage = selective_risk_ce(
                output, selection, label, target_coverage=cfg.target_coverage,
                lamb=cfg.s_lamb, mask=mask, pg=pg)
        extras = {"aux_loss": aux_loss, "sel_loss": sel_loss, "coverage": coverage}
        return aux_loss + sel_loss, extras, output, selection
    if use_bce:
        return bce_with_logits(outputs, label, mask=mask, pg=pg), {}, outputs, None
    return softmax_cross_entropy(outputs, label, mask=mask, pg=pg), {}, outputs, None


def _batch_metrics(cfg, label, pred, sel_mask):
    """The confusion counts and rejection tallies, on the device."""
    valid = ((label >= 0) & (label < cfg.n_cls)).long()
    n_valid = valid.sum()
    metrics = {"cm": confusion_matrix_update(label, pred, cfg.n_cls, sel_mask),
               "n_pix": n_valid}
    if sel_mask is not None:
        metrics["n_reject"] = n_valid - (sel_mask * valid).sum()
    return metrics


def _targets(cfg, label):
    return label.float() if "BCE" in cfg.loss else label.long()


def remat_forward(model: torch.nn.Module, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """The train-mode forward under ``--remat`` (JAX train_lib.py:294-301,
    ``jax.checkpoint`` of the loss): ``torch.utils.checkpoint`` saves only
    the input and runs the forward again inside the backward. Two things the
    JAX step gets from its pure function are kept here by hand:

    * the second forward runs under ``models.recomputing``, so the
      BatchNorms' running statistics move once a step (from the first
      forward, JAX train_lib.py:288-292), not twice;
    * it draws its dropout masks from a copy of ``generator`` as it stood
      before the first forward, so they are the first forward's masks, and
      ``generator`` itself advances once, as without remat
      (``preserve_rng_state`` restores only the global generators, which the
      model does not use, so it is off: no device sync)."""
    from torch.utils.checkpoint import checkpoint

    from .models import recomputing

    start = generator.get_state() if generator is not None else None
    calls = []

    def run(inp):
        if not calls:
            calls.append(1)
            return model(inp, generator=generator)
        replay = None
        if generator is not None:
            replay = torch.Generator(device=generator.device)
            replay.set_state(start)
        with recomputing(model):
            return model(inp, generator=replay)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def make_train_step(model: torch.nn.Module, cfg: TrainConfig,
                    optimizer: torch.optim.Optimizer, pg=None) -> Callable:
    """``step(batch, lr) -> metrics``: one optimizer step on ``batch`` at
    learning rate ``lr``; the metrics are device tensors. With
    ``cfg.dropout_rate > 0`` the dropout masks come from a generator on the
    model's device seeded with ``cfg.seed``, which every step advances.
    ``cfg.remat`` runs the forward through ``remat_forward``. With the
    fleet's ``pg`` (and ``models.set_process_group(model, pg)``) ``batch``
    is this rank's slice, the loss and its terms are global, and the
    gradients are averaged over the ranks before the optimizer step; the
    confusion counts stay this rank's.

    Traced (``utils/tracing.py``) as ``step`` with the device spans
    ``step.forward`` (preprocessing, forward, loss), ``step.backward``,
    ``step.exchange`` (the gradient mean, with ``pg``) and ``step.update``
    (the optimizer and the counts)."""
    device = next(model.parameters()).device
    generator = None
    if cfg.dropout_rate > 0:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)

    def step(batch, lr: float):
        with tracing.span("step", device=device):
            with tracing.span("step.forward", device=device):
                x, label = device_preprocess(batch)
                # padding exists only when drop_last is off
                mask = None if cfg.drop_last else (label >= 0) & (label < cfg.n_cls)
                model.train()
                set_lr(optimizer, lr)
                if cfg.remat:
                    outputs = remat_forward(model, x, generator)
                else:
                    outputs = model(x, generator=generator)
                loss, extras, output, selection = _losses(cfg, outputs, _targets(cfg, label),
                                                          mask, pg)
            with tracing.span("step.backward", device=device):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            if pg is not None:
                with tracing.span("step.exchange", device=device):
                    mean_gradients(model.parameters(), pg)
            with tracing.span("step.update", device=device):
                optimizer.step()
                with torch.no_grad():
                    pred, sel_mask = _predictions(cfg, output, selection)
                    metrics = {"loss": loss.detach(),
                               **{k: v.detach() for k, v in extras.items()},
                               **_batch_metrics(cfg, label, pred, sel_mask)}
                    if cfg.log_img:
                        metrics["pred"] = pred
                        if sel_mask is not None:
                            metrics["selection"] = sel_mask
        return metrics

    return step


def make_valid_step(model: torch.nn.Module, cfg: TrainConfig, pg=None) -> Callable:
    """``step(batch) -> metrics``: eval-mode forward (running BN statistics),
    the loss over the valid pixels only, and the counts (reference
    train.py:275-331); with ``pg`` the loss over the global batch's."""

    @torch.no_grad()
    def step(batch):
        x, label = device_preprocess(batch)
        mask = (label >= 0) & (label < cfg.n_cls)  # padded pixels excluded
        model.eval()
        loss, extras, output, selection = _losses(cfg, model(x), _targets(cfg, label), mask,
                                                  pg)
        pred, sel_mask = _predictions(cfg, output, selection)
        return {"loss": loss, **extras, **_batch_metrics(cfg, label, pred, sel_mask)}

    return step


def restore_if_available(cfg: TrainConfig, model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer) -> Tuple[int, Optional[dict]]:
    """Auto-resume from the digit-latest loadable checkpoint (reference
    train.py:111-129): the network always, the optimizer only with
    ``--restore_optim`` (the reference comments its restore out). Returns
    the epoch to continue after and the saved scheduler state, if any."""
    found = load_latest_checkpoint(cfg.ckpt_dir)
    if found is None:
        return 0, None
    path, epoch, ckpt = found
    load_weights(model, ckpt["net"])
    if cfg.restore_optim and "optim" in ckpt:
        optimizer.load_state_dict(ckpt["optim"])
    print(f"Load weights from {path}")
    return epoch, ckpt.get("scheduler")


@dataclass
class EpochStats:
    loss: float
    acc: float
    aux_loss: Optional[float] = None
    sel_loss: Optional[float] = None
    rejection: Optional[float] = None
    patches: int = 0
    seconds: float = 0.0
    # each step's scalar metrics (loss, and aux_loss, sel_loss and coverage
    # when selective), one float64 array a key
    per_step: Optional[Dict[str, np.ndarray]] = None

    @property
    def patches_per_sec(self) -> float:
        return self.patches / self.seconds if self.seconds > 0 else 0.0


def _sum_counts(cms: torch.Tensor, host_counts: Dict[str, torch.Tensor], pg) -> None:
    """Sum the per-batch confusion counts, and ``n_pix``/``n_reject``, over
    the ranks in place: one all-reduce of them packed into one tensor."""
    keys = [k for k in ("n_pix", "n_reject") if k in host_counts]
    packed = torch.cat([cms.reshape(cms.shape[0], -1)]
                       + [host_counts[k].reshape(-1, 1).to(cms.dtype) for k in keys], 1)
    all_reduce_(packed, pg)
    width = cms[0].numel()
    cms.copy_(packed[:, :width].reshape(cms.shape))
    for i, k in enumerate(keys):
        host_counts[k].copy_(packed[:, width + i])


def _run_epoch(cfg, loader, step_fn, lr: float, train: bool):
    """One pass over a loader: (EpochStats, last batch, its metrics). The
    per-batch metrics stay on the device until the pass ends; on a fleet
    the counts are then summed over the ranks (the losses are global
    already)."""
    pg = multihost.group()
    evaluator = Evaluator(cfg.n_cls)
    device_metrics, device_cms = [], []
    t0 = time.perf_counter()
    patches = 0
    last_batch = last_metrics = None
    for batch in loader:
        metrics = step_fn(batch, lr) if train else step_fn(batch)
        device_cms.append(metrics.pop("cm"))
        images = {k: metrics.pop(k) for k in ("pred", "selection") if k in metrics}
        device_metrics.append(metrics)
        patches += batch["nvalid"]
        last_batch, last_metrics = batch, {**metrics, **images}
    host: Dict[str, np.ndarray] = {}
    if device_metrics:
        stacked = {k: torch.stack([m[k] for m in device_metrics]) for k in device_metrics[0]}
        cms = torch.stack(device_cms)
        if pg is not None:
            _sum_counts(cms, stacked, pg)
        host = {k: v.cpu().numpy() for k, v in stacked.items()}
        for cm in cms.cpu().numpy():
            evaluator.add_confusion_matrix(cm)
    seconds = time.perf_counter() - t0

    def mean(key):
        return float(np.mean(host[key].astype(np.float64))) if host else float("nan")

    stats = EpochStats(
        loss=mean("loss"),
        acc=evaluator.get_Pixel_Accuracy() if evaluator.confusion_matrix.sum() else float("nan"),
        patches=patches, seconds=seconds,
        per_step={k: host[k].astype(np.float64) for k in ("loss", "aux_loss", "sel_loss",
                                                          "coverage") if k in host})
    if cfg.selective:
        stats.aux_loss = mean("aux_loss")
        stats.sel_loss = mean("sel_loss")
        total_pix = int(host["n_pix"].sum()) if host else 0
        stats.rejection = (int(host["n_reject"].sum()) / total_pix if total_pix
                           else float("nan"))
    return stats, last_batch, last_metrics


def _log_epoch_images(writer, cfg, batch, metrics, epoch: int) -> None:
    """First-5 input/label/pred(/selection) panels (reference train.py:266-271),
    the input and label flipped as the step flipped them; a float batch is
    denormalised (train.py:139)."""
    inp = batch["input"][:5].cpu().numpy()
    inp = inp.astype(np.float32) / 255.0 if inp.dtype == np.uint8 else inp * 0.5 + 0.5
    label = batch["label"][:5].cpu().numpy()
    if "flips" in batch:
        inp, label = inp.copy(), label.copy()
        for i, (lr, ud) in enumerate(batch["flips"][:5].cpu().numpy().astype(bool)):
            if lr:
                inp[i], label[i] = inp[i][:, ::-1], label[i][:, ::-1]
            if ud:
                inp[i], label[i] = inp[i][::-1], label[i][::-1]
    writer.add_images("input", inp, epoch)
    # padding renders as background; class ids spread over the gray levels
    label = np.where(label == PAD_LABEL, 0, label)
    scale = np.uint8(255 // max(int(cfg.n_cls) - 1, 1))
    writer.add_images("label", np.expand_dims(label.astype(np.uint8) * scale, -1), epoch)
    if "pred" in metrics:
        pred = metrics["pred"][:5].cpu().numpy()
        writer.add_images("pred", np.expand_dims(pred.astype(np.uint8) * scale, -1), epoch)
    if "selection" in metrics:
        sel = metrics["selection"][:5].cpu().numpy()
        writer.add_images("selection", np.expand_dims((sel * 255).astype(np.uint8), -1), epoch)


def raw_feed(cfg) -> bool:
    """Whether the loaders ship raw uint8 for the device to normalise: only
    where the host has no colour math to do (the JAX ``raw_mode`` gate,
    train_lib.py:518-523, eval_lib.py:245-249; ``pnt_aug`` is a training
    flag only)."""
    return (cfg.device_preproc and cfg.input_type == "RGB" and not cfg.blankfield
            and not getattr(cfg, "pnt_aug", False))


def host_transforms(cfg, train: bool) -> Compose:
    """The float feed's transform (JAX ``make_loaders``, train_lib.py:542-556):
    blank-field first, then PNT (training only), then ``Normalization(0.5,
    0.5)``, then ``RandomFlip`` (training only), then ``ToArray``; the
    dataset converts the stain before any of them."""
    pre = [BlankfieldCorrection()] if cfg.blankfield else []
    if not train:
        return Compose(pre + [Normalization(0.5, 0.5), ToArray()])
    aug = [PartialNonTissue()] if cfg.pnt_aug else []
    return Compose(pre + aug + [Normalization(0.5, 0.5), RandomFlip(), ToArray()])


def fleet_rows(cfg) -> Dict[str, int]:
    """``PatchLoader``'s fleet arguments for this rank: the examples of its
    data-parallel group, and with ``--sp_ways`` its block of their rows
    (``parallel.mesh.Grid``'s layout, checked as ``make_mesh_dp_sp``
    checks it)."""
    rank, world = multihost.process_info()
    dp, sp = dp_sp_ways(world, cfg.sp_ways, cfg.batch_size, cfg.patch_size)
    grid = Grid(dp, sp, rank)
    return dict(process_index=grid.dp_index, process_count=dp, spatial_index=grid.sp_index,
                spatial_count=sp)


def make_loaders(cfg: TrainConfig, device) -> Tuple[PatchLoader, PatchLoader]:
    """Fold lists, datasets and loaders (reference train.py:367-381): the
    training set shuffled (with flip bits in the raw feed, flipped by the
    host in the float feed), the validation set in order with its last
    batch padded; on a fleet each rank decodes its slice of every batch
    (``fleet_rows``)."""
    train_list, valid_list = construct_train_valid(cfg.data_dir, test_fold=cfg.fold,
                                                   seed=cfg.seed)
    raw = raw_feed(cfg)
    fleet = fleet_rows(cfg)
    loaders = []
    for lst, train in ((train_list, True), (valid_list, False)):
        ds = PatchDataset(cfg.data_dir, lst, cfg.patch_mag, cfg.patch_size, cfg.input_type,
                          transform=None if raw else host_transforms(cfg, train))
        loaders.append(PatchLoader(
            ds, cfg.batch_size, num_workers=cfg.num_workers, device=device, shuffle=train,
            drop_last=cfg.drop_last and train, seed=cfg.seed, random_flip=raw and train,
            device_preproc=raw, **fleet))
    return loaders[0], loaders[1]


def _to_host(obj):
    """A copy of every tensor in a nested state dict, on the CPU: a
    checkpoint must not alias parameters that the next step updates."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


@contextlib.contextmanager
def _profile(profile_dir: str, epoch: int, device: torch.device):
    """``--profile_dir``: a ``torch.profiler`` trace of one training epoch
    (JAX train_lib.py:638-651, ``jax.profiler.start_trace``/``stop_trace``),
    CPU activity and, on the card, CUDA kernels (the fused trunk's
    ``fused_conv_stats_kernel`` among them), written to
    ``{profile_dir}/epoch{N}.pt.trace.json`` (Chrome trace format; open it
    in Perfetto or chrome://tracing) also when the epoch dies: the partial
    trace is the most useful debugging artifact. The program's spans
    (``utils/tracing.py``, on while the profiler runs) go into the same file
    as ``X`` events of category ``program`` on the trace's time base, so
    Perfetto shows them over the kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:  # its exit synchronises the card before the trace stops
            yield
    finally:
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"epoch{epoch}.pt.trace.json")
        prof.export_chrome_trace(path)
        _add_program_spans(path, tracing.take())


def _add_program_spans(path: str, spans) -> None:
    """Append ``spans`` to the chrome trace at ``path`` as complete events
    (``ts`` and ``dur`` in us from the trace's ``baseTimeNanoseconds``)."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for s in spans:
        args = {"id": s.id, "parent": s.parent, "key": repr(s.key)}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        trace["traceEvents"].append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                                     "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                                     "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)


def freeze_heap() -> None:
    """Collect, then move every object alive (the model, the optimizer, the
    loaders, the imported modules) to the collector's permanent generation
    (``gc.freeze``), so that the step loop's full collections walk only
    what the loop made. Where the host enqueues a step in nearly its device
    time (TransUNet at batch 128: ~284 of ~295 ms on an H100), a full
    collection over set-up's objects (150-250 ms) idles the card.
    ``gc.unfreeze()`` hands them back."""
    gc.collect()
    gc.freeze()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``None`` means the first card
    (``cuda:0``; on a fleet this rank's, ``cuda:LOCAL_RANK``), and without
    one the call raises; the CPU only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found (torch.cuda.is_available() is False); "
                               "pass device=\"cpu\" to run on the CPU")
        device = multihost.local_device()
    return torch.device(device)


class _NullWriter:
    """The TensorBoard writer of a rank that is not rank 0."""

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    def add_images(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def _fleet_checkpoint_agreement(error: Optional[BaseException], pg) -> None:
    """Every rank agrees that rank 0's checkpoint write landed (JAX
    ``_fleet_checkpoint_agreement``): rank 0 alone writes, and a failure
    there would otherwise leave the other ranks waiting in the next epoch's
    collectives. Each rank gives an ok flag (an ``all_reduce`` MIN); any
    failure raises on every rank."""
    if pg is not None:
        if not multihost.agree(error is None, pg):
            if error is not None:
                raise error
            raise RuntimeError("checkpoint write failed on the writer host; aborting fleet")
    elif error is not None:
        raise error


def train(cfg: TrainConfig, loaders=None, verbose: bool = True, device=None) -> Dict[str, Any]:
    """Full training run (reference train.py:57-357). ``device`` defaults to
    the first card (this rank's on a fleet) and raises without one
    (``resolve_device``); pass ``device="cpu"`` to train on the CPU.
    Returns the last epoch's ``{"epoch", "train", "valid", "model"}`` and
    ``"history"``, every epoch's ``(epoch, train, valid)``. On a fleet
    (``torch.distributed`` initialised) ``loaders`` yield this rank's slices
    (``PatchLoader(process_index=, process_count=)``, as ``make_loaders``
    builds them); outside one, ``--local_rank`` with several ids is one
    rank here, as JAX's mesh on a machine with one chip is one device.
    With ``--sp_ways`` given ``loaders`` yield this rank's row blocks too
    (``fleet_rows``)."""
    check_supported(cfg)
    device = resolve_device(device)
    pg = multihost.group()
    rank, world = multihost.process_info(pg)
    grid = make_mesh_dp_sp(cfg.n_devices, cfg.sp_ways, cfg.batch_size, cfg.patch_size)
    is_writer = rank == 0
    verbose = verbose and is_writer

    model = build_model(cfg.model_arch, cfg.n_cls, cfg.selective, cfg.compute_dtype,
                        fused=resolve_fused(cfg, device, world), dropout_rate=cfg.dropout_rate,
                        in_ch=cfg.input_channels, bn_stats=cfg.bn_stats,
                        train_quant=cfg.train_quant, bn_mode=cfg.bn_mode,
                        bn_groups=resolve_bn_groups(cfg, world), img_size=cfg.patch_size)
    set_process_group(model, pg, grid.sp_group)
    if verbose and cfg.train_quant != "none":
        print(f"train_quant={cfg.train_quant}: QAT int8 W8A8 forward convs, "
              "bf16 straight-through backward (documented numerics "
              "deviation; valid/eval run the float graph)")
    init_weights(model, torch.Generator().manual_seed(cfg.seed)).to(device)
    optimizer = build_optimizer(cfg, model.parameters())
    start_epoch, sched_state = restore_if_available(cfg, model, optimizer)
    scheduler = build_scheduler(cfg)
    if sched_state is not None:
        scheduler.load_state_dict(sched_state)
    elif cfg.lr_sche in ("StepLR", "CosineAnnealingLR"):
        for _ in range(start_epoch):  # fast-forward epoch-indexed schedules
            scheduler.step()

    train_step = make_train_step(model, cfg, optimizer, pg)
    valid_step = make_valid_step(model, cfg, pg)
    loader_train, loader_valid = loaders if loaders is not None else make_loaders(cfg, device)

    # rank 0 owns the files (checkpoints, event files); every rank restores
    if is_writer:
        writer_train = SummaryWriter(f"{cfg.log_dir}/train")
        writer_valid = SummaryWriter(f"{cfg.log_dir}/valid")
    else:
        writer_train = writer_valid = _NullWriter()
    ckpt_writer = AsyncCheckpointWriter() if cfg.ckpt_async and is_writer else None
    final: Dict[str, Any] = {}
    history = []
    freeze_heap()
    try:
        for epoch in range(start_epoch + 1, start_epoch + cfg.n_epoch + 1):
            current_lr = scheduler.lr
            writer_train.add_scalar("lr", current_lr, epoch)
            if verbose:
                print(f"epoch {epoch} / {start_epoch + cfg.n_epoch}, learning rate {current_lr}")
            loader_train.set_epoch(epoch)
            # profile the run's 2nd epoch (past the first-call set-up) when asked
            with (_profile(cfg.profile_dir, epoch, device)
                  if cfg.profile_dir is not None and epoch == start_epoch + 2
                  else contextlib.nullcontext()):
                tr, tr_batch, tr_metrics = _run_epoch(cfg, loader_train, train_step,
                                                      current_lr, train=True)
            if cfg.lr_sche is not None:
                scheduler.step(tr.loss if cfg.lr_sche == "ReduceLR" else None)

            writer_train.add_scalar("loss", tr.loss, epoch)
            writer_train.add_scalar("accuracy", tr.acc, epoch)
            writer_train.add_scalar("patches_per_sec", tr.patches_per_sec, epoch)
            if cfg.selective:
                writer_train.add_scalar("aux loss", tr.aux_loss, epoch)
                writer_train.add_scalar("selection loss", tr.sel_loss, epoch)
                writer_train.add_scalar("rejection ratio", tr.rejection, epoch)
            # the panels need the whole batch, which a fleet's rank does not hold
            if cfg.log_img and tr_batch is not None and world == 1:
                _log_epoch_images(writer_train, cfg, tr_batch, tr_metrics, epoch)

            va, _, _ = _run_epoch(cfg, loader_valid, valid_step, current_lr, train=False)
            writer_valid.add_scalar("loss", va.loss, epoch)
            writer_valid.add_scalar("accuracy", va.acc, epoch)
            if cfg.selective:
                writer_valid.add_scalar("aux loss", va.aux_loss, epoch)
                writer_valid.add_scalar("selection loss", va.sel_loss, epoch)
                writer_valid.add_scalar("rejection ratio", va.rejection, epoch)

            if verbose:
                print("train_loss %.05f train_acc %.04f | valid_loss %.05f valid_acc %.04f"
                      " | %.0f patches/s"
                      % (tr.loss, tr.acc, va.loss, va.acc, tr.patches_per_sec))
                if cfg.selective:
                    print("train_aux_loss %.05f | train_select_loss %.05f | train_rejection %.03f"
                          % (tr.aux_loss, tr.sel_loss, tr.rejection))
                    print("valid_aux_loss %.05f | valid_select_loss %.05f | valid_rejection %.03f"
                          % (va.aux_loss, va.sel_loss, va.rejection))

            ckpt_error: Optional[BaseException] = None
            if is_writer:
                try:
                    payload = {"net": _to_host(model.state_dict()),
                               "optim": _to_host(optimizer.state_dict()),
                               "scheduler": scheduler.state_dict(), "epoch": epoch}
                    if ckpt_writer is not None:
                        ckpt_writer.save(cfg.ckpt_dir, payload, epoch, keep=cfg.keep_ckpt)
                    else:
                        save_checkpoint(cfg.ckpt_dir, payload, epoch)
                        prune_checkpoints(cfg.ckpt_dir, cfg.keep_ckpt)
                except Exception as e:  # noqa: BLE001 - relayed to every rank below
                    ckpt_error = e
            _fleet_checkpoint_agreement(ckpt_error, pg)
            history.append((epoch, tr, va))
            final = {"epoch": epoch, "train": tr, "valid": va, "model": model,
                     "history": history}

        # the last epoch's async write joins the agreement too, so that its
        # failure on rank 0 aborts every rank instead of the end barrier
        join_error: Optional[BaseException] = None
        if ckpt_writer is not None:
            try:
                ckpt_writer.wait()
            except Exception as e:  # noqa: BLE001
                join_error = e
        _fleet_checkpoint_agreement(join_error, pg)
    finally:
        gc.unfreeze()
        # flush the event files and land the last issued write even on error;
        # a stored write error surfaces here
        try:
            writer_train.close()
            writer_valid.close()
        finally:
            if ckpt_writer is not None:
                ckpt_writer.wait()
    if pg is not None:
        # returning means "checkpoints written" on every rank, so a
        # following evaluate() cannot race rank 0's last write
        multihost.barrier(pg)
    return final
