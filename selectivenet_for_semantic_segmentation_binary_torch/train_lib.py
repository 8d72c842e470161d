"""Training: the train and valid steps and the epoch loop.

Counterpart of the JAX package's ``train_lib.py:87-744`` (reference
train.py:57-357), on one device:

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

Not covered yet, and refused with ``NotImplementedError`` naming the ROADMAP
item: several devices, ``--sp_ways`` and ``--bn_mode per_replica`` (A8/A9)
and ``--train_quant int8`` (A10).

``--dropout_rate > 0`` builds the model's two dropout sites
(``models/unet.py``); the train step draws their masks from one
``torch.Generator`` on the model's device, seeded with ``--seed`` and
advanced by every step, where the JAX step takes a key split from
``PRNGKey(seed)`` (train_lib.py:287, 426, 590): the same rate and the same
determinism by seed, not the same masks. The valid step runs no dropout.
"""

from __future__ import annotations

import contextlib
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
from .models import build_model, init_weights, load_weights
from .ops.confusion import PAD_LABEL, confusion_matrix_update
from .ops.ingest import normalize_raw
from .ops.losses import (bce_with_logits, selective_risk_b, selective_risk_ce,
                         softmax_cross_entropy)
from .optim import build_optimizer, build_scheduler, set_lr
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
    """Refuse the flags this port does not cover yet, naming the ROADMAP item."""
    if len(cfg.local_rank) > 1 or cfg.sp_ways > 1 or cfg.bn_mode != "global":
        raise NotImplementedError("training on several devices, --sp_ways and "
                                  "--bn_mode per_replica are not ported yet: ROADMAP A8/A9")
    if cfg.train_quant != "none":
        raise NotImplementedError("--train_quant int8 is not ported yet: ROADMAP A10")


def resolve_fused(cfg: TrainConfig, device: torch.device) -> bool:
    """Whether to build the fused-CBR trunk: 'on' needs a CUDA device and
    raises without one (a flag that silently does nothing corrupts an
    experiment's conclusions); 'auto' is off, as in the JAX package."""
    mode = cfg.fused_cbr
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown --fused_cbr {mode!r} (expected auto, on or off)")
    if mode == "on":
        if device.type != "cuda":
            raise ValueError("--fused_cbr on requires a CUDA device (the fused-CBR "
                             f"kernel has no {device.type} path); use --fused_cbr "
                             "auto/off here")
        return True
    return False


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


def _losses(cfg, outputs, label, mask=None):
    """Composite objective (reference train.py:193-204). ``mask`` marks the
    valid pixels when a padded last batch can occur."""
    use_bce = "BCE" in cfg.loss
    if cfg.selective:
        output, selection, aux = outputs
        if use_bce:
            aux_loss = bce_with_logits(aux, label, mask=mask)
            sel_loss, coverage = selective_risk_b(
                output, selection, label, target_coverage=cfg.target_coverage,
                lamb=cfg.s_lamb, mask=mask)
        else:
            aux_loss = softmax_cross_entropy(aux, label, mask=mask)
            sel_loss, coverage = selective_risk_ce(
                output, selection, label, target_coverage=cfg.target_coverage,
                lamb=cfg.s_lamb, mask=mask)
        extras = {"aux_loss": aux_loss, "sel_loss": sel_loss, "coverage": coverage}
        return aux_loss + sel_loss, extras, output, selection
    if use_bce:
        return bce_with_logits(outputs, label, mask=mask), {}, outputs, None
    return softmax_cross_entropy(outputs, label, mask=mask), {}, outputs, None


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
                    optimizer: torch.optim.Optimizer) -> Callable:
    """``step(batch, lr) -> metrics``: one optimizer step on ``batch`` at
    learning rate ``lr``; the metrics are device tensors. With
    ``cfg.dropout_rate > 0`` the dropout masks come from a generator on the
    model's device seeded with ``cfg.seed``, which every step advances.
    ``cfg.remat`` runs the forward through ``remat_forward``."""
    generator = None
    if cfg.dropout_rate > 0:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(cfg.seed)

    def step(batch, lr: float):
        x, label = device_preprocess(batch)
        # padding exists only when drop_last is off
        mask = None if cfg.drop_last else (label >= 0) & (label < cfg.n_cls)
        model.train()
        set_lr(optimizer, lr)
        if cfg.remat:
            outputs = remat_forward(model, x, generator)
        else:
            outputs = model(x, generator=generator)
        loss, extras, output, selection = _losses(cfg, outputs, _targets(cfg, label), mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            pred, sel_mask = _predictions(cfg, output, selection)
            metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in extras.items()},
                       **_batch_metrics(cfg, label, pred, sel_mask)}
            if cfg.log_img:
                metrics["pred"] = pred
                if sel_mask is not None:
                    metrics["selection"] = sel_mask
        return metrics

    return step


def make_valid_step(model: torch.nn.Module, cfg: TrainConfig) -> Callable:
    """``step(batch) -> metrics``: eval-mode forward (running BN statistics),
    the loss over the valid pixels only, and the counts (reference
    train.py:275-331)."""

    @torch.no_grad()
    def step(batch):
        x, label = device_preprocess(batch)
        mask = (label >= 0) & (label < cfg.n_cls)  # padded pixels excluded
        model.eval()
        loss, extras, output, selection = _losses(cfg, model(x), _targets(cfg, label), mask)
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

    @property
    def patches_per_sec(self) -> float:
        return self.patches / self.seconds if self.seconds > 0 else 0.0


def _run_epoch(cfg, loader, step_fn, lr: float, train: bool):
    """One pass over a loader: (EpochStats, last batch, its metrics). The
    per-batch metrics stay on the device until the pass ends."""
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
        host = {k: torch.stack([m[k] for m in device_metrics]).cpu().numpy()
                for k in device_metrics[0]}
        for cm in torch.stack(device_cms).cpu().numpy():
            evaluator.add_confusion_matrix(cm)
    seconds = time.perf_counter() - t0

    def mean(key):
        return float(np.mean(host[key].astype(np.float64))) if host else float("nan")

    stats = EpochStats(
        loss=mean("loss"),
        acc=evaluator.get_Pixel_Accuracy() if evaluator.confusion_matrix.sum() else float("nan"),
        patches=patches, seconds=seconds)
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


def make_loaders(cfg: TrainConfig, device) -> Tuple[PatchLoader, PatchLoader]:
    """Fold lists, datasets and loaders (reference train.py:367-381): the
    training set shuffled (with flip bits in the raw feed, flipped by the
    host in the float feed), the validation set in order with its last
    batch padded."""
    train_list, valid_list = construct_train_valid(cfg.data_dir, test_fold=cfg.fold,
                                                   seed=cfg.seed)
    raw = raw_feed(cfg)
    loaders = []
    for lst, train in ((train_list, True), (valid_list, False)):
        ds = PatchDataset(cfg.data_dir, lst, cfg.patch_mag, cfg.patch_size, cfg.input_type,
                          transform=None if raw else host_transforms(cfg, train))
        loaders.append(PatchLoader(
            ds, cfg.batch_size, num_workers=cfg.num_workers, device=device, shuffle=train,
            drop_last=cfg.drop_last and train, seed=cfg.seed, random_flip=raw and train,
            device_preproc=raw))
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
    trace is the most useful debugging artifact."""
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
        prof.export_chrome_trace(os.path.join(profile_dir, f"epoch{epoch}.pt.trace.json"))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``None`` means the first card
    (``cuda:0``), and without one the call raises; the CPU only when the
    caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found (torch.cuda.is_available() is False); "
                               "pass device=\"cpu\" to run on the CPU")
        device = "cuda:0"
    return torch.device(device)


def train(cfg: TrainConfig, loaders=None, verbose: bool = True, device=None) -> Dict[str, Any]:
    """Full training run (reference train.py:57-357). ``device`` defaults to
    the first card and raises without one (``resolve_device``); pass
    ``device="cpu"`` to train on the CPU. Returns the last epoch's
    ``{"epoch", "train", "valid", "model"}``."""
    validate_output_dim(cfg)
    check_supported(cfg)
    device = resolve_device(device)

    model = build_model(cfg.model_arch, cfg.n_cls, cfg.selective, cfg.compute_dtype,
                        fused=resolve_fused(cfg, device), dropout_rate=cfg.dropout_rate,
                        in_ch=cfg.input_channels, bn_stats=cfg.bn_stats)
    init_weights(model, torch.Generator().manual_seed(cfg.seed)).to(device)
    optimizer = build_optimizer(cfg, model.parameters())
    start_epoch, sched_state = restore_if_available(cfg, model, optimizer)
    scheduler = build_scheduler(cfg)
    if sched_state is not None:
        scheduler.load_state_dict(sched_state)
    elif cfg.lr_sche in ("StepLR", "CosineAnnealingLR"):
        for _ in range(start_epoch):  # fast-forward epoch-indexed schedules
            scheduler.step()

    train_step = make_train_step(model, cfg, optimizer)
    valid_step = make_valid_step(model, cfg)
    loader_train, loader_valid = loaders if loaders is not None else make_loaders(cfg, device)

    writer_train = SummaryWriter(f"{cfg.log_dir}/train")
    writer_valid = SummaryWriter(f"{cfg.log_dir}/valid")
    ckpt_writer = AsyncCheckpointWriter() if cfg.ckpt_async else None
    final: Dict[str, Any] = {}
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
            if cfg.log_img and tr_batch is not None:
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

            payload = {"net": _to_host(model.state_dict()),
                       "optim": _to_host(optimizer.state_dict()),
                       "scheduler": scheduler.state_dict(), "epoch": epoch}
            if ckpt_writer is not None:
                ckpt_writer.save(cfg.ckpt_dir, payload, epoch, keep=cfg.keep_ckpt)
            else:
                save_checkpoint(cfg.ckpt_dir, payload, epoch)
                prune_checkpoints(cfg.ckpt_dir, cfg.keep_ckpt)
            final = {"epoch": epoch, "train": tr, "valid": va, "model": model}
    finally:
        # flush the event files and land the last issued write even on error;
        # a stored write error surfaces here
        try:
            writer_train.close()
            writer_valid.close()
        finally:
            if ckpt_writer is not None:
                ckpt_writer.wait()
    return final
