"""Training and evaluation configuration: counterpart of the JAX package's
``config.py`` (``validate_output_dim`` :26-44, ``parse_bool`` :47-56,
``TrainConfig`` :59-158, ``EvalConfig`` :160-217, ``parse_train_args``
:235-246, ``parse_eval_args`` :249-265).

Standard library only, so the port never imports the JAX package. The
fields, their defaults and the parsed flags are the JAX package's, one for
one (``tests/test_torch_config.py`` pins the two flag surfaces together):
the reference train.py:12-55 and eval.py:16-57 flags with the ``type=bool``
footgun repaired (``--selective 0`` means False), ``--fold`` accepted
beside ``--test_fold``, and an inert ``--output_dim`` refused. The flags the
port does not cover yet are refused where they would act
(``train_lib.check_supported``, ``eval_lib.check_supported``).

In the port, ``use_pallas`` switches the hand-written CUDA eval-metrics
kernel (``kernels/eval_metrics.cu``) and ``fused_cbr`` the fused-CBR trunk
on ``kernels/fused_conv_stats.cu``; the names are kept so both packages
take the same flags.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


def input_channels(input_type: str) -> int:
    """The model's input channels for ``--input_type``: 2 for GH, 3 for RGB
    and H_RGB (reference model.py:24-27)."""
    return 2 if input_type == "GH" else 3


def check_input_channels(parser: argparse.ArgumentParser, input_type: str,
                         in_ch: int) -> None:
    """``parser.error`` where ``--input_type`` does not give the channels the
    checkpoint's first conv takes (``in_ch``): the serving CLIs would
    otherwise fail on every image."""
    if in_ch != input_channels(input_type):
        parser.error(f"--input_type {input_type} gives {input_channels(input_type)} input "
                     f"channels; the checkpoint's first conv takes {in_ch}")


def validate_output_dim(cfg) -> None:
    """Reject non-default ``--output_dim`` loudly: the reference's flag only
    chose its host torch->numpy conversion (reference train.py:141-144,
    eval.py:166-168), and a flag that silently does nothing corrupts
    experiment conclusions."""
    val = getattr(cfg, "output_dim", "NHW")
    if val not in ("NHW", None):
        raise ValueError(
            f"--output_dim {val!r} is not supported: outputs are (N, H, W) / "
            "(N, H, W, C) natively and the reference's NCHW/NHW switch only "
            "chose its host numpy conversion (reference train.py:141-144). "
            "Remove the flag (or pass NHW).")


def parse_bool(v) -> bool:
    """Lenient bool parser replacing the reference's ``type=bool`` footgun."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y", "on"):
        return True
    if s in ("0", "false", "f", "no", "n", "off", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


@dataclass
class TrainConfig:
    """Training configuration (flag surface of reference train.py:12-55)."""

    data_dir: str = "/data"
    fold: int = 1
    input_type: str = "RGB"          # 'RGB' | 'GH' | 'H_RGB'
    patch_mag: int = 200
    patch_size: int = 256
    n_cls: int = 2

    model_dir: str = "/model"
    model_arch: str = "UNet"         # 'UNet' (CE heads) | 'UNet_B' (binary heads)
    selective: bool = False
    s_lamb: float = 2.0              # lambda of the coverage constraint
    target_coverage: float = 0.8     # selective_loss.py:24 default
    output_dim: str = "NHW"          # only 'NHW' (validate_output_dim)
    output_scale: str = "sigmoid"    # 'None' | 'clip' | 'sigmoid' | 'minmax'

    optim: str = "Adam"              # 'Adam' | 'SGD'
    momentum: float = 0.0
    w_decay: float = 0.0
    lr: float = 1e-3
    lr_sche: Optional[str] = None    # None | 'StepLR' | 'ReduceLR' | 'CosineAnnealingLR'
    patience: int = 10
    factor: float = 0.5
    lr_min: float = 1e-5

    loss: str = "CE"                 # 'BCElogit' | 'CE'

    batch_size: int = 16
    n_epoch: int = 100

    local_rank: List[int] = field(default_factory=lambda: [0])
    log_img: bool = False

    num_workers: int = 16            # decode threads
    compute_dtype: str = "bfloat16"
    bn_stats: str = "float32"        # 'bfloat16': LowPrecStatsBN (classic trunk)
    bn_mode: str = "global"          # 'per_replica' not ported (A8/A9)
    bn_replicas: int = 0
    seed: int = 42
    drop_last: bool = True           # static shapes; the last batch is padded otherwise
    restore_optim: bool = False      # reference deliberately skips it (train.py:126)
    dropout_rate: float = 0.0        # rate of the two dropout sites (0 = none)
    profile_dir: Optional[str] = None  # torch.profiler trace of the run's 2nd epoch
    pnt_aug: bool = False            # PartialNonTissue augmentation (host float feed)
    blankfield: bool = False         # blank-field correction (host float feed)
    device_preproc: bool = True      # ship raw uint8, normalise and flip on the device (RGB)
    fused_cbr: str = "auto"          # fused-CBR trunk: auto (= off) | on | off
    ckpt_async: bool = False         # write checkpoints on a background thread
    keep_ckpt: int = 0               # keep the newest N checkpoints (0 = all)
    sp_ways: int = 1                 # spatial-parallel training, not ported (A9)
    train_quant: str = "none"        # 'int8': QAT, the int8 forward in train mode
    remat: bool = False              # recompute the forward in the backward

    @property
    def n_devices(self) -> int:
        return max(1, len(self.local_rank))

    @property
    def ckpt_dir(self) -> str:
        return f"{self.model_dir}/{self.fold}-fold/checkpoint"

    @property
    def log_dir(self) -> str:
        return f"{self.model_dir}/{self.fold}-fold/log"

    @property
    def input_channels(self) -> int:
        return input_channels(self.input_type)


@dataclass
class EvalConfig:
    """Evaluation configuration (flag surface of reference eval.py:16-57)."""

    data_dir: str = "./data"
    test_fold: int = 1
    input_type: str = "RGB"
    patch_mag: int = 200
    patch_size: int = 256
    n_cls: int = 2

    batch_size: int = 16
    num_workers: int = 16

    model_dir: str = "*/model"
    model_arch: List[str] = field(default_factory=lambda: ["UNet_B"])
    selective: bool = False
    select_eval: bool = False
    output_dim: str = "NHW"

    single_scale: str = "sigmoid"    # 'None' | 'clip' | 'sigmoid' | 'minmax'
    ens_scale: str = "None"

    cut_off: float = 0.5
    s_cut_off: float = 0.5

    local_rank: List[int] = field(default_factory=lambda: [0])
    info_print: bool = False
    # any explicitly set value writes the metric CSV; unset is None
    save_dir: Optional[str] = None

    compute_dtype: str = "bfloat16"
    seed: int = 42
    use_pallas: bool = True  # the eval-metrics kernel (single-device binary path)
    blankfield: bool = False  # blank-field white balance (host float feed)
    device_preproc: bool = True  # ship raw uint8, normalise on the device (RGB)
    sp_ways: int = 1  # spatial-parallel eval (not ported: A8)
    quantize: str = "none"  # 'int8': the W8A8 serving forward
    calib_patches: int = 8  # test-fold patches that calibrate the int8 scales

    @property
    def n_devices(self) -> int:
        return max(1, len(self.local_rank))

    @property
    def input_channels(self) -> int:
        return input_channels(self.input_type)


def _add_args_from_dataclass(parser: argparse.ArgumentParser, cfg) -> None:
    for f in dataclasses.fields(type(cfg)):
        default = getattr(cfg, f.name)
        name = f"--{f.name}"
        if f.type in ("bool", bool) or isinstance(default, bool):
            parser.add_argument(name, type=parse_bool, default=default)
        elif isinstance(default, list):
            elem = type(default[0]) if default else str
            parser.add_argument(name, type=elem, nargs="+", default=default)
        elif default is None:
            parser.add_argument(name, type=str, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)


def parse_train_args(argv=None) -> TrainConfig:
    parser = argparse.ArgumentParser(description="SelectiveNet U-Net training (PyTorch)")
    _add_args_from_dataclass(parser, TrainConfig())
    cfg = TrainConfig(**vars(parser.parse_args(argv)))
    if cfg.lr_sche in ("None", "none", ""):
        cfg.lr_sche = None
    try:
        validate_output_dim(cfg)
    except ValueError as e:
        parser.error(str(e))
    return cfg


def parse_eval_args(argv=None) -> EvalConfig:
    parser = argparse.ArgumentParser(description="SelectiveNet U-Net evaluation (PyTorch)")
    _add_args_from_dataclass(parser, EvalConfig())
    # the reference README documents --fold while eval.py:22 implements
    # --test_fold; accept both (--fold wins if both are given)
    parser.add_argument("--fold", type=int, default=None)
    d = vars(parser.parse_args(argv))
    fold = d.pop("fold")
    cfg = EvalConfig(**d)
    if fold is not None:
        cfg.test_fold = fold
    try:
        validate_output_dim(cfg)
    except ValueError as e:
        parser.error(str(e))
    return cfg
