"""The port's ``config.py`` against the JAX package's: one flag surface.

The port keeps its own standard-library copy of the evaluation config so it
never imports the JAX package; these tests pin the copy to the original
field for field, default for default and flag for flag.
"""

import dataclasses

import pytest

from selectivenet_for_semantic_segmentation_binary_tpu import config as jax_config
from selectivenet_for_semantic_segmentation_binary_torch import config as port_config


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


def test_fields_and_defaults_match_jax():
    assert _fields(port_config.EvalConfig) == _fields(jax_config.EvalConfig)
    assert (dataclasses.asdict(port_config.EvalConfig())
            == dataclasses.asdict(jax_config.EvalConfig()))


ARGVS = {
    "defaults": [],
    "headline": ["--fold", "1", "--model_dir", "m", "--model_arch", "UNet_B",
                 "--selective", "1", "--select_eval", "1", "--batch_size", "128"],
    "test_fold": ["--test_fold", "3", "--selective", "0", "--use_pallas", "false"],
    "fold_wins": ["--test_fold", "3", "--fold", "2"],
    "ensemble": ["--model_arch", "UNet", "UNet", "--ens_scale", "minmax",
                 "--single_scale", "None", "--n_cls", "2"],
    "floats_lists": ["--cut_off", "0.3", "--s_cut_off", "0.7", "--local_rank", "0", "1",
                     "--save_dir", "out", "--compute_dtype", "float32"],
    "extensions": ["--quantize", "int8", "--calib_patches", "16", "--sp_ways", "2",
                   "--blankfield", "yes", "--device_preproc", "off", "--seed", "7"],
}


@pytest.mark.parametrize("argv", list(ARGVS.values()), ids=list(ARGVS))
def test_parsed_flags_match_jax(argv):
    got = port_config.parse_eval_args(argv)
    want = jax_config.parse_eval_args(argv)
    assert isinstance(got, port_config.EvalConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_devices, got.input_channels) == (want.n_devices, want.input_channels)


@pytest.mark.parametrize("argv", [
    ["--output_dim", "NCHW"], ["--selective", "maybe"], ["--no_such_flag", "1"],
], ids=["output_dim", "bad_bool", "unknown"])
def test_bad_flags_are_refused_alike(argv):
    for parse in (port_config.parse_eval_args, jax_config.parse_eval_args):
        with pytest.raises(SystemExit):
            parse(argv)


@pytest.mark.parametrize("value, ok", [("NHW", True), (None, True), ("NCHW", False)])
def test_validate_output_dim_matches_jax(value, ok):
    cfg = port_config.EvalConfig(output_dim=value)
    for validate in (port_config.validate_output_dim, jax_config.validate_output_dim):
        if ok:
            validate(cfg)
        else:
            with pytest.raises(ValueError, match="output_dim"):
                validate(cfg)


def test_train_fields_and_defaults_match_jax():
    assert _fields(port_config.TrainConfig) == _fields(jax_config.TrainConfig)
    assert (dataclasses.asdict(port_config.TrainConfig())
            == dataclasses.asdict(jax_config.TrainConfig()))
    got, want = port_config.TrainConfig(model_dir="m", fold=3), jax_config.TrainConfig(
        model_dir="m", fold=3)
    for prop in ("n_devices", "ckpt_dir", "log_dir", "input_channels"):
        assert getattr(got, prop) == getattr(want, prop), prop


TRAIN_ARGVS = {
    "defaults": [],
    "train_sh": ["--fold", "1", "--model_arch", "UNet_B", "--selective", "1", "--s_lamb", "2",
                 "--loss", "BCElogit", "--batch_size", "128", "--patch_size", "256",
                 "--n_epoch", "200", "--local_rank", "0", "1", "2", "3"],
    "optim": ["--optim", "SGD", "--momentum", "0.9", "--w_decay", "5e-4", "--lr", "0.01",
              "--lr_sche", "CosineAnnealingLR", "--patience", "20", "--lr_min", "1e-6"],
    "lr_sche_none": ["--lr_sche", "None", "--factor", "0.1"],
    "extensions": ["--fused_cbr", "on", "--compute_dtype", "float32", "--keep_ckpt", "2",
                   "--ckpt_async", "yes", "--drop_last", "0", "--restore_optim", "1",
                   "--seed", "7", "--num_workers", "4", "--log_img", "true"],
    "refused_here": ["--bn_stats", "bfloat16", "--bn_mode", "per_replica", "--bn_replicas", "8",
                     "--sp_ways", "2", "--train_quant", "int8", "--remat", "1",
                     "--dropout_rate", "0.3", "--profile_dir", "p", "--pnt_aug", "1",
                     "--blankfield", "1", "--device_preproc", "0", "--input_type", "GH"],
}


@pytest.mark.parametrize("argv", list(TRAIN_ARGVS.values()), ids=list(TRAIN_ARGVS))
def test_parsed_train_flags_match_jax(argv):
    got = port_config.parse_train_args(argv)
    want = jax_config.parse_train_args(argv)
    assert isinstance(got, port_config.TrainConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv", [
    ["--output_dim", "NCHW"], ["--selective", "maybe"], ["--test_fold", "2"],
], ids=["output_dim", "bad_bool", "eval_only_flag"])
def test_bad_train_flags_are_refused_alike(argv):
    for parse in (port_config.parse_train_args, jax_config.parse_train_args):
        with pytest.raises(SystemExit):
            parse(argv)
