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
