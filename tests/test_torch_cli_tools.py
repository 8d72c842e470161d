"""The port's new sub-commands and scripts: ``split``, ``sweep``,
``inspect_ckpt``, ``export`` and ``bench``.

* each tool's parser takes the JAX tool's flags: the same options, dests,
  defaults, types, choices, nargs and required flags;
* ``cli.main`` dispatches each sub-command with ``device``;
* each runs as ``python -m ..._torch.cli <sub-command>`` (``--help``; the
  port has no ``[project.scripts]`` lines: ``tests/test_cli.py`` holds
  every line there to the JAX cli);
* every module of the port imports with ``jax``, ``flax``, ``optax`` and the
  JAX package blocked;
* ``check_supported`` takes the flags this slice lifted, and the rest,
  since ported.
"""

import argparse
import os
import subprocess
import sys

import pytest

from selectivenet_for_semantic_segmentation_binary_tpu.tools import (
    data_split as jax_split, export as jax_export, inspect_ckpt as jax_inspect,
    sweep as jax_sweep)
from selectivenet_for_semantic_segmentation_binary_torch import cli
from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
from selectivenet_for_semantic_segmentation_binary_torch.tools import (
    data_split, export, inspect_ckpt, sweep)
from selectivenet_for_semantic_segmentation_binary_torch.train_lib import check_supported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Parsed(Exception):
    pass


def _parser_of(main, argv, monkeypatch, **kw):
    """The ArgumentParser that ``main`` builds, caught at parse_args."""
    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as info:
        main(argv, **kw)
    monkeypatch.undo()
    return info.value.args[0]


def _flags(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        t = getattr(a.type, "__name__", a.type)
        out[a.dest] = (tuple(a.option_strings), a.default, t, a.nargs, a.required,
                       tuple(a.choices) if a.choices else None, type(a).__name__)
    return out


TOOLS = {
    "split": (data_split.main, jax_split.main, {}),
    "sweep": (sweep.main, jax_sweep.main, {"device": "cpu"}),
    "inspect_ckpt": (inspect_ckpt.main, jax_inspect.main, {}),
    "export": (export.main, jax_export.main, {"device": "cpu"}),
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_parser_takes_the_jax_flags(tool, monkeypatch):
    port_main, jax_main, kw = TOOLS[tool]
    got = _flags(_parser_of(port_main, [], monkeypatch, **kw))
    want = _flags(_parser_of(jax_main, [], monkeypatch))
    assert got == want
    assert got


@pytest.mark.parametrize("sub", ["split", "sweep", "inspect_ckpt", "export", "bench"])
def test_cli_dispatches_with_the_device(sub, monkeypatch):
    import importlib

    module = {"split": "tools.data_split", "sweep": "tools.sweep",
              "inspect_ckpt": "tools.inspect_ckpt", "export": "tools.export",
              "bench": "bench"}[sub]
    mod = importlib.import_module(f"selectivenet_for_semantic_segmentation_binary_torch.{module}")
    seen = []
    monkeypatch.setattr(mod, "main", lambda argv=None, **kw: seen.append((argv, kw)) or "ret")
    result = cli.main([sub, "--x", "1"], device="cpu")
    hosts = sub in ("split", "inspect_ckpt")  # host tools: no device
    assert seen == [(["--x", "1"], {} if hosts else {"device": "cpu"})]
    assert result == (None if hosts else "ret")


@pytest.mark.parametrize("sub", ["split", "sweep", "inspect_ckpt", "export"])
def test_the_sub_command_runs_as_a_module(sub):
    run = subprocess.run([sys.executable, "-m",
                          "selectivenet_for_semantic_segmentation_binary_torch.cli", sub,
                          "--help"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("usage: ")


_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "selectivenet_for_semantic_segmentation_binary_tpu"):
    sys.modules[name] = None
import selectivenet_for_semantic_segmentation_binary_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.startswith(("jax", "flax", "optax",
          "selectivenet_for_semantic_segmentation_binary_tpu")) and sys.modules[m] is not None]
assert not loaded, loaded
print(len(names))
"""


def test_every_module_imports_without_jax():
    run = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert int(run.stdout.strip()) >= 60


@pytest.mark.parametrize("flags", [
    {"bn_stats": "bfloat16"}, {"remat": True}, {"profile_dir": "prof"},
    {"train_quant": "int8"},
], ids=lambda f: next(iter(f)))
def test_lifted_flags_pass_check_supported(flags):
    check_supported(TrainConfig(**flags))


@pytest.mark.parametrize("flags", [
    {"local_rank": [0, 1]}, {"sp_ways": 2}, {"bn_mode": "per_replica"},
], ids=["local_rank-A8", "sp_ways-A9", "bn_mode-A9"])
def test_the_rest_stay_refused(flags):
    """Refused once: several devices (ROADMAP A8), ``--bn_mode per_replica``
    and ``--sp_ways`` (A9) are ported now and pass; only an inert
    ``--output_dim`` is refused."""
    check_supported(TrainConfig(**flags))
    with pytest.raises(ValueError, match="--output_dim 'NCHW' is not supported"):
        check_supported(TrainConfig(output_dim="NCHW", **flags))
