"""The port's evaluation slice against the JAX package's, end to end.

Both sides score the same synthetic fold (``write_synthetic_patch_tree`` at
32x32) with the same checkpoint file, in float32 on the CPU; both decode the
JPEGs with PIL (the JAX side through ``PatchDataset(decoder="pil")``). The
confusion counts may differ only by pixels whose JAX probability lies within
1e-5 of a cut-off: those pixels are counted and the count is the allowance.
"""

import dataclasses
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.config import EvalConfig
from selectivenet_for_semantic_segmentation_binary_tpu.data import (
    PatchDataset as JaxPatchDataset,
    PatchLoader as JaxPatchLoader,
    construct_test as jax_construct_test,
    write_synthetic_patch_tree,
)
from selectivenet_for_semantic_segmentation_binary_tpu.eval_lib import evaluate as jax_evaluate
from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    save_checkpoint,
    torch_state_dict_to_variables,
)
import selectivenet_for_semantic_segmentation_binary_torch as port
from selectivenet_for_semantic_segmentation_binary_torch import cli as port_cli
from selectivenet_for_semantic_segmentation_binary_torch.config import EvalConfig as PortEvalConfig
from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import evaluate
from selectivenet_for_semantic_segmentation_binary_torch.models import build_model

SIZE, BATCH = 32, 4
NEAR = 1e-5  # probability distance to a cut-off that counts toward the allowance


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_eval_data"))
    write_synthetic_patch_tree(d, n_slides=2, patches_per_slide=15, patch_size=SIZE, seed=1)
    return d


def _he_variables(selective: bool, seed: int, in_ch: int = 3):
    """UNet_B variables in the JAX layout with He-normal kernels from a
    seeded generator, so the logits spread well beyond the cut-offs'
    neighbourhood. Made on the port's side and carried over with the JAX
    package's own importer (no flax init: it costs seconds per process)."""
    model = build_model("UNet_B", selective=selective, in_ch=in_ch)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            elif isinstance(m, torch.nn.ConvTranspose2d):
                fan_in = m.in_channels
            else:
                continue
            m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=g)
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    jax_model = jax_build_model("UNet_B", selective=selective, compute_dtype="float32")
    return jax_model, torch_state_dict_to_variables(sd)


def _model_dir(tmp_path_factory, name, members):
    d = str(tmp_path_factory.mktemp(name))
    for epoch, v in enumerate(members, start=1):
        save_checkpoint(d, {"net": v}, epoch)
    return d


def _cfg(data_dir, model_dir, **kw):
    base = dict(data_dir=data_dir, test_fold=1, patch_size=SIZE, batch_size=BATCH,
                model_dir=model_dir, model_arch=["UNet_B"], compute_dtype="float32",
                local_rank=[0], num_workers=2)
    base.update(kw)
    return EvalConfig(**base)


def _port(cfg) -> PortEvalConfig:
    """The same settings in the port's own config class."""
    return PortEvalConfig(**dataclasses.asdict(cfg))


def _jax_run(cfg):
    """JAX evaluate over a PIL-decoding raw-uint8 loader."""
    ds = JaxPatchDataset(cfg.data_dir, jax_construct_test(cfg.data_dir, cfg.test_fold),
                         cfg.patch_mag, cfg.patch_size, cfg.input_type, decoder="pil")
    loader = JaxPatchLoader(ds, cfg.batch_size, shuffle=False, num_workers=2,
                            drop_last=False, device_preproc=True)
    return jax_evaluate(cfg, loader=loader, verbose=False), ds


def _jax_probs(model, members, ds):
    """Per-pixel JAX probabilities of the valid pixels: (output, selection)."""
    inputs, labels = zip(*(ds.get_raw(i) for i in range(len(ds))))
    x = (np.stack(inputs).astype(np.float32) * (1.0 / 255.0) - 0.5) / 0.5
    valid = np.stack(labels) < 2
    apply = jax.jit(lambda v, xb: model.apply(v, xb, train=False))
    outs = [apply(v, jnp.asarray(x)) for v in members]
    if isinstance(outs[0], tuple):
        out, sel = np.asarray(outs[0][0]), np.asarray(outs[0][1])
        return (1 / (1 + np.exp(-out)))[valid], (1 / (1 + np.exp(-sel)))[valid]
    mean = np.mean([np.asarray(o) for o in outs], axis=0)
    return (1 / (1 + np.exp(-mean)))[valid], None


def _allowance(p, g, cut=0.5, s_cut=0.5) -> int:
    near = np.abs(p - cut) < NEAR
    if g is not None:
        near |= np.abs(g - s_cut) < NEAR
    return int(near.sum())


@pytest.fixture(scope="module")
def selective_case(data_dir, tmp_path_factory):
    model, v = _he_variables(True, seed=5)
    model_dir = _model_dir(tmp_path_factory, "sel_model", [v])
    cfg = _cfg(data_dir, model_dir, selective=True, select_eval=True)
    want, ds = _jax_run(cfg)
    allowance = _allowance(*_jax_probs(model, [v], ds))
    assert allowance <= 2, allowance  # the comparison stays tight
    return cfg, want, allowance


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused_op", "bincount"])
def test_selective_in_coverage_matches_jax(selective_case, use_pallas):
    cfg, want, allowance = selective_case
    got = evaluate(_port(dataclasses.replace(cfg, use_pallas=use_pallas)),
                   verbose=False, device="cpu")
    diff = np.abs(got["confusion_matrix"] - want["confusion_matrix"]).sum()
    assert diff <= 2 * allowance, (got["confusion_matrix"], want["confusion_matrix"], allowance)
    n_pix = want["confusion_matrix"].sum() / (1.0 - want["rejection_ratio"])
    assert abs(got["rejection_ratio"] - want["rejection_ratio"]) * n_pix <= allowance + 1e-6
    assert abs(got["mIoU"] - want["mIoU"]) <= 1e-6
    assert 0.0 < got["rejection_ratio"] < 1.0  # the selection head really selects
    assert got["n_models"] == 1


def test_ensemble_mean_matches_jax(data_dir, tmp_path_factory):
    members = [_he_variables(False, seed=s) for s in (11, 12)]
    model = members[0][0]
    variables = [v for _, v in members]
    model_dir = _model_dir(tmp_path_factory, "ens_model", variables)
    cfg = _cfg(data_dir, model_dir, selective=False, select_eval=False)
    want, ds = _jax_run(cfg)
    allowance = _allowance(*_jax_probs(model, variables, ds))
    got = evaluate(_port(cfg), verbose=False, device="cpu")
    assert got["n_models"] == want["n_models"] == 2
    diff = np.abs(got["confusion_matrix"] - want["confusion_matrix"]).sum()
    assert diff <= 2 * allowance, (got["confusion_matrix"], want["confusion_matrix"], allowance)
    assert abs(got["mIoU"] - want["mIoU"]) <= 1e-6


def test_cli_writes_the_metric_csv(selective_case, tmp_path, capsys):
    cfg, want, _ = selective_case
    out = str(tmp_path / "out")
    port_cli.eval_main([
        "--fold", "1", "--data_dir", cfg.data_dir, "--model_dir", cfg.model_dir,
        "--model_arch", "UNet_B", "--selective", "1", "--select_eval", "1",
        "--batch_size", str(BATCH), "--patch_size", str(SIZE), "--num_workers", "2",
        "--compute_dtype", "float32", "--save_dir", out], device="cpu")
    assert "rejection ratio" in capsys.readouterr().out
    with open(os.path.join(out, "eval_fold1.csv")) as f:
        header, row = f.read().strip().splitlines()
    assert header.startswith("accuracy,accuracy_class,precision")
    assert row.endswith(",1")


@pytest.mark.parametrize("flags", [
    {"local_rank": [0, 1]}, {"sp_ways": 2},
], ids=lambda f: next(iter(f)))
def test_uncovered_flags_raise(flags, selective_case):
    """Refused until several devices (ROADMAP A8) and ``--sp_ways`` (A9)
    were ported. Outside a fleet ``--sp_ways 2`` is refused with JAX's
    message for one device (tests/test_torch_spatial_train.py runs it on
    four ranks); ``--local_rank 0 1`` is one rank: the scores of
    ``--local_rank 0``."""
    cfg = _port(selective_case[0])
    if "sp_ways" in flags:
        with pytest.raises(ValueError, match=r"^sp_ways 2 must divide the device count 1$"):
            evaluate(dataclasses.replace(cfg, **flags), verbose=False, device="cpu")
        return
    got = evaluate(dataclasses.replace(cfg, **flags), verbose=False, device="cpu")
    want = evaluate(cfg, verbose=False, device="cpu")
    np.testing.assert_array_equal(got["confusion_matrix"], want["confusion_matrix"])
    assert got["rejection_ratio"] == want["rejection_ratio"]


def test_quantize_int8_calibrates_on_the_first_test_patches(selective_case, monkeypatch, capsys):
    """``--quantize int8``, refused until the int8 path was ported: the
    member is quantized by ``ops.quant.quantize_serving`` on the test fold's
    first ``--calib_patches`` patches, decoded [0, 1] (JAX
    ``_quantize_models``), and the in-coverage scores are finite.
    tests/test_torch_quant.py holds the scores to JAX's."""
    from selectivenet_for_semantic_segmentation_binary_torch.data.dataset import PatchDataset
    from selectivenet_for_semantic_segmentation_binary_torch.data.folds import construct_test
    from selectivenet_for_semantic_segmentation_binary_torch.ops import quant

    cfg, want, _ = selective_case
    seen = []
    real = quant.quantize_serving
    monkeypatch.setattr(quant, "quantize_serving",
                        lambda *a, **k: seen.append(a[5]) or real(*a, **k))
    got = evaluate(dataclasses.replace(_port(cfg), quantize="int8", calib_patches=3),
                   verbose=True, device="cpu")
    assert "int8 serving trunk: 1 model(s) calibrated on 3 patches" in capsys.readouterr().out
    ds = PatchDataset(cfg.data_dir, construct_test(cfg.data_dir, cfg.test_fold), cfg.patch_mag,
                      cfg.patch_size, cfg.input_type)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], np.stack([ds[i]["input"] for i in range(3)]))
    assert 0.0 < got["rejection_ratio"] < 1.0 and np.isfinite(got["accuracy"])


@pytest.mark.parametrize("flags", [
    {"input_type": "GH"}, {"blankfield": True}, {"device_preproc": False},
], ids=lambda f: next(iter(f)))
def test_host_feed_flags_match_jax(flags, data_dir, tmp_path_factory, monkeypatch):
    """The host float feed's flags, refused until the feed was ported: the
    port's evaluate() against JAX evaluate() (its own loader, the same
    flags), in-coverage, with the allowance counted from the JAX
    probabilities of the JAX feed's batches. Both decode with PIL, the
    port's default."""
    from selectivenet_for_semantic_segmentation_binary_tpu.data import native_decoder
    from selectivenet_for_semantic_segmentation_binary_tpu.eval_lib import make_eval_loader
    from selectivenet_for_semantic_segmentation_binary_tpu.parallel.mesh import make_mesh

    monkeypatch.setattr(native_decoder, "available", lambda: False)

    in_ch = 2 if flags.get("input_type") == "GH" else 3
    model, v = _he_variables(True, seed=7, in_ch=in_ch)
    model_dir = _model_dir(tmp_path_factory, f"host_{next(iter(flags))}", [v])
    cfg = _cfg(data_dir, model_dir, selective=True, select_eval=True, **flags)
    want = jax_evaluate(cfg, verbose=False)
    got = evaluate(_port(cfg), verbose=False, device="cpu")
    probs = {"p": [], "g": []}
    for batch in make_eval_loader(cfg, make_mesh(1)):
        x = np.asarray(batch["input"])
        assert x.dtype == np.float32 and x.shape[-1] == in_ch
        out, sel, _ = model.apply(v, jnp.asarray(x), train=False)
        valid = np.asarray(batch["label"]) < 2
        probs["p"].append((1 / (1 + np.exp(-np.asarray(out))))[valid])
        probs["g"].append((1 / (1 + np.exp(-np.asarray(sel))))[valid])
    allowance = _allowance(np.concatenate(probs["p"]), np.concatenate(probs["g"]))
    diff = np.abs(got["confusion_matrix"] - want["confusion_matrix"]).sum()
    assert diff <= 2 * allowance, (got["confusion_matrix"], want["confusion_matrix"], allowance)
    n_pix = want["confusion_matrix"].sum() / (1.0 - want["rejection_ratio"])
    assert abs(got["rejection_ratio"] - want["rejection_ratio"]) * n_pix <= allowance + 1e-6
    assert 0.0 < got["rejection_ratio"] < 1.0


@pytest.mark.parametrize("entry", ["evaluate", "cli"])
def test_no_device_and_no_card_raises(selective_case, monkeypatch, entry):
    """Without a device evaluate() takes the card; with none it raises
    instead of scoring on the CPU."""
    cfg, _, _ = selective_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "evaluate":
            evaluate(_port(cfg), verbose=False)
        else:
            port_cli.main(["eval", "--fold", "1", "--data_dir", cfg.data_dir,
                           "--model_dir", cfg.model_dir, "--model_arch", "UNet_B"])


def test_selective_ensemble_is_rejected(selective_case, tmp_path):
    from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import (
        load_models, make_eval_step)

    cfg, _, _ = selective_case
    models = load_models(_port(cfg), "cpu")
    with pytest.raises(ValueError, match="unsupported"):
        make_eval_step(models * 2, _port(cfg), use_kernel=False)


def test_port_imports_no_jax():
    """Every module of the port imports without jax, flax, optax or the JAX
    package."""
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    assert "selectivenet_for_semantic_segmentation_binary_torch.eval_lib" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in ('jax', 'flax', 'optax',\n"
        "                   'selectivenet_for_semantic_segmentation_binary_tpu')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert res.returncode == 0, res.stderr
