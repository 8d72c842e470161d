"""The port's host float feed (``--input_type GH|H_RGB``, ``--blankfield``,
``--pnt_aug``, ``--device_preproc 0``) against the JAX package's, on the CPU.

(a) The loaders the entry points build (``train_lib.make_loaders``,
    ``eval_lib.make_eval_loader``) against the JAX ones (same flags, a
    1-device mesh), epoch 1, every batch including a padded last one: the
    same mode (raw or float); in float mode inputs bit-equal
    (``np.array_equal``, float32, GH with 2 channels), labels and ``nvalid``
    equal, no flip bits. Both sides decode with PIL, the port's default
    (the JAX package's native decoder, its default where it builds, is
    switched off for the module).
(b) A 2-step lockstep of the GH selective UNet_B train step (2-channel
    first conv, float32, Adam) against the JAX step on the port's GH float
    batches, at ``tests/test_torch_train.py``'s tolerance (LOCK_TOL).
(c) ``evaluate`` of GH and blank-field inputs against the JAX
    ``evaluate``: the confusion counts and rejected pixels may differ only by
    pixels whose JAX probability lies within 1e-5 of a cut-off (counted).
(d) The fused trunk on a GH input: the first layer (Cin 2) takes the plain
    dataflow and the 13 others the kernel's wrapper (a bf16 forward on the
    CPU, where the wrapper runs its plain version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu import eval_lib as jax_eval_lib
from selectivenet_for_semantic_segmentation_binary_tpu import train_lib as jax_train_lib
from selectivenet_for_semantic_segmentation_binary_tpu.config import (
    EvalConfig as JaxEvalConfig, TrainConfig as JaxTrainConfig)
from selectivenet_for_semantic_segmentation_binary_tpu.data import native_decoder as jax_nd
from selectivenet_for_semantic_segmentation_binary_tpu.models import build_model as jax_build_model
from selectivenet_for_semantic_segmentation_binary_tpu.optim import build_optimizer as jax_optimizer
from selectivenet_for_semantic_segmentation_binary_tpu.parallel.mesh import make_mesh
from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    load_net_checkpoint as jax_load, torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch import eval_lib, train_lib
from selectivenet_for_semantic_segmentation_binary_torch.config import EvalConfig, TrainConfig
from selectivenet_for_semantic_segmentation_binary_torch.models import unet
from selectivenet_for_semantic_segmentation_binary_torch.models import build_model
from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
    seeded_model, write_synthetic_patch_tree)

SIZE = 32
NEAR = 1e-5
LOCK_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_torch_train.py's


@pytest.fixture(scope="module", autouse=True)
def jax_decodes_with_pil():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_nd, "available", lambda: False)
        yield


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_host_feed_data"))
    write_synthetic_patch_tree(d, n_slides=3, patches_per_slide=9, patch_size=SIZE, seed=12)
    return d


def _batches(loader, epoch=1):
    loader.set_epoch(epoch)
    return [{k: (v.numpy() if torch.is_tensor(v) else np.asarray(v) if k != "id" else v)
             for k, v in b.items()} for b in loader]


def _hold_loaders(port, jax_loader):
    assert port.device_preproc == jax_loader.device_preproc
    got, want = _batches(port), _batches(jax_loader)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g["nvalid"] == w["nvalid"]
        assert g["input"].dtype == w["input"].dtype and g["input"].shape == w["input"].shape
        assert np.array_equal(g["input"], w["input"])
        assert np.array_equal(g["label"], w["label"])
        assert ("flips" in g) == ("flips" in w)
        if "flips" in w:
            assert np.array_equal(g["flips"], w["flips"])
    return got


TRAIN_CASES = {
    "RGB_raw": {},
    "RGB_device_preproc_0": {"device_preproc": False},
    "GH": {"input_type": "GH"},
    "H_RGB": {"input_type": "H_RGB"},
    "RGB_blankfield": {"blankfield": True},
    "GH_blankfield": {"input_type": "GH", "blankfield": True},
    "RGB_pnt": {"pnt_aug": True},
    "GH_blankfield_pnt": {"input_type": "GH", "blankfield": True, "pnt_aug": True},
    "H_RGB_blankfield_pnt": {"input_type": "H_RGB", "blankfield": True, "pnt_aug": True},
}


def _train_kw(data_dir, **kw):
    base = dict(data_dir=data_dir, fold=1, patch_size=SIZE, batch_size=4, num_workers=2,
                drop_last=False, seed=5)
    base.update(kw)
    return base


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_loaders_equal_jax(data_dir, case):
    kw = _train_kw(data_dir, **TRAIN_CASES[case])
    port = train_lib.make_loaders(TrainConfig(**kw), "cpu")
    want = jax_train_lib.make_loaders(JaxTrainConfig(**kw), make_mesh(1))
    assert port[0].dataset.use_native == want[0].dataset._use_native
    train_batches = _hold_loaders(port[0], want[0])
    _hold_loaders(port[1], want[1])
    assert train_batches[-1]["nvalid"] < 4  # a padded last batch was held
    if not train_lib.raw_feed(TrainConfig(**kw)):
        c = 2 if kw.get("input_type") == "GH" else 3
        assert train_batches[0]["input"].shape == (4, SIZE, SIZE, c)
        assert train_batches[0]["input"].dtype == np.float32


@pytest.mark.parametrize("case", ["GH", "H_RGB_blankfield", "RGB_device_preproc_0"])
def test_eval_loader_equals_jax(data_dir, case):
    flags = {"GH": {"input_type": "GH"},
             "H_RGB_blankfield": {"input_type": "H_RGB", "blankfield": True},
             "RGB_device_preproc_0": {"device_preproc": False}}[case]
    kw = dict(data_dir=data_dir, test_fold=2, patch_size=SIZE, batch_size=4, num_workers=2,
              **flags)
    _hold_loaders(eval_lib.make_eval_loader(EvalConfig(**kw), "cpu"),
                  jax_eval_lib.make_eval_loader(JaxEvalConfig(**kw), make_mesh(1)))


def test_float_feed_flips_differ_from_the_raw_bits_under_pnt(data_dir):
    """With --pnt_aug PNT draws before RandomFlip, so the float feed's flips
    are not the raw feed's bits for the same (seed, epoch, index): a sample's
    float input equals the raw input flipped by other bits somewhere."""
    kw = _train_kw(data_dir)
    raw = _batches(train_lib.make_loaders(TrainConfig(**kw), "cpu")[0])
    flt = _batches(train_lib.make_loaders(TrainConfig(**kw, device_preproc=False), "cpu")[0])
    pnt = _batches(train_lib.make_loaders(TrainConfig(**kw, pnt_aug=True), "cpu")[0])
    # without PNT the host's flips are the raw feed's bits
    for r, f in zip(raw, flt):
        for i in range(r["nvalid"]):
            x = r["input"][i]
            lr, ud = r["flips"][i].astype(bool)
            x = x[:, ::-1] if lr else x
            x = x[::-1] if ud else x
            # the host's /255 (PIL) or * (1/255) (native) against the device's
            # * (1/255): an ulp of float32 apart at most, scaled by 2
            np.testing.assert_allclose(f["input"][i], (x.astype(np.float32) / 255.0 - 0.5) / 0.5,
                                       rtol=0, atol=1e-6)
    differ = sum(not np.array_equal(f["label"][i], p["label"][i])
                 for f, p in zip(flt, pnt) for i in range(f["nvalid"]))
    assert differ > 0


# ---------------------------------------------------------------------------
# (b) the GH lockstep
# ---------------------------------------------------------------------------

def _cfg_kw(**kw):
    base = dict(model_arch="UNet_B", selective=True, loss="BCElogit", s_lamb=2.0,
                compute_dtype="float32", batch_size=2, patch_size=SIZE, lr=1e-3,
                input_type="GH", drop_last=True)
    base.update(kw)
    return base


def test_gh_lockstep_against_jax(data_dir):
    model = seeded_model(61, "float32", selective=True, in_ch=2)
    assert model.encoder_layer_1_1[0].weight.shape[1] == 2
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = torch_state_dict_to_variables(sd)
    assert variables["params"]["trunk"]["enc1_1"]["conv"]["kernel"].shape == (3, 3, 2, 64)
    cfg = TrainConfig(**_cfg_kw(data_dir=data_dir, fold=1, num_workers=2, pnt_aug=True))
    loader = train_lib.make_loaders(cfg, "cpu")[0]
    batches = _batches(loader)[:2]
    assert batches[0]["input"].shape == (2, SIZE, SIZE, 2) and "flips" not in batches[0]

    jcfg = JaxTrainConfig(**_cfg_kw())
    tx = jax_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jax_train_lib.TrainState(
        params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params))
    jstep = jax_train_lib.make_train_step(
        jax_build_model("UNet_B", selective=True, compute_dtype="float32"), jcfg, tx)
    pstep = train_lib.make_train_step(model, TrainConfig(**_cfg_kw()),
                                      build_optimizer(TrainConfig(**_cfg_kw()),
                                                      model.parameters()))
    keys = ("loss", "aux_loss", "sel_loss", "coverage")
    got, want = [], []
    for b in batches:
        state, jm = jstep(state, {"input": jnp.asarray(b["input"]),
                                  "label": jnp.asarray(b["label"].astype(np.int32))},
                          1e-3, jax.random.PRNGKey(0))
        pm = pstep({"input": torch.from_numpy(b["input"]),
                    "label": torch.from_numpy(b["label"])}, 1e-3)
        want.append([float(jm[k]) for k in keys])
        got.append([float(pm[k]) for k in keys])
        assert int(pm["n_pix"]) == int(jm["n_pix"]) == 2 * SIZE * SIZE
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)  # same parameters
    np.testing.assert_allclose(got, want, **LOCK_TOL)
    assert np.all(np.isfinite(got))


# ---------------------------------------------------------------------------
# (c) evaluate on the float feed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    out = {}
    for in_ch in (2, 3):
        d = tmp_path_factory.mktemp(f"torch_host_feed_models_{in_ch}")
        torch.save({"net": seeded_model(70 + in_ch, "float32", selective=True,
                                        in_ch=in_ch).state_dict()},
                   str(d / "model_epoch4.pth"))
        out[in_ch] = str(d)
    return out


@pytest.mark.parametrize("flags", [{"input_type": "GH"},
                                   {"input_type": "GH", "blankfield": True},
                                   {"blankfield": True}],
                         ids=["GH", "GH_blankfield", "RGB_blankfield"])
def test_evaluate_counts_equal_jax(data_dir, model_dirs, flags):
    in_ch = 2 if flags.get("input_type") == "GH" else 3
    kw = dict(data_dir=data_dir, test_fold=1, patch_size=SIZE, batch_size=4, num_workers=2,
              model_dir=model_dirs[in_ch], model_arch=["UNet_B"], selective=True,
              select_eval=True, compute_dtype="float32", **flags)
    want = jax_eval_lib.evaluate(JaxEvalConfig(**kw), verbose=False)
    got = eval_lib.evaluate(EvalConfig(**kw), verbose=False, device="cpu")

    # the allowance: valid pixels whose JAX probabilities lie within NEAR of 0.5
    loader = jax_eval_lib.make_eval_loader(JaxEvalConfig(**kw), make_mesh(1))
    variables = jax_load(model_dirs[in_ch] + "/model_epoch4.pth")
    jmodel = jax_build_model("UNet_B", 2, True, "float32")
    near = 0
    for b in loader:
        out, sel, _ = jmodel.apply(variables, jnp.asarray(b["input"]), train=False)
        valid = np.asarray(b["label"]) < 2
        for logit in (out, sel):
            p = 1 / (1 + np.exp(-np.asarray(logit, np.float64)))
            near += int((np.abs(p - 0.5)[valid] < NEAR).sum())
    cm_diff = int(np.abs(got["confusion_matrix"] - want["confusion_matrix"]).sum())
    assert cm_diff <= 2 * near
    n_pix = int(want["confusion_matrix"].sum()) / (1 - want["rejection_ratio"])
    assert abs(got["rejection_ratio"] - want["rejection_ratio"]) * n_pix <= near + 1e-6
    if near == 0:
        np.testing.assert_array_equal(got["confusion_matrix"], want["confusion_matrix"])
    assert got["n_models"] == 1 and 0 < got["rejection_ratio"] < 1


# ---------------------------------------------------------------------------
# (d) the fused trunk's first layer at Cin 2
# ---------------------------------------------------------------------------

def test_fused_trunk_runs_the_plain_first_layer_and_the_kernel_after_it(monkeypatch):
    calls = {"kernel": [], "plain": []}

    def count(kind, fn):
        def wrapped(x, a, b, w, bias, apply_prologue=True):
            calls[kind].append(x.shape[-1])
            return fn(x, a, b, w, bias, apply_prologue)
        return wrapped

    monkeypatch.setattr(unet, "fused_conv_stats", count("kernel", unet.fused_conv_stats))
    monkeypatch.setattr(unet, "fused_conv_stats_reference",
                        count("plain", unet.fused_conv_stats_reference))
    model = build_model("UNet_B", selective=True, compute_dtype="bfloat16", fused=True, in_ch=2)
    model.train()
    x = torch.randn(1, 2, 16, 16).contiguous(memory_format=torch.channels_last)
    out = model(x)
    assert calls["plain"] == [2] and len(calls["kernel"]) == 13
    assert all(c % 64 == 0 for c in calls["kernel"])
    assert all(torch.isfinite(o).all() for o in out)


def test_the_loader_refuses_mixed_modes(data_dir):
    """Flip bits belong to the raw feed (the float feed flips on the host),
    and the raw feed needs ``get_raw``, as the JAX loader requires."""
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader

    ds = train_lib.make_loaders(TrainConfig(**_train_kw(data_dir, input_type="GH")), "cpu")[0]
    with pytest.raises(ValueError, match="random_flip"):
        PatchLoader(ds.dataset, 4, random_flip=True, device_preproc=False)
    with pytest.raises(ValueError, match="get_raw"):
        PatchLoader(object(), 4)
